"""Elastic agent: supervise workers, restart on failure, re-shard on resize.

Port of ``deepspeed_tpu/elasticity/elastic_agent.py`` (the reference's
``DSElasticAgent``, elasticity/elastic_agent.py:32, built on
torch-elastic): monitors the local worker processes (ref _invoke_run
:127), restarts the group up to ``max_restarts`` times, and on a
world-size change relaunches with a new ``DSTPU_NUM_PROCS`` so workers
re-shard from the universal checkpoint.  Each worker is one rank: it
joins its process group itself (``resilience/worker.py`` over a
``FileStore``), and parameter state travels through the atomic universal
checkpoint, not a broadcast.

The group start/stop primitives are module functions so the recovery
supervisor (``resilience/supervisor.py``) drives the SAME process
machinery the agent uses: detection policy differs, lifecycle does not.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import logger

# how long a worker gets to honor SIGTERM before SIGKILL — see stop_group
DEFAULT_STOP_TIMEOUT_S = 30.0


class WorkerSpec:
    def __init__(self, cmd: List[str], env: Optional[Dict[str, str]] = None,
                 local_world_size: int = 1):
        self.cmd = list(cmd)
        self.env = dict(env or {})
        self.local_world_size = int(local_world_size)


def start_group(spec: WorkerSpec, world_size: int,
                extra_env: Optional[Dict[str, str]] = None
                ) -> List[subprocess.Popen]:
    """Launch one worker per rank with the canonical world-layout env."""
    procs = []
    for rank in range(world_size):
        env = {**os.environ, **spec.env, **(extra_env or {}),
               "DSTPU_NUM_PROCS": str(world_size),
               "DSTPU_PROC_ID": str(rank),
               "LOCAL_RANK": str(rank),
               "RANK": str(rank),
               "WORLD_SIZE": str(world_size)}
        procs.append(subprocess.Popen(spec.cmd, env=env))
    return procs


def stop_group(procs: List[subprocess.Popen],
               stop_timeout_s: float = DEFAULT_STOP_TIMEOUT_S) -> None:
    """Stop every worker: SIGTERM to all, ONE shared deadline, then
    SIGKILL the stragglers.

    The deadline is shared (not per-process serial waits) and escalation
    is unconditional: a wedged worker — stuck in a collective, swallowing
    SIGTERM in a signal handler, or blocked in native code — must not be
    able to block the group restart forever; it gets killed when the
    budget runs out, period.  A recovery path that can itself hang is
    not a recovery path."""
    live = [p for p in procs if p.poll() is None]
    for p in live:
        try:
            p.terminate()
        except OSError:  # already gone
            pass
    deadline = time.monotonic() + max(0.0, float(stop_timeout_s))
    pending = list(live)
    while pending and time.monotonic() < deadline:
        pending = [p for p in pending if p.poll() is None]
        if pending:
            time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))
    if pending:
        logger.warning(f"stop_group: {len(pending)} worker(s) ignored "
                       f"SIGTERM for {stop_timeout_s}s; escalating to "
                       "SIGKILL")
        for p in pending:
            try:
                p.kill()
            except OSError:
                pass
        for p in pending:
            try:
                p.wait(timeout=10.0)
            except subprocess.TimeoutExpired:  # pragma: no cover - kernel-stuck
                logger.error(f"stop_group: pid {p.pid} survived SIGKILL "
                             "(unkillable D-state); abandoning")


class DSElasticAgent:
    """Run a worker group, restarting on failure (ref elastic_agent.py:32)."""

    def __init__(self, spec: WorkerSpec, max_restarts: int = 3,
                 monitor_interval: float = 1.0,
                 world_size_fn: Optional[Callable[[], int]] = None,
                 stop_timeout_s: float = DEFAULT_STOP_TIMEOUT_S):
        self.spec = spec
        self.max_restarts = int(max_restarts)
        self.monitor_interval = float(monitor_interval)
        self.stop_timeout_s = float(stop_timeout_s)
        self._world_size_fn = world_size_fn or (lambda: spec.local_world_size)
        self.restarts = 0

    def _start_group(self, world_size: int) -> List[subprocess.Popen]:
        return start_group(self.spec, world_size)

    def _stop_group(self, procs: List[subprocess.Popen]) -> None:
        stop_group(procs, stop_timeout_s=self.stop_timeout_s)

    def run(self) -> int:
        """Monitor loop (ref _invoke_run :127): HEALTHY → poll; a failed
        worker triggers a group restart; world-size change re-launches."""
        world = self._world_size_fn()
        procs = self._start_group(world)
        while True:
            time.sleep(self.monitor_interval)
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                return 0
            if any(c not in (None, 0) for c in codes):
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    logger.error("elastic agent: max_restarts exceeded")
                    self._stop_group(procs)
                    return 1
                logger.warning(f"elastic agent: worker failed (codes={codes}); "
                               f"restart {self.restarts}/{self.max_restarts}")
                self._stop_group(procs)
                world = self._world_size_fn()
                procs = self._start_group(world)
                continue
            new_world = self._world_size_fn()
            if new_world != world:
                logger.warning(f"elastic agent: world size {world} → {new_world}; "
                               "restarting group to re-shard")
                self._stop_group(procs)
                world = new_world
                procs = self._start_group(world)
