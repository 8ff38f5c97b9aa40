"""RecoverySupervisor: watchdog → elastic agent → universal resume.

Port of ``deepspeed_tpu/resilience/supervisor.py``.  The flight recorder
DETECTS (hang watchdog, crash bundles) and the elastic agent can RESTART
a process group; this module is the loop that connects them, so a mid-run
worker death or wedge ends in a converged loss curve instead of a dead
job:

    running ──(worker exit!=0 | heartbeat stall)──▶ detected
      ▲                                               │ flight bundle
      │                                               ▼ (reason "recovery")
    resumed ◀── first post-restart progress ◀── restarted ◀── replanned
      │                                               ▲          │
      └── recovery.outage span ends                   └──────────┘
                                        stop_group (SIGTERM→SIGKILL) +
                                        plan_mesh over surviving hosts

Recovery is possible at all because of two invariants built elsewhere:
the universal checkpoint is CRASH-ATOMIC (``checkpoint/universal.py``
staging + completion marker: a worker killed mid-save leaves the previous
good tag resumable) and partition specs are a pure function of
name+shape+mesh (:class:`~deepspeed_tpu_torch.resilience.oracle.
PartitionOracle`), so the restarted group can be a DIFFERENT SIZE: a gone
host shrinks the planned mesh and the oracle reslices the resume.

In the port each worker process is one rank (``resilience/worker.py``),
so a host contributes ``devices_per_host`` workers to the group.
Telemetry is optional, as in the JAX package: with a ``telemetry`` object
(its ``tracer``, ``flight_ring`` and ``record_recovery``) the outage is one
``recovery.outage`` span with ``recovery.detected`` / ``recovery.replan``
/ ``recovery.restart`` / ``recovery.resumed`` instants and a
``record_recovery(step, outage_s)`` call (the JAX ``Telemetry`` hub's
goodput-gap record, ``telemetry/record.py``, is not ported: ROADMAP Queue
A item 13).  States are a frozen vocabulary (:data:`RECOVERY_STATES`, the
JAX tuple).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from deepspeed_tpu_torch.elasticity.elastic_agent import (WorkerSpec,
                                                          start_group,
                                                          stop_group)
from deepspeed_tpu_torch.resilience.oracle import plan_mesh
from deepspeed_tpu_torch.telemetry.flight import Watchdog, dump_bundle
from deepspeed_tpu_torch.utils.logging import log_dist, logger

# frozen recovery state machine (the JAX package's, docs/ELASTICITY.md)
RECOVERY_STATES = ("running", "detected", "dumped", "stopped", "replanned",
                   "restarted", "resumed", "failed")


class RecoveryFailed(RuntimeError):
    """The supervisor ran out of recovery budget (max_recoveries) or the
    restarted group never produced progress."""


@dataclass
class RecoveryEvent:
    state: str
    time_unix: float
    detail: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SupervisorResult:
    returncode: int
    recoveries: int
    outages: List[Dict[str, Any]]
    events: List[RecoveryEvent]
    progress_path: str
    mesh: Dict[str, int]


def read_progress(path: str) -> List[Dict[str, Any]]:
    """Parse a worker progress JSONL (tolerates a torn final line — the
    worker may have died mid-write)."""
    out: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        pass
    return out


def loss_curve(path: str) -> Dict[int, float]:
    """step → loss, LAST incarnation wins (a step recomputed after a
    resume overwrites the pre-crash line — both should agree with the
    unkilled curve, which is what the chaos tests assert)."""
    return {int(r["step"]): float(r["loss"]) for r in read_progress(path)
            if "step" in r and "loss" in r}


class RecoverySupervisor:
    """Supervise a training worker group with automatic recovery.

    ``hosts_fn`` is the survivors census: called at launch and again at
    every re-plan; returning fewer hosts than before is how a dead host
    manifests, and shrinks the planned mesh.  Each host contributes
    ``devices_per_host`` ranks (worker processes) to one planned mesh;
    each worker takes ``cuda:RANK % device_count`` unless ``worker_env``
    (or the caller's environment) sets ``DSTPU_FORCE_CPU=1``.
    """

    def __init__(self, ckpt_dir: str, *,
                 worker_cmd: Optional[Sequence[str]] = None,
                 hosts_fn: Optional[Callable[[], Sequence[str]]] = None,
                 devices_per_host: int = 1,
                 mesh_template: Optional[Dict[str, int]] = None,
                 total_steps: int = 8,
                 deadline_s: float = 60.0,
                 poll_s: float = 0.25,
                 max_recoveries: int = 3,
                 stop_timeout_s: float = 10.0,
                 resume_deadline_s: float = 300.0,
                 telemetry: Any = None,
                 flight_dir: Optional[str] = None,
                 worker_env: Optional[Dict[str, str]] = None):
        self.ckpt_dir = ckpt_dir
        self.worker_cmd = list(worker_cmd or (
            sys.executable, "-m", "deepspeed_tpu_torch.resilience.worker"))
        self._hosts_fn = hosts_fn or (lambda: ["localhost"])
        self.devices_per_host = int(devices_per_host)
        self.mesh_template = dict(mesh_template or {})
        self.total_steps = int(total_steps)
        self.deadline_s = float(deadline_s)
        self.poll_s = float(poll_s)
        self.max_recoveries = int(max_recoveries)
        self.stop_timeout_s = float(stop_timeout_s)
        self.resume_deadline_s = float(resume_deadline_s)
        self.telemetry = telemetry
        self.flight_dir = flight_dir or os.path.join(ckpt_dir, "flight")
        self.worker_env = dict(worker_env or {})

        self.progress_path = os.path.join(ckpt_dir, "progress.jsonl")
        self.recoveries = 0
        self.events: List[RecoveryEvent] = []
        self.outages: List[Dict[str, Any]] = []
        self.mesh: Dict[str, int] = {}
        self._incarnation = 0
        self._hang = threading.Event()
        self._progress_mark = 0
        self._bundles_at_launch: set = set()
        if telemetry is not None:
            self._tracer = telemetry.tracer
            self._ring = telemetry.flight_ring
        else:
            from deepspeed_tpu_torch.telemetry.tracing import NULL_TRACER

            self._tracer = NULL_TRACER
            self._ring = None
        self._trace_id = (self._tracer.new_trace_id()
                          if self._tracer.enabled else "")

    # -- bookkeeping -----------------------------------------------------
    def _event(self, state: str, **detail) -> None:
        assert state in RECOVERY_STATES, state
        self.events.append(RecoveryEvent(state, time.time(), detail))
        log_dist(f"recovery supervisor: {state} {detail}", level="info")

    def _progress_size(self) -> int:
        """Byte size of the progress JSONL — the heartbeat signal.  The
        workers only ever APPEND, so growth == new progress; polling the
        size keeps the watchdog feed O(1) instead of re-reading a file
        that grows one line per step for the whole run."""
        try:
            return os.path.getsize(self.progress_path)
        except OSError:
            return 0

    def _last_step(self) -> int:
        rows = read_progress(self.progress_path)
        return max((int(r.get("step", 0)) for r in rows), default=0)

    # -- group lifecycle -------------------------------------------------
    def _plan(self) -> Dict[str, int]:
        # ONE census snapshot shared with the _launch that follows: a host
        # vanishing between plan and launch must not hand a 4-device mesh
        # to a 1-worker group (the mismatch would burn a recovery round)
        hosts = list(self._hosts_fn())
        if not hosts:
            raise RecoveryFailed("no surviving hosts to plan a mesh over")
        self._planned_hosts = hosts
        n_dev = len(hosts) * self.devices_per_host
        mesh = plan_mesh(n_dev, template=self.mesh_template or self.mesh)
        return {ax: sz for ax, sz in mesh.items() if sz > 1} or {"data": 1}

    def _launch(self, mesh: Dict[str, int], resume: bool) -> list:
        # one process a rank: a host runs devices_per_host of them
        n_workers = len(self._planned_hosts) * self.devices_per_host
        env = {
            **self.worker_env,
            "DSTPU_MESH": json.dumps(mesh),
            "DSTPU_CKPT_DIR": self.ckpt_dir,
            "DSTPU_PROGRESS": self.progress_path,
            "DSTPU_TOTAL_STEPS": str(self.total_steps),
            "DSTPU_RESUME": "1" if resume else "0",
            "DSTPU_INCARNATION": str(self._incarnation),
        }
        self._incarnation += 1
        self.mesh = dict(mesh)
        self._started_at = time.monotonic()
        self._mark_at_start = self._progress_size()
        # snapshot so an outage cross-links only bundles dumped DURING
        # this incarnation, not earlier outages' recovery bundles
        self._bundles_at_launch = set(os.listdir(self.flight_dir)) \
            if os.path.isdir(self.flight_dir) else set()
        return start_group(WorkerSpec(self.worker_cmd, env=env), n_workers)

    # -- heartbeat -------------------------------------------------------
    def _feed_watchdog(self, wd: Watchdog) -> None:
        n = self._progress_size()
        if n > self._progress_mark:
            self._progress_mark = n
            wd.beat()
        elif n <= self._mark_at_start and \
                time.monotonic() - self._started_at < self.resume_deadline_s:
            # start-up grace: a fresh incarnation legitimately spends a
            # while before its first step (imports, the process group,
            # the model, the resume).  Once the
            # incarnation's first line lands (n > mark_at_start) the
            # grace ends; the grace itself is bounded by resume_deadline.
            wd.beat()

    # -- main loop -------------------------------------------------------
    def run(self) -> SupervisorResult:
        os.makedirs(self.ckpt_dir, exist_ok=True)
        os.makedirs(self.flight_dir, exist_ok=True)
        mesh = self._plan()
        self._event("running", mesh=mesh, workers=len(self._planned_hosts))
        procs = self._launch(mesh, resume=False)
        wd = Watchdog("recovery", deadline_s=self.deadline_s,
                      output_dir=self.flight_dir, ring=self._ring,
                      telemetry=self.telemetry, tracer=self._tracer,
                      poll_s=min(1.0, self.poll_s),
                      on_fire=lambda bundle: self._hang.set())
        wd.start()
        try:
            while True:
                time.sleep(self.poll_s)
                self._feed_watchdog(wd)
                codes = [p.poll() for p in procs]
                if all(c == 0 for c in codes):
                    return SupervisorResult(
                        0, self.recoveries, self.outages, self.events,
                        self.progress_path, self.mesh)
                crashed = [c for c in codes if c not in (None, 0)]
                if crashed or self._hang.is_set():
                    wd.pause()
                    reason = "crash" if crashed else "hang"
                    self._hang.clear()
                    procs = self._recover(procs, reason, codes)
                    wd.resume()
        finally:
            wd.stop()
            stop_group(procs, stop_timeout_s=self.stop_timeout_s)

    # -- the recovery transition ----------------------------------------
    def _recover(self, procs: list, reason: str, codes: list) -> list:
        t0 = time.monotonic()
        span = (self._tracer.span("recovery.outage", self._trace_id)
                .set(reason=reason) if self._tracer.enabled else None)
        self._event("detected", reason=reason, codes=list(codes))
        if self._tracer.enabled:
            self._tracer.instant("recovery.detected", self._trace_id,
                                 reason=reason, codes=repr(codes))

        known = set(os.listdir(self.flight_dir)) \
            if os.path.isdir(self.flight_dir) else set()
        bundle = dump_bundle(
            self.flight_dir, "recovery", ring=self._ring,
            telemetry=self.telemetry,
            # NOT "reason": extra keys merge over the manifest's own, and
            # "reason" must stay the frozen bundle vocabulary's `recovery`
            extra={"detect_reason": reason, "codes": codes,
                   "recoveries": self.recoveries,
                   # bundles dumped during THIS incarnation — the dying
                   # workers' own (engine_crash / their watchdog) —
                   # cross-linked so one outage reads as one incident;
                   # the launch-time snapshot keeps earlier outages'
                   # bundles out of this incident's manifest
                   "worker_bundles": sorted(known - self._bundles_at_launch)})
        self._event("dumped", bundle=bundle)

        while True:
            stop_group(procs, stop_timeout_s=self.stop_timeout_s)
            self._event("stopped")

            mesh = self._plan()
            resized = mesh != self.mesh
            self._event("replanned", mesh=mesh, resized=resized)
            if self._tracer.enabled:
                self._tracer.instant("recovery.replan", self._trace_id,
                                     mesh=json.dumps(mesh), resized=resized)

            self.recoveries += 1
            if self.recoveries > self.max_recoveries:
                self._event("failed", recoveries=self.recoveries)
                if span is not None:
                    span.end(outcome="failed")
                raise RecoveryFailed(
                    f"recovery budget exhausted "
                    f"({self.max_recoveries}); last reason: {reason}")

            self._progress_mark = self._progress_size()
            procs = self._launch(mesh, resume=True)
            self._event("restarted", workers=len(procs), mesh=mesh)
            if self._tracer.enabled:
                self._tracer.instant("recovery.restart", self._trace_id,
                                     workers=len(procs))

            deadline = time.monotonic() + self.resume_deadline_s
            while time.monotonic() < deadline:
                time.sleep(self.poll_s)
                codes2 = [p.poll() for p in procs]
                if self._progress_size() > self._progress_mark or \
                        all(c == 0 for c in codes2):
                    # new progress — OR the whole group exited 0 without
                    # writing a line: the job was already complete at
                    # resume (killed between its final save and exit).
                    # Both end the outage; run()'s loop then returns 0.
                    outage_s = time.monotonic() - t0
                    step = self._last_step()
                    self._event("resumed", outage_s=round(outage_s, 3),
                                step=step)
                    if self._tracer.enabled:
                        self._tracer.instant("recovery.resumed",
                                             self._trace_id, step=step,
                                             outage_s=round(outage_s, 3))
                    if span is not None:
                        span.end(outcome="resumed",
                                 outage_s=round(outage_s, 3))
                    if self.telemetry is not None:
                        self.telemetry.record_recovery(step, outage_s)
                    self.outages.append({"reason": reason,
                                         "outage_s": outage_s,
                                         "mesh": dict(mesh),
                                         "resized": resized,
                                         "bundle": bundle})
                    return procs
                if any(c not in (None, 0) for c in codes2):
                    break  # restarted group died before progressing
            logger.warning("recovery supervisor: restarted group produced "
                           "no progress; recovering again")
            reason = "restart_stalled"
