"""Deterministic fault injection shared by training and serving.

Copy of ``deepspeed_tpu/resilience/chaos.py`` (it imports nothing of
JAX).  This module is the one chaos vocabulary training and serving
speak: a typed, **seeded** :class:`FaultPlan` (frozen fault kinds,
:data:`FAULT_KINDS`) scheduled against **named injection points**
(:data:`INJECTION_POINTS`) that the serve loop, router, disagg handoff
path and ``InferenceEngineV2.step`` poll, plus the training worker's
die/hang/ignore-term contract re-implemented on the same kinds
(``die_at`` ≡ ``replica_crash``, ``hang_at`` ≡ ``replica_hang``).

Design constraints:

* **Deterministic.**  A plan is a sorted tuple of :class:`FaultSpec`;
  any randomness (storm victim choice, burst sizing) comes from a
  ``random.Random`` seeded by ``(plan.seed, target)`` — two runs of the
  same plan against the same fleet inject identically.
* **Free when disabled.**  Call sites hold ``self._chaos = None`` by
  default and guard with one attribute check — no plan, no work, no
  allocation (the same contract as the disabled tracer).
* **Attributable.**  Every injection emits a frozen ``chaos.inject``
  trace instant (kind / point / target), so flight bundles and the run
  ledger can pin observed damage on the fault that caused it.
* **Injection points describe *where*, specs describe *what*.**  The
  semantics of a fault (raise, sleep, cancel, flood) live at the call
  site — this module only decides *when a spec is due*.

See docs/SERVING.md "Fault injection & self-healing".
"""

from __future__ import annotations

import json
import os
import random
import signal
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence

# ---------------------------------------------------------------------------
# Frozen vocabularies (linted against docs/SERVING.md by telemetry_check)
# ---------------------------------------------------------------------------

#: every fault kind a plan may schedule — train and serve share this set
FAULT_KINDS = (
    "admission_storm",   # flood the admission queue with junk requests
    "cancel_storm",      # cancel a batch of in-flight streams
    "handoff_fail",      # fail a KV-chain export/import (disagg legs)
    "replica_crash",     # serve loop dies mid-step (train: exit(13))
    "replica_hang",      # serve loop wedges: alive, silent, no progress
    "slow_replica",      # injected per-step delay over a window
)

#: named places the hot loops poll for due faults
INJECTION_POINTS = (
    "engine.step",       # InferenceEngineV2.step ragged dispatch
    "router.dispatch",   # router binding a request leg to a replica
    "server.handoff",    # KV-chain export/import in the serve loop
    "server.step",       # top of one serve-loop engine step
    "train.step",        # training worker, after one train_batch
)

# default injection point per kind (a spec may pin a different one, e.g.
# slow_replica at engine.step to delay inside the engine instead of the
# serve loop)
_KIND_POINT = {
    "admission_storm": "server.step",
    "cancel_storm": "server.step",
    "handoff_fail": "server.handoff",
    "replica_crash": "server.step",
    "replica_hang": "server.step",
    "slow_replica": "server.step",
}

# kinds active over a [at, at+duration_s] window, re-returned on every
# poll while due; everything else fires exactly once per injector
_DURATIONAL = ("slow_replica",)

#: training env contract (resilience/worker.py): honored ONCE per ckpt
#: dir via the :data:`CHAOS_SENTINEL` file
TRAIN_CHAOS_ENV = "DSTPU_CHAOS"
CHAOS_SENTINEL = ".chaos_fired"


class ChaosError(RuntimeError):
    """An injected fault firing — deliberately NOT a ServingError, so it
    rides the same "unexpected engine/loop failure" paths a real crash
    takes instead of being treated as a typed request outcome."""


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    ``at`` is seconds after the injector is armed; ``target`` names a
    replica (``"r0"``) or ``None`` for every component sharing the plan;
    ``params`` carries kind-specific knobs (``delay_ms`` for
    ``slow_replica``, ``burst``/``priority`` for ``admission_storm``,
    ``count`` for ``cancel_storm``)."""

    kind: str
    at: float = 0.0
    target: Optional[str] = None
    duration_s: float = 0.0
    point: Optional[str] = None
    params: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {FAULT_KINDS})")
        point = self.point or _KIND_POINT[self.kind]
        if point not in INJECTION_POINTS:
            raise ValueError(f"unknown injection point {point!r} "
                             f"(one of {INJECTION_POINTS})")
        object.__setattr__(self, "point", point)
        object.__setattr__(self, "at", float(self.at))
        object.__setattr__(self, "duration_s", float(self.duration_s))
        object.__setattr__(self, "params", dict(self.params))


class FaultPlan:
    """An ordered, validated schedule of faults plus the seed every
    injector derives its randomness from."""

    def __init__(self, faults: Sequence[Any], seed: int = 0):
        specs = [f if isinstance(f, FaultSpec) else FaultSpec(**dict(f))
                 for f in faults]
        self.faults = tuple(sorted(
            specs, key=lambda s: (s.at, s.kind, s.target or "")))
        self.seed = int(seed)

    def __len__(self) -> int:
        return len(self.faults)

    def for_target(self, target: Optional[str]) -> List[FaultSpec]:
        """Specs an injector named ``target`` must honor: its own plus
        the broadcast (``target=None``) ones."""
        return [f for f in self.faults
                if f.target is None or f.target == target]


class ChaosInjector:
    """One component's view of a plan: ``fire(point)`` returns the specs
    due *now* at that point (thread-safe; one-shot kinds are consumed
    exactly once, durational kinds re-fire while inside their window)
    and emits one ``chaos.inject`` instant per spec activation."""

    def __init__(self, plan: FaultPlan, target: Optional[str] = None,
                 tracer: Any = None, trace_id: str = "chaos"):
        self.plan = plan
        self.target = target
        self.tracer = tracer
        self.trace_id = trace_id
        self.rng = random.Random(
            (plan.seed << 16) ^ zlib.crc32((target or "*").encode()))
        self._specs = plan.for_target(target)
        self._t0: Optional[float] = None
        self._fired: set = set()       # consumed one-shot spec indices
        self._announced: set = set()   # durational specs already instant-ed
        self._lock = threading.Lock()
        self.injected = 0              # lifetime activations (bench/test)
        self.fired_kinds: set = set()  # distinct kinds activated so far

    @property
    def armed(self) -> bool:
        return self._t0 is not None

    def arm(self, now: Optional[float] = None) -> "ChaosInjector":
        """Start the plan clock (monotonic).  Pass a shared ``now`` to
        arm a whole fleet's injectors against one origin."""
        self._t0 = time.monotonic() if now is None else float(now)
        return self

    def fire(self, point: str,
             now: Optional[float] = None) -> List[FaultSpec]:
        t0 = self._t0
        if t0 is None or not self._specs:
            return []
        dt = (time.monotonic() if now is None else now) - t0
        due: List[FaultSpec] = []
        with self._lock:
            for i, f in enumerate(self._specs):
                if f.point != point or dt < f.at:
                    continue
                if f.kind in _DURATIONAL:
                    if f.duration_s > 0 and dt > f.at + f.duration_s:
                        continue
                    due.append(f)
                    if i not in self._announced:
                        self._announced.add(i)
                        self._activate(f, point)
                else:
                    if i in self._fired:
                        continue
                    self._fired.add(i)
                    due.append(f)
                    self._activate(f, point)
        return due

    def _activate(self, f: FaultSpec, point: str) -> None:
        self.injected += 1
        self.fired_kinds.add(f.kind)
        tr = self.tracer
        if tr is not None and getattr(tr, "enabled", False):
            tr.instant("chaos.inject", self.trace_id, kind=f.kind,
                       point=point, target=self.target or "*", at=f.at)

    def delay_s(self, specs: Sequence[FaultSpec]) -> float:
        """Total injected delay of the ``slow_replica`` specs in a
        ``fire()`` result (default 50 ms per spec)."""
        return sum(float(f.params.get("delay_ms", 50.0)) / 1e3
                   for f in specs if f.kind == "slow_replica")


def attach_chaos(replicas: Any, plan: FaultPlan, router: Any = None,
                 arm: bool = True) -> Dict[str, ChaosInjector]:
    """Wire one injector per replica (serve loop + engine share it) and
    optionally one for the router, all armed against one shared origin
    so ``at`` offsets line up fleet-wide.  Returns ``{target: injector}``
    (router under ``"router"``)."""
    injectors: Dict[str, ChaosInjector] = {}
    for rep in replicas:
        inj = ChaosInjector(plan, target=rep.name,
                            tracer=getattr(rep.server, "tracer", None))
        rep.server._chaos = inj
        rep.engine.chaos = inj
        injectors[rep.name] = inj
    if router is not None:
        inj = ChaosInjector(plan, target=None,
                            tracer=getattr(router, "tracer", None))
        router._chaos = inj
        injectors["router"] = inj
    if arm:
        t0 = time.monotonic()
        for inj in injectors.values():
            inj.arm(t0)
    return injectors


# ---------------------------------------------------------------------------
# Training contract (resilience/worker.py) on the shared vocabulary
# ---------------------------------------------------------------------------

def chaos_env_cfg(env: Optional[Mapping[str, str]] = None) -> dict:
    """Parse the ``DSTPU_CHAOS`` JSON env contract (empty dict = off)."""
    src = os.environ if env is None else env
    return json.loads(src.get(TRAIN_CHAOS_ENV) or "{}")


def chaos_armed(ckpt_dir: str) -> bool:
    """Fault injection fires in exactly one incarnation: the sentinel is
    written BEFORE the fatal action, so the restarted worker sees it and
    trains through."""
    return not os.path.exists(os.path.join(ckpt_dir, CHAOS_SENTINEL))


def arm_sentinel(ckpt_dir: str) -> None:
    with open(os.path.join(ckpt_dir, CHAOS_SENTINEL), "w") as f:
        f.write(str(os.getpid()))


class TrainChaos:
    """The training worker's ``DSTPU_CHAOS`` contract expressed on the
    shared kinds: ``die_at`` is a ``replica_crash`` at the ``train.step``
    point, ``hang_at`` a ``replica_hang`` (``ignore_term`` additionally
    swallows SIGTERM so only SIGKILL escalation clears the worker).
    Exactly-once semantics ride the :data:`CHAOS_SENTINEL` file."""

    def __init__(self, cfg: Mapping[str, Any], ckpt_dir: str):
        self.cfg = dict(cfg)
        self.ckpt_dir = ckpt_dir

    @classmethod
    def from_env(cls, rank: int, ckpt_dir: str,
                 env: Optional[Mapping[str, str]] = None
                 ) -> Optional["TrainChaos"]:
        """The rank's armed chaos config, or ``None`` when chaos is off,
        targets another rank, or already fired in a past incarnation."""
        cfg = chaos_env_cfg(env)
        if not cfg or int(cfg.get("rank", 0)) != rank \
                or not chaos_armed(ckpt_dir):
            return None
        return cls(cfg, ckpt_dir)

    def install_signals(self) -> None:
        if self.cfg.get("ignore_term"):
            signal.signal(signal.SIGTERM, signal.SIG_IGN)

    def fire(self, done: int) -> None:
        """The ``train.step`` injection point — call after step ``done``
        is trained but BEFORE it is saved, so a die loses the step and
        the resumed incarnation must recompute it from the previous
        committed checkpoint (the real mid-train crash shape)."""
        cfg = self.cfg
        if cfg.get("die_at") is not None and done >= int(cfg["die_at"]):
            arm_sentinel(self.ckpt_dir)
            os._exit(13)
        if cfg.get("hang_at") is not None and done >= int(cfg["hang_at"]):
            arm_sentinel(self.ckpt_dir)
            while True:  # simulated wedge: alive, silent, not progressing
                time.sleep(3600)
