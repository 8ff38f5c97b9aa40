"""The port's recovery loop (``deepspeed_tpu_torch/resilience/
{supervisor,worker}.py``, ``elasticity/``, the crash protocol of
``checkpoint/universal.py``) on the CPU: mirrors of the JAX package's
``tests/test_resilience.py`` and ``tests/test_launcher_elasticity.py``
cases.

The supervisor runs the port's worker (``python -m
deepspeed_tpu_torch.resilience.worker``), one process a rank over gloo on
the CPU: gpt2-tiny at data 2, a worker killed after step 2 (before its
save), the mesh re-planned to data 1 and resumed from the last committed
universal checkpoint; the loss curve must land on the unkilled run's
within 2e-3 (the JAX test's bound), the recomputed step included.  The
frozen vocabularies and ``plan_mesh`` equal the JAX package's.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from deepspeed_tpu.resilience import oracle as joracle
from deepspeed_tpu.resilience import supervisor as jsupervisor
from deepspeed_tpu_torch.checkpoint.universal import (COMMIT_MARKER,
                                                      resolve_universal_dir)
from deepspeed_tpu_torch.elasticity import (DSElasticAgent, WorkerSpec,
                                            stop_group)
from deepspeed_tpu_torch.resilience import oracle as toracle
from deepspeed_tpu_torch.resilience.supervisor import (RECOVERY_STATES,
                                                       RecoveryFailed,
                                                       RecoverySupervisor,
                                                       loss_curve)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the workers import the port from this checkout and ask for the CPU
WORKER_ENV = {"PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
              "DSTPU_FORCE_CPU": "1", "DSTPU_SEQ": "16", "DSTPU_BATCH": "8"}


def test_frozen_vocabulary_and_plan_mesh_equal_jax():
    assert RECOVERY_STATES == jsupervisor.RECOVERY_STATES
    for n, template in [(4, None), (2, {"data": 4}), (6, {"seq": 4}),
                        (8, {"tensor": 2, "pipe": 2}), (3, {"seq": 2})]:
        assert toracle.plan_mesh(n, template) == joracle.plan_mesh(n, template)


ELASTIC = {"elasticity": {"enabled": True, "max_train_batch_size": 10000,
                          "micro_batch_sizes": [8, 12, 16, 17],
                          "min_gpus": 32, "max_gpus": 1500, "min_time": 20,
                          "version": 0.1}}


@pytest.mark.parametrize("cfg,world", [
    (ELASTIC, 0), (ELASTIC, 64),
    ({"elasticity": {**ELASTIC["elasticity"], "version": 0.2,
                     "model_parallel_size": 4, "num_gpus_per_node": 8,
                     "min_gpus": 4, "max_gpus": 256}}, 0),
], ids=["v01", "v01-world", "v02-model-parallel"])
def test_elastic_config_equals_jax(cfg, world):
    """The copied elasticity module gives the JAX module's batch, valid
    device counts and micro batch."""
    from deepspeed_tpu import elasticity as jel
    from deepspeed_tpu_torch import elasticity as tel

    want = jel.compute_elastic_config(cfg, world_size=world,
                                      return_microbatch=True)
    assert tel.compute_elastic_config(cfg, world_size=world,
                                      return_microbatch=True) == want
    with pytest.raises(tel.ElasticityIncompatibleWorldSize):
        tel.compute_elastic_config(cfg, world_size=7919)


def _fake_committed(root, tag, steps):
    udir = os.path.join(root, tag, "universal")
    os.makedirs(os.path.join(udir, "params"), exist_ok=True)
    os.makedirs(os.path.join(udir, "optimizer"), exist_ok=True)
    with open(os.path.join(udir, "meta.json"), "w") as f:
        json.dump({"global_steps": steps}, f)
    with open(os.path.join(udir, COMMIT_MARKER), "w") as f:
        f.write("{}")
    return udir


def test_resolve_skips_uncommitted_tags(tmp_path):
    """`latest` names a tag whose conversion never committed: resolve
    falls back to the newest COMMITTED tag; a torn final dir is skipped;
    an explicitly requested torn tag raises."""
    root = str(tmp_path)
    good = _fake_committed(root, "step2", steps=2)
    _fake_committed(root, "step1", steps=1)
    staging = os.path.join(root, "step3", "universal.tmp-12345")
    os.makedirs(os.path.join(staging, "params"))
    with open(os.path.join(staging, "meta.json"), "w") as f:
        json.dump({"global_steps": 3}, f)
    with open(os.path.join(root, "latest"), "w") as f:
        f.write("step3")
    assert resolve_universal_dir(root) == good

    torn = os.path.join(root, "step4", "universal")
    os.makedirs(torn)
    with open(os.path.join(torn, "meta.json"), "w") as f:
        json.dump({"global_steps": 4}, f)
    with open(os.path.join(root, "latest"), "w") as f:
        f.write("step4")
    assert resolve_universal_dir(root) == good
    with pytest.raises(FileNotFoundError, match="uncommitted"):
        resolve_universal_dir(torn)
    with pytest.raises(FileNotFoundError, match="requested tag"):
        resolve_universal_dir(root, tag="step4")


def test_mid_save_kill_leaves_previous_tag_resumable(tmp_path):
    """A subprocess (no JAX) converts a real checkpoint and is SIGKILLed
    inside the write: the final universal dir must not exist, and resolve
    lands on the earlier committed tag."""
    root = str(tmp_path)
    code = f"""
import os, sys
sys.path.insert(0, {ROOT!r})
sys.modules["jax"] = None
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.checkpoint import universal as u
from deepspeed_tpu_torch.models import get_model_config
engine, _, _, _ = ds.initialize(model=get_model_config("gpt2-tiny"), config={{
    "train_micro_batch_size_per_gpu": 4,
    "optimizer": {{"type": "AdamW", "params": {{"lr": 1e-3}}}},
    "zero_optimization": {{"stage": 2}}, "steps_per_print": 1000}},
    device="cpu")
engine.save_checkpoint({root!r}, tag="a")
u.ds_to_universal({root!r}, tag="a")          # commits cleanly
engine.save_checkpoint({root!r}, tag="b")     # latest -> b
orig = u._save_flat
def dying(flat, out_root):
    orig(flat, out_root)
    os.kill(os.getpid(), 9)                   # die mid-conversion
u._save_flat = dying
u.ds_to_universal({root!r}, tag="b")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == -9, proc.stderr[-2000:]
    assert not os.path.exists(os.path.join(root, "b", "universal")), \
        "a killed save must not publish a final universal dir"
    assert any(n.startswith("universal.tmp-")
               for n in os.listdir(os.path.join(root, "b")))
    with open(os.path.join(root, "latest")) as f:
        assert f.read().strip() == "b"
    assert resolve_universal_dir(root) == os.path.join(root, "a", "universal")


def test_stop_group_escalates_sigterm_to_sigkill():
    """Workers swallowing SIGTERM share ONE deadline and are SIGKILLed."""
    code = ("import signal, time\n"
            "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
            "print('armed', flush=True)\n"
            "time.sleep(600)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        assert p.stdout.readline().strip() == "armed"
    t0 = time.monotonic()
    stop_group(procs, stop_timeout_s=1.0)
    elapsed = time.monotonic() - t0
    assert all(p.poll() is not None for p in procs)
    assert any(p.returncode == -signal.SIGKILL for p in procs)
    assert elapsed < 15.0, elapsed


def test_stop_group_graceful_workers_not_killed():
    procs = [subprocess.Popen([sys.executable, "-c",
                               "import time; time.sleep(600)"])]
    stop_group(procs, stop_timeout_s=10.0)
    assert procs[0].returncode == -signal.SIGTERM


def test_elastic_agent_restarts_dead_worker_and_recovers(tmp_path):
    sentinel = tmp_path / "died_once"
    code = ("import os, sys\n"
            f"p = {str(sentinel)!r}\n"
            "if not os.path.exists(p):\n"
            "    open(p, 'w').close()\n"
            "    sys.exit(3)\n"
            "sys.exit(0)\n")
    agent = DSElasticAgent(WorkerSpec([sys.executable, "-c", code]),
                           max_restarts=3, monitor_interval=0.05)
    assert agent.run() == 0
    assert agent.restarts == 1


def test_elastic_agent_max_restarts_honored(tmp_path):
    counter = tmp_path / "attempts"
    code = ("import sys\n"
            f"p = {str(counter)!r}\n"
            "with open(p, 'a') as f:\n"
            "    f.write('x')\n"
            "sys.exit(5)\n")
    agent = DSElasticAgent(WorkerSpec([sys.executable, "-c", code]),
                           max_restarts=2, monitor_interval=0.05)
    assert agent.run() == 1
    assert agent.restarts == 3
    assert len(counter.read_text()) == 3


def test_start_group_env_layout(tmp_path):
    """Each worker sees its rank and world in the JAX package's names."""
    code = ("import os\n"
            f"d = {str(tmp_path)!r}\n"
            "keys = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'DSTPU_NUM_PROCS',"
            " 'DSTPU_PROC_ID')\n"
            "open(os.path.join(d, os.environ['RANK']), 'w').write("
            "' '.join(os.environ[k] for k in keys))\n")
    agent = DSElasticAgent(WorkerSpec([sys.executable, "-c", code],
                                      local_world_size=3),
                           monitor_interval=0.05)
    assert agent.run() == 0
    for r in range(3):
        assert (tmp_path / str(r)).read_text() == f"{r} 3 {r} 3 {r}"


class _Telemetry:
    """What the supervisor reads of a telemetry hub: the port's tracer
    and flight ring, and a ``record_recovery`` that keeps its calls (the
    JAX hub's StepRecord, ``telemetry/record.py``, is not ported)."""

    def __init__(self):
        from deepspeed_tpu_torch.telemetry.flight import FlightRecorder
        from deepspeed_tpu_torch.telemetry.tracing import Tracer

        self.tracer = Tracer(enabled=True)
        self.flight_ring = FlightRecorder()
        self.recoveries = []

    def record_recovery(self, step, outage_s):
        self.recoveries.append((step, outage_s))


def test_supervisor_chaos_crash_resize_resume(tmp_path):
    """A worker killed mid-run → flight bundle → group stopped → mesh
    re-planned SMALLER (its host is gone) → restarted → universal resume
    → the loss curve lands on the unkilled run's, with the outage in the
    trace and in ``record_recovery``."""
    total, die_at = 4, 2
    ref = RecoverySupervisor(
        str(tmp_path / "ref"), hosts_fn=lambda: ["h0", "h1"],
        total_steps=total, deadline_s=60.0, poll_s=0.2,
        worker_env=dict(WORKER_ENV)).run()
    assert ref.returncode == 0 and ref.recoveries == 0
    assert ref.mesh == {"data": 2}
    ref_losses = loss_curve(ref.progress_path)
    assert sorted(ref_losses) == list(range(1, total + 1))

    chaos_dir = str(tmp_path / "chaos")
    os.makedirs(chaos_dir)
    sentinel = os.path.join(chaos_dir, ".chaos_fired")
    tel = _Telemetry()
    res = RecoverySupervisor(
        chaos_dir,
        hosts_fn=lambda: ["h0"] if os.path.exists(sentinel) else ["h0", "h1"],
        total_steps=total, deadline_s=60.0, poll_s=0.2, stop_timeout_s=10.0,
        resume_deadline_s=240.0, telemetry=tel,
        worker_env={**WORKER_ENV,
                    "DSTPU_CHAOS": json.dumps({"die_at": die_at})}).run()

    assert res.returncode == 0 and res.recoveries == 1
    assert res.outages[0]["resized"] and res.mesh == {"data": 1}
    states = [e.state for e in res.events]
    assert states.index("detected") < states.index("dumped") \
        < states.index("stopped") < states.index("replanned") \
        < states.index("restarted") < states.index("resumed")
    bundle = res.outages[0]["bundle"]
    with open(os.path.join(bundle, "manifest.json")) as f:
        assert json.load(f)["reason"] == "recovery"
    assert os.path.exists(os.path.join(bundle, "stacks.txt"))

    curve = loss_curve(res.progress_path)
    assert sorted(curve) == list(range(1, total + 1))
    for s in range(1, total + 1):
        assert abs(curve[s] - ref_losses[s]) < 2e-3, (s, curve[s],
                                                      ref_losses[s])
    rows = [json.loads(line) for line in open(res.progress_path)]
    incarnations = {r["step"]: r["incarnation"] for r in rows}
    assert incarnations[die_at] == 1   # the lost step ran again
    # ... and only it: the restart resumed from the tag of step die_at - 1
    assert all(incarnations[s] == 0 for s in range(1, die_at))
    assert {r["start_step"] for r in rows if r["incarnation"] == 1} \
        == {die_at - 1}

    (step, outage_s), = tel.recoveries
    assert outage_s == pytest.approx(res.outages[0]["outage_s"])
    names = {e["name"] for e in tel.tracer.snapshot()}
    assert {"recovery.outage", "recovery.detected", "recovery.replan",
            "recovery.restart", "recovery.resumed"} <= names


def test_supervisor_hang_watchdog_recovery(tmp_path):
    """The worker stops heartbeating (wedged, SIGTERM ignored): the
    watchdog fires, escalation clears it, and the run completes."""
    res = RecoverySupervisor(
        str(tmp_path / "hang"), hosts_fn=lambda: ["h0"], total_steps=2,
        deadline_s=6.0, poll_s=0.2, stop_timeout_s=2.0,
        resume_deadline_s=240.0,
        worker_env={**WORKER_ENV, "DSTPU_BATCH": "4",
                    "DSTPU_CHAOS": json.dumps({"hang_at": 1,
                                               "ignore_term": True})}).run()
    assert res.returncode == 0 and res.recoveries >= 1
    assert res.outages[0]["reason"] == "hang"
    assert sorted(loss_curve(res.progress_path)) == [1, 2]


def test_supervisor_max_recoveries_budget(tmp_path):
    """A worker that dies at once every time exhausts the budget and fails
    loudly."""
    sup = RecoverySupervisor(
        str(tmp_path / "doom"), hosts_fn=lambda: ["h0"], total_steps=3,
        deadline_s=30.0, poll_s=0.1, stop_timeout_s=2.0,
        resume_deadline_s=30.0, max_recoveries=1,
        worker_cmd=[sys.executable, "-c", "import sys; sys.exit(3)"])
    with pytest.raises(RecoveryFailed, match="budget"):
        sup.run()
    assert [e.state for e in sup.events].count("restarted") == 1
    assert sup.events[-1].state == "failed"
    assert np.isfinite(sup.events[-1].time_unix)
