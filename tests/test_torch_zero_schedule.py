"""ZeRO-3's step schedule and the qwZ weight gather of the port, on the
CPU: the gather window of ``step_schedule.gather_prefetch_depth``, the
flat per-layer all-gathers, the stage-3 gradients through flat buckets
(``zero.Stage3Reducer``) and ``comm_quantization.zero3_gather`` /
``zero_optimization.zero_quantized_weights`` (``parallel/zeropp.py``).

The port trains in spawned gloo CPU ranks (rank bodies in
``torch_schedule_ranks.py``); the JAX engine runs on the conftest's CPU
devices.

* Depths 1, 2, 4 and 3 (clamped to 2, with the JAX engine's warning) on
  gpt2-tiny at 4 layers, ZeRO-3 over 4 ranks, fused and
  unfused, remat ``none`` and ``full``: losses, grad norms and the params
  after two steps bit for bit; one flat all-gather a layer (and the top
  leaves), one more a layer under remat ``full``, and per layer the fused
  MLP's own gathers.
* Depth 2 against the JAX engine at depth 2 (its layer scan unrolled by
  two): gpt2-tiny (4 layers) at ``{"data": 4}`` and llama-tiny's ring at
  ``{"data": 2, "seq": 2}``, to ``test_torch_mesh_engine.py``'s
  tolerances (losses and grad norms within 1e-5, each leaf's update
  within 1e-3 relative L2, every element within lr).
* The stage-3 reducer: its reduce-scatters a micro-step are the buckets
  ``comm.plan_buckets`` plans over the gradients in the order the
  backward hands them over (their number and each one's elements), at the
  default size, one layer's elements, one and a half of the largest
  leaf's and 1 (one bucket a gathered leaf); and the flat gather
  (``comm.all_gather_bucket``) against one all-gather a tensor; every size gives the same bits (gloo's
  reduce-scatter is the point-to-point ring, whose sums do not depend on
  where an element lies in the buffer).
* qwZ: the mirrors of the JAX tests ``test_zeropp.py::
  test_qwz_trains_close_to_exact`` and ``test_quantized_comm.py::
  test_zero3_gather_fp8_trains`` (data 8 cut to 4 ranks); the int8 gather
  against the JAX qwZ engine at ``{"data": 4}`` with ``wo`` split on its
  128-wide last dim, 32 columns a rank inside one 128-wide block (its
  scales are the whole block's); the same bits at depth 2 as at depth 1;
  and the all-gathers moving the int8 or fp8 payload and fp32 scales as
  bytes, under a third of an fp32 gather.
* ``zero.GatheredParameters``'s ``updated`` tree and
  ``zero.gathered_update`` against the JAX functions, and the memory
  estimators.
* The schedule and qwZ keys: accepted, and rejected with the JAX config's
  messages; hpZ and MiCS over a data world their shard size does not
  divide raise the JAX engine's ``ValueError``.
"""

import jax
import numpy as np
import pytest

import deepspeed_tpu as dsj
import deepspeed_tpu_torch as dst
from deepspeed_tpu import zero as jzero
from deepspeed_tpu.models import get_model_config as jax_model_config
from deepspeed_tpu.parallel import topology as jtopology
from deepspeed_tpu.runtime.config import (DeepSpeedConfig as JaxConfig,
                                          DeepSpeedConfigError as JaxConfigError)
from deepspeed_tpu_torch import zero
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.models import get_model_config
from deepspeed_tpu_torch.models.bridge import params_from_jax
from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                DeepSpeedConfigError)

import torch_schedule_ranks
from test_torch_engine_v2 import one_torch_thread  # noqa: F401
from test_torch_mesh_engine import (CFG, MESH, RING, _batch, _check, _get,
                                    _jax_init, _jax_run, _paths)

LAYERS = {"num_layers": 4}
STEPS = 2
GAS = CFG["gradient_accumulation_steps"]
# qwZ against the JAX qwZ engine, per step.  The first step encodes the
# same masters: the same payload, and a gathered leaf's forward value is
# the decoded w where the JAX value p + (w - p) can differ from it by an
# ulp (zeropp.py).  The second step encodes masters one AdamW step on,
# which differ by the summation order of the gradients; an element on a
# rounding boundary of the wire then lands one int8 step (absmax / 127)
# apart, as the ring's wire does (test_torch_ring_engine.py WIRE_RTOL).
QWZ_RTOL = (1e-6, 1e-4)


def _zero3(mesh, **extra):
    cfg = {**CFG, "mesh": dict(mesh), **extra}
    cfg["zero_optimization"] = {"stage": 3, "param_persistence_threshold": 0,
                                **extra.get("zero_optimization", {})}
    return cfg


def _schedule(cfg, **keys):
    return {**cfg, "step_schedule": {**cfg.get("step_schedule", {}), **keys}}


def _same_bits(a, b, what):
    assert a["losses"] == b["losses"], what
    assert a["grad_norms"] == b["grad_norms"], what
    for path, x in _paths(b["params"]):
        np.testing.assert_array_equal(_get(a["params"], path), x,
                                      err_msg=str((what, path)))


def _every_rank(ranks, name):
    for r in ranks[1:]:
        assert r[name]["losses"] == ranks[0][name]["losses"], name
        assert r[name]["checksum"] == ranks[0][name]["checksum"], name


# ----------------------------------------------------------------------
# the window
# ----------------------------------------------------------------------
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_prefetch_depths_give_the_same_bits(remat, fused):
    params = params_from_jax(jax.tree.map(np.asarray, _jax_init(
        "gpt2-tiny", LAYERS)), get_model_config("gpt2-tiny", **LAYERS),
        device="cpu")
    batch = _batch(CFG["train_micro_batch_size_per_gpu"] * GAS * 4)
    base = _zero3({"data": 4}, activation_checkpointing={
        "remat_policy": remat})
    runs = [{"name": f"depth{d}", "model": "gpt2-tiny", "model_kw": LAYERS,
             "params": params, "batch": batch, "steps": STEPS,
             "cfg": _schedule(base, gather_prefetch_depth=d,
                              fused_gather_matmul=fused)}
            for d in (1, 2, 3, 4)]
    ranks = launch(torch_schedule_ranks.schedule_runs, 4, args=(runs,),
                   backend="gloo", device="cpu")
    got = ranks[0]
    assert [got[f"depth{d}"]["depth"] for d in (1, 2, 3, 4)] == [1, 2, 2, 4]
    assert any("gather_prefetch_depth=3 does not divide num_layers=4; "
               "clamped to 2" in w for w in got["depth3"]["warnings"])
    layers = LAYERS["num_layers"]
    passes = 2 if remat == "full" else 1       # the recompute gathers again
    # gpt2's fused MLP gathers wi, wo and bi itself; the rest of a layer
    # is one flat gather, and the top leaves another
    gathers = GAS * (1 + layers * passes * (4 if fused else 1))
    for d in (1, 2, 3, 4):
        name = f"depth{d}"
        assert got[name]["fused"] == fused
        _same_bits(got[name], got["depth1"], name)
        _every_rank(ranks, name)
        for step in got[name]["steps"]:
            assert step["calls"]["all_gather"] == gathers, (name, step)
            assert step["calls"]["reduce_scatter"] == GAS * step["buckets"]
    assert got["depth1"]["losses"][-1] < got["depth1"]["losses"][0]


@pytest.mark.parametrize("where", ["data4", "data2xseq2"])
def test_depth2_matches_the_jax_engine(where):
    if where == "data4":
        model, kw, mesh = "gpt2-tiny", LAYERS, {"data": 4}
    else:
        model, kw, mesh = ("llama-tiny", {**RING, "ring_placement": "striped"},
                           MESH)
    cfg = _schedule(_zero3(mesh), gather_prefetch_depth=2)
    batch = _batch(CFG["train_micro_batch_size_per_gpu"] * GAS * mesh["data"])
    want = _jax_run(jax_model_config(model, **kw), cfg, batch)
    run = {"name": "run", "model": model, "model_kw": kw, "cfg": cfg,
           "params": params_from_jax(want["p0"], get_model_config(model, **kw),
                                     device="cpu"),
           "batch": batch, "steps": STEPS}
    ranks = launch(torch_schedule_ranks.schedule_runs, 4, args=([run],),
                   backend="gloo", device="cpu")
    assert ranks[0]["run"]["depth"] == 2
    _check(ranks[0]["run"], want)
    _every_rank(ranks, "run")


# ----------------------------------------------------------------------
# the stage-3 reducer's buckets
# ----------------------------------------------------------------------
def test_stage3_buckets_follow_the_plan():
    params = params_from_jax(jax.tree.map(np.asarray, _jax_init(
        "gpt2-tiny", LAYERS)), get_model_config("gpt2-tiny", **LAYERS),
        device="cpu")
    # a layer's gradients: its leaves' per-layer views, full size
    views = [int(np.prod(x.shape[1:])) for path, x in _paths(params)
             if path[0] == "layers"]
    sizes = {"default": 500_000_000, "one-layer": sum(views),
             "several-leaves": max(views) * 3 // 2, "per-leaf": 1}
    batch = _batch(CFG["train_micro_batch_size_per_gpu"] * GAS * 4)
    runs = []
    for name, size in sizes.items():
        cfg = _zero3({"data": 4})
        cfg["zero_optimization"]["reduce_bucket_size"] = size
        runs.append({"name": name, "model": "gpt2-tiny", "model_kw": LAYERS,
                     "params": params, "batch": batch, "steps": STEPS,
                     "cfg": _schedule(cfg, gather_prefetch_depth=2)})
    ranks = launch(torch_schedule_ranks.schedule_runs, 4, args=(runs,),
                   backend="gloo", device="cpu")
    got = ranks[0]
    counts = {}
    for name, size in sizes.items():
        _same_bits(got[name], got["default"], name)
        _every_rank(ranks, name)
        assert got[name]["scatter_buckets"] == 0      # nothing stays whole
        for step in got[name]["steps"]:
            arrived = step["arrived"]
            micro = arrived[:len(arrived) // GAS]
            assert arrived == micro * GAS
            plan = comm.plan_buckets(micro, size)
            planned = len(plan)
            assert step["buckets"] == planned, name
            assert step["calls"]["reduce_scatter"] == GAS * planned, name
            assert step["bucket_sizes"] == [
                sum(micro[i] for i in b) for b in plan] * GAS, name
        counts[name] = planned
    # every gathered leaf once a micro-step: 4 layers' leaves and the top
    gathered = len(micro)
    assert counts["per-leaf"] == gathered
    assert counts["default"] == 1 < counts["one-layer"] < \
        counts["several-leaves"] < gathered


def test_flat_gather_equals_the_per_tensor_gathers():
    """``comm.all_gather_bucket`` (mixed dtypes as bytes, a cast on the
    pack, dims 0, 1 and last) against one ``comm.all_gather`` a tensor, bit
    for bit, on 4 ranks."""
    ranks = launch(torch_schedule_ranks.gather_bucket_cases, 4,
                   backend="gloo", device="cpu")
    assert all(all(r) and len(r) == 5 for r in ranks), ranks


# ----------------------------------------------------------------------
# qwZ
# ----------------------------------------------------------------------
def test_qwz_trains_close_to_exact_and_fp8_trains():
    """The JAX tests' mirrors, in one launch of 4 ranks (the fp8 test's
    data 8 cut to 4): the legacy flag's int8 gather converges over five
    steps and its first loss is within 5 % of the exact run's; the fp8
    ``zero3_gather`` converges over four steps, every loss finite.  Asked
    for the fused gather-matmul too, the fp8 run keeps the unfused path
    with the JAX gate's reason."""
    kw = {"num_layers": 2}
    model = get_model_config("gpt2-tiny", **kw)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, model.vocab_size, (8, 17)).astype(np.int32)
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:].copy()}
    base = {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "mesh": {"data": 4}, "steps_per_print": 1000}
    runs = [{"name": f"qwz-{q}", "model": "gpt2-tiny", "model_kw": kw,
             "batch": batch, "steps": 5,
             "cfg": {**base, "zero_optimization": {
                 "stage": 3, "zero_quantized_weights": q}}}
            for q in (False, True)]
    runs.append({"name": "fp8", "model": "gpt2-tiny", "model_kw": kw,
                 "batch": batch, "steps": 4,
                 "cfg": {**base, "train_micro_batch_size_per_gpu": 2,
                         "zero_optimization": {"stage": 3},
                         "step_schedule": {"fused_gather_matmul": True},
                         "comm_quantization": {"enabled": True,
                                               "zero3_gather": "fp8"}}})
    ranks = launch(torch_schedule_ranks.schedule_runs, 4, args=(runs,),
                   backend="gloo", device="cpu")
    exact, qwz, fp8 = (ranks[0][n] for n in ("qwz-False", "qwz-True", "fp8"))
    assert tuple(qwz["qwz"]) == ("int8", 256)
    assert exact["qwz"] is None and tuple(fp8["qwz"]) == ("fp8", 256)
    assert qwz["losses"][-1] < qwz["losses"][0]
    assert abs(qwz["losses"][0] - exact["losses"][0]) / exact["losses"][0] \
        < 0.05
    assert qwz["losses"] != exact["losses"]
    assert all(np.isfinite(fp8["losses"])) and fp8["losses"][-1] < \
        fp8["losses"][0]
    assert not fp8["fused"] and any(
        "quantized zero3_gather (qwZ) already owns the gather" in w
        for w in fp8["warnings"]), fp8["warnings"]
    for name in ("qwz-True", "fp8"):
        _every_rank(ranks, name)


def test_qwz_int8_matches_the_jax_engine_with_straddling_blocks():
    """ZeRO-3 at ``{"data": 4}``, persistence 0: every gpt2-tiny leaf is
    split, ``layers/mlp/wo`` [L, 512, 128] on its last dim, 32 columns a
    rank of one 128-wide block.  The port (depth 1 and 2, the same bits)
    against the JAX qwZ engine: losses and grad norms within
    ``QWZ_RTOL``, the params as ``test_torch_mesh_engine.py`` holds them;
    and every all-gather of a step moves bytes, under a third of what an
    fp32 gather of the same leaves would (int8 payload, fp32 scales)."""
    cfg = _zero3({"data": 4}, zero_optimization={
        "zero_quantized_weights": True})
    batch = _batch(CFG["train_micro_batch_size_per_gpu"] * GAS * 4)
    want = _jax_run(jax_model_config("gpt2-tiny", **LAYERS), cfg, batch)
    params = params_from_jax(want["p0"], get_model_config("gpt2-tiny",
                                                          **LAYERS),
                             device="cpu")
    runs = [{"name": f"depth{d}", "model": "gpt2-tiny", "model_kw": LAYERS,
             "params": params, "batch": batch, "steps": STEPS,
             "cfg": _schedule(cfg, gather_prefetch_depth=d)} for d in (1, 2)]
    runs.append({"name": "fp32", "model": "gpt2-tiny", "model_kw": LAYERS,
                 "params": params, "batch": batch, "steps": 1,
                 "cfg": _zero3({"data": 4})})
    ranks = launch(torch_schedule_ranks.schedule_runs, 4, args=(runs,),
                   backend="gloo", device="cpu")
    got = ranks[0]
    assert tuple(got["depth1"]["qwz"]) == ("int8", 256)
    _check(got["depth1"], want, rtol=QWZ_RTOL)
    _same_bits(got["depth2"], got["depth1"], "depth2")
    _every_rank(ranks, "depth1")
    qwz_bytes = sum(n for _dt, n in got["depth1"]["steps"][0]["moved"])
    fp32_bytes = 4 * sum(n for _dt, n in got["fp32"]["steps"][0]["moved"])
    assert {dt for dt, _n in got["depth1"]["steps"][0]["moved"]} == \
        {"torch.uint8"}
    assert qwz_bytes < fp32_bytes / 3, (qwz_bytes, fp32_bytes)


# ----------------------------------------------------------------------
# the rest of zero.py
# ----------------------------------------------------------------------
def test_gathered_parameters_updated_and_gathered_update_match_jax():
    kw = {}
    p0 = jax.tree.map(np.asarray, _jax_init("gpt2-tiny", kw))

    def edit(full):
        full["embed"]["tokens"][0] = 1.5
        full["final_norm"] = {k: v * 2 for k, v in full["final_norm"].items()}
        return full

    jparams = jax.tree.map(jax.numpy.asarray, p0)
    ctx = jzero.GatheredParameters(jparams)
    with ctx as full:
        full["embed"]["tokens"][0] = 1.5
        for k in full["final_norm"]:
            full["final_norm"][k] = full["final_norm"][k] * 2
    want = jax.tree.map(np.asarray, ctx.updated)
    want_fn = jax.tree.map(np.asarray, jzero.gathered_update(jparams, edit))
    params = params_from_jax(p0, get_model_config("gpt2-tiny"), device="cpu")
    ranks = launch(torch_schedule_ranks.gathered_edits, 2,
                   args=(params, _zero3({"data": 2})), backend="gloo",
                   device="cpu")
    assert all(r["kept"] for r in ranks)
    for path, a in _paths(want):
        np.testing.assert_array_equal(_get(ranks[0]["updated"], path), a)
    for path, a in _paths(want_fn):
        np.testing.assert_array_equal(_get(ranks[0]["gathered_update"], path),
                                      a)


@pytest.mark.parametrize("kw", [
    {}, {"cpu_offload": False}, {"cpu_offload_params": True},
    {"num_gpus_per_node": 8, "num_nodes": 2, "cpu_offload": False}])
def test_memory_estimators_match_jax(kw):
    n = 350_000_000
    z3 = {k: v for k, v in kw.items()}
    z2 = {k: v for k, v in kw.items() if k != "cpu_offload_params"}
    assert zero.estimate_zero3_model_states_mem_needs(n, **z3) == \
        jzero.estimate_zero3_model_states_mem_needs(n, **z3)
    assert zero.estimate_zero2_model_states_mem_needs(n, **z2) == \
        jzero.estimate_zero2_model_states_mem_needs(n, **z2)


# ----------------------------------------------------------------------
# the keys
# ----------------------------------------------------------------------
def _config(**blocks):
    return {"train_micro_batch_size_per_gpu": 1, **blocks}


def test_schedule_and_qwz_keys_are_read_as_jax_reads_them():
    cfg = _config(step_schedule={"gather_prefetch_depth": 3,
                                 "prefetch_bucket_size": 1234},
                  zero_optimization={"stage": 3, "prefetch_bucket_size": 99,
                                     "zero_quantized_weights": True},
                  comm_quantization={"enabled": True, "zero3_gather": "FP8",
                                     "group_size": 64})
    mine, theirs = DeepSpeedConfig(cfg), JaxConfig(cfg)
    for block, key in (("step_schedule", "gather_prefetch_depth"),
                       ("step_schedule", "prefetch_bucket_size"),
                       ("zero_config", "prefetch_bucket_size"),
                       ("zero_config", "zero_quantized_weights"),
                       ("comm_quantization", "zero3_gather"),
                       ("comm_quantization", "group_size")):
        assert getattr(getattr(mine, block), key) == \
            getattr(getattr(theirs, block), key), key
    default = DeepSpeedConfig(_config())
    assert default.step_schedule.gather_prefetch_depth == 1
    assert default.step_schedule.prefetch_bucket_size is None
    assert default.zero_config.prefetch_bucket_size == \
        JaxConfig(_config()).zero_config.prefetch_bucket_size == 50_000_000


@pytest.mark.parametrize("block,match", [
    ({"gather_prefetch_depth": 0}, "gather_prefetch_depth must be >= 1"),
    ({"prefetch_bucket_size": 0}, "prefetch_bucket_size must be positive"),
    ({"prefetch_bucket_size": -5}, "prefetch_bucket_size must be positive"),
])
def test_schedule_keys_rejected_as_jax_does(block, match):
    with pytest.raises(JaxConfigError, match=match):
        JaxConfig(_config(step_schedule=block))
    with pytest.raises(DeepSpeedConfigError, match=match):
        DeepSpeedConfig(_config(step_schedule=block))


@pytest.mark.parametrize("zc", [
    {"stage": 1, "zero_quantized_gradients": True,
     "zero_hpz_partition_size": 2},
    {"stage": 3, "zero_hpz_partition_size": 2},
    {"stage": 3, "mics_shard_size": 2},
], ids=["qgz", "hpz", "mics"])
def test_the_rest_of_zeropp_still_raises(zc):
    """The hierarchical keys are accepted as the JAX config accepts them
    (``test_torch_zeropp_hier.py`` trains them); what still raises is the
    JAX engine's ``ValueError`` for a data world the shard size does not
    divide (data 1 here), with its message."""
    cfg = _config(zero_optimization=zc)
    assert DeepSpeedConfig(cfg).zero_config.stage == \
        JaxConfig(cfg).zero_config.stage
    want = ""
    try:
        dsj.initialize(model=jax_model_config("gpt2-tiny"),
                       config={**cfg, "mesh": {"data": 1}})
    except ValueError as e:
        want = str(e)
    finally:
        jtopology.set_topology(None)
    assert "not divisible by secondary partition size 2" in want, want
    with pytest.raises(ValueError, match=want):
        dst.initialize(model=get_model_config("gpt2-tiny"), config=cfg,
                       device="cpu")
