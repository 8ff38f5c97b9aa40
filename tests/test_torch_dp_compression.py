"""The port's quantized data-parallel gradient reduction against the JAX
package on the CPU: the quantized collectives (``comm/quantized.py``),
qgZ (``comm/coalesced_collectives.py``), the 1-bit all-reduce
(``comm/compressed.py``), the 1-bit/qgZ step (``runtime/onebit.py``) and
the engine's reduction modes (``comm_quantization.grad_reduce``,
``step_schedule.weight_update: "decomposed"``, ``fused_reduce_scatter``).

The collectives run in 2 or 4 spawned gloo CPU ranks (rank bodies in
``torch_dp_ranks.py``) and the JAX functions under ``shard_map`` on a CPU
mesh of as many devices, on the same numpy inputs:

* the fp32 wire bit for bit;
* int8 and fp8 within ULP_BOUND of the JAX result (a few fp32 ulps of the
  block's largest value): XLA compiles the JAX int8 scale ``absmax / 127``
  as a multiply by fp32(1/127), where the port's ``quantize`` kernel and its
  plain version divide (one ulp apart in ~3 % of blocks), and XLA's CPU
  code contracts the decode and the residual ``c - q·s`` into fused
  multiply-adds (one rounding where the port rounds twice), so even fp8,
  whose scale both round alike, differs in the last bits.  A payload that
  lands one step apart (an element on a rounding boundary of the wire) is
  allowed within one quantization step of its block, for at most
  STEP_SHARE of the elements;
* qgZ at one level, LoCo and the 1-bit all-reduce (both error states) at
  the same bounds (the 1-bit scale mean|c| sums in another order: 1e-6
  relative).

The engine trains gpt2-tiny in 2 gloo ranks (``{"mesh": {"data": 2}}``) from
the JAX engine's initial params against the JAX engine on a ``{"data": 2}``
CPU mesh, three steps, for each mode: ``grad_reduce`` int8 with and
without error feedback, fp8 and fp32 spelled out, qgZ, the three 1-bit
variants (warm-up, then two compressed steps), the decomposed update and
the fused reduce-scatter: losses to 1e-5 relative and params as
``test_torch_zero_engine.py`` holds them.  Then the JAX engine's gates with
its warnings, the data-1 fallbacks, and the mirrors of
``tests/test_onebit.py`` and of ``tests/test_quantized_comm.py``'s reduce
cases that need no hpZ.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import deepspeed_tpu as dsj
import deepspeed_tpu_torch as dst
from deepspeed_tpu.comm import coalesced_collectives as jcc
from deepspeed_tpu.comm import compressed as jc
from deepspeed_tpu.comm import quantized as jq
from deepspeed_tpu.models import get_model_config as jax_model_config
from deepspeed_tpu.parallel import topology as jtopology
from deepspeed_tpu.utils.jax_compat import shard_map
from deepspeed_tpu_torch.comm import compressed as tc
from deepspeed_tpu_torch.comm import quantized as tq
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.models import get_model_config
from deepspeed_tpu_torch.models.bridge import params_from_jax
from deepspeed_tpu_torch.runtime.onebit import OnebitConfig, OnebitTrainStep
from deepspeed_tpu_torch.parallel.topology import MeshTopology

import torch_dp_ranks
from test_torch_engine_v2 import one_torch_thread  # noqa: F401

# a few fp32 ulps of a block's largest value (2^-23 relative each)
ULP_BOUND = 2.0 ** -20
# elements allowed one wire step apart (a rounding boundary of the wire)
STEP_SHARE = 1e-3
QMAX = {"int8": 127.0, "fp8": 8.0}     # fp8: a step is |x| / 8 at most


def _mesh(world, names=("data",)):
    devs = np.array(jax.devices()[:world])
    if len(names) == 2:
        devs = devs.reshape(1, world)
    return Mesh(devs, names)


def _per_rank(fn, world, *xs, nout=1, names=("data",)):
    """``fn`` per rank over [world, ...] stacks of rank-local buffers."""
    spec = P(names if len(names) > 1 else names[0])
    outs = tuple([spec] * nout) if nout > 1 else spec
    mapped = shard_map(fn, mesh=_mesh(world, names),
                       in_specs=tuple([spec] * len(xs)), out_specs=outs,
                       check_vma=False)
    res = jax.jit(mapped)(*[jnp.asarray(x) for x in xs])
    return [np.asarray(r) for r in res] if nout > 1 else np.asarray(res)


def _inputs(world, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((world, n)) * rng.uniform(1e-3, 10, (world, 1))
    r = rng.standard_normal((world, n)) * 1e-3
    return x.astype(np.float32), r.astype(np.float32)


def _close(got, want, wire, block, ref):
    """The port's ``got`` against JAX's ``want`` ([..., n], blocks of
    ``block`` along the last dim), ``ref`` the magnitudes the wire
    quantized at each position (broadcast to ``want``: the largest |input|
    over the ranks that sent it): bit for bit on the fp32 wire; else every
    element within ULP_BOUND of its block's largest magnitude, but for at
    most STEP_SHARE of them, which stay within one step of the wire."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if wire == "fp32":
        np.testing.assert_array_equal(got, want)
        return
    d = np.abs(got - want).reshape(-1, block)
    mag = np.maximum(np.abs(want), np.broadcast_to(np.abs(ref), want.shape))
    big = mag.reshape(-1, block).max(axis=-1, keepdims=True)
    far = d > ULP_BOUND * big
    assert far.mean() <= STEP_SHARE, (far.mean(), d.max())
    assert (d <= big / QMAX[wire] * 1.01).all(), d.max()


def _sent(x, world, op):
    """The magnitudes behind each output element of a reduce-scatter
    (rank r: chunk r) or all-reduce (every rank: all) of ``x`` [world, n]:
    the largest |x| over the sending ranks."""
    top = np.abs(x).max(axis=0)
    return top.reshape(world, -1) if op == "rs" else top[None, :]


# ----------------------------------------------------------------------
# the collectives against JAX
# ----------------------------------------------------------------------
def _jax_collective(op, x, r, world, wire, gs, steps=1):
    fn = jq.quantized_reduce_scatter if op == "rs" else jq.quantized_all_reduce
    if r is None:
        return _per_rank(lambda a: fn(a.reshape(-1), "data", world,
                                      wire_dtype=wire, group_size=gs)[0][None],
                         world, x), None

    def body(a, res):
        a, res = a.reshape(-1), res.reshape(-1)
        outs = []
        for _ in range(steps):
            o, res = fn(a, "data", world, wire_dtype=wire, group_size=gs,
                        residual=res)
            outs.append(o)
        return jnp.stack(outs)[None], res[None]

    mapped = shard_map(body, mesh=_mesh(world),
                       in_specs=(P("data"), P("data")),
                       out_specs=(P("data"), P("data")), check_vma=False)
    o, res = jax.jit(mapped)(jnp.asarray(x), jnp.asarray(r))
    return np.asarray(o), np.asarray(res)


@pytest.mark.parametrize("world", [2, 4])
def test_quantized_collectives_match_jax(world):
    """quantized_reduce_scatter and quantized_all_reduce, fp32/int8/fp8,
    groups of 256 and 64 (a group the JAX package's kernel does not take:
    its jnp path, and the port's kernel), without and with a residual fed
    back over 3 calls:
    outputs and residuals against the JAX functions (module docstring)."""
    n = world * 1024
    x, r = _inputs(world, n, seed=world)
    cases = []
    for wire in ("fp32", "int8", "fp8"):
        for op in ("rs", "ar"):
            for gs in (256, 64):
                cases.append({"op": op, "x": x, "wire": wire,
                              "group_size": gs, "residual": None})
            cases.append({"op": op, "x": x, "wire": wire, "group_size": 256,
                          "residual": r, "steps": 3})
    got = launch(torch_dp_ranks.collectives, world, args=(cases,),
                 backend="gloo", device="cpu")
    for i, c in enumerate(cases):
        steps = c.get("steps", 1)
        want, want_res = _jax_collective(c["op"], x, c["residual"], world,
                                         c["wire"], c["group_size"], steps)
        mine = np.stack([g[i]["out"] for g in got])
        gs = c["group_size"]
        src = x if c["residual"] is None else x + r
        ref = _sent(src, world, c["op"])
        if steps > 1:
            ref = ref[:, None]
        _close(mine.reshape(want.shape), want, c["wire"], gs, ref)
        if c["residual"] is None:
            assert all(g[i]["residual"] is None for g in got)
            continue
        res = np.stack([g[i]["residual"] for g in got])
        if c["wire"] == "fp32":
            assert np.abs(res).max() == 0.0
        _close(res, want_res, c["wire"], gs, src)
    # the wire's bytes, payload and scales, under the JAX op names
    for i, c in enumerate(cases):
        nb = got[0][i]["nbytes"]
        if c["group_size"] != 256 or c.get("steps", 1) != 1:
            continue
        payload = n if c["wire"] != "fp32" else 4 * n
        scales = 4 * n // 256 if c["wire"] != "fp32" else 0
        assert nb["quant_reduce_scatter"] == payload + scales, (c, nb)
        if c["op"] == "ar":
            assert nb["quant_all_gather"] == (payload + scales) // world
        else:
            assert "quant_all_gather" not in nb
    assert set(tq.QUANT_COMM_OPS) == set(jq.QUANT_COMM_OPS)


@pytest.mark.parametrize("world", [2, 4])
def test_qgz_loco_and_onebit_allreduce_match_jax(world):
    """One-level qgZ (``all_to_all_quant_reduce``, groups 256 and 2048,
    and 2048 over a 12-element chunk, which becomes one whole-chunk
    group), LoCo (``loco_quant_reduce``: shard and new error) and the
    1-bit ``compressed_allreduce`` (and ``CompressedBackend``'s) with
    nonzero worker and server errors, chunks of a length 8 does not
    divide, against the JAX functions.  qgZ's wire is recorded under
    ``quant_reduce_scatter``, payload and scales."""
    n = world * 4096
    x, r = _inputs(world, n, seed=10 + world)
    m_odd = 12
    xc, _ = _inputs(world, world * m_odd, seed=20 + world)
    werr = (np.random.default_rng(1).standard_normal(xc.shape) * 0.1
            ).astype(np.float32)
    serr = (np.random.default_rng(2).standard_normal((world, m_odd)) * 0.1
            ).astype(np.float32)
    cases = [{"op": "qgz", "x": x, "group_size": 256},
             {"op": "qgz", "x": x, "group_size": 2048},
             {"op": "loco", "x": x, "err": r, "group_size": 256},
             {"op": "compressed", "x": xc, "werr": werr, "serr": serr},
             {"op": "qgz", "x": xc, "group_size": 2048}]
    got = launch(torch_dp_ranks.collectives, world, args=(cases,),
                 backend="gloo", device="cpu")
    names = ("outer", "inner")
    for i, gs in ((0, 256), (1, 2048)):
        want = _per_rank(lambda a, gs=gs: jcc.all_to_all_quant_reduce(
            {"g": a.reshape(-1)}, "inner", "outer", world, 1,
            group_size=gs)[0][None], world, x[:, None], names=names)
        _close(np.stack([g[i]["out"] for g in got]), want.reshape(world, -1),
               "int8", min(gs, n // world), _sent(x, world, "rs"))
    shard, err = _per_rank(lambda a, e: (lambda s, _m, ne: (
        s[None], ne["g"][None]))(*jcc.loco_quant_reduce(
            {"g": a.reshape(-1)}, {"g": e.reshape(-1)}, "inner", "outer",
            world, 1)), world, x[:, None], r[:, None], nout=2, names=names)
    _close(np.stack([g[2]["out"] for g in got]), shard.reshape(world, -1),
           "int8", 256, _sent(x + r, world, "rs"))
    _close(np.stack([g[2]["err"] for g in got]), err.reshape(world, -1),
           "int8", 256, x + r)
    out, we, se = _per_rank(lambda a, w, s: tuple(
        v[None] for v in jc.compressed_allreduce(
            a.reshape(-1), w.reshape(-1), s.reshape(-1), "data", world)),
        world, xc, werr, serr, nout=3)
    for key, want in (("out", out), ("werr", we), ("serr", se)):
        mine = np.stack([g[3][key] for g in got]).reshape(want.shape)
        np.testing.assert_allclose(mine, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    # every rank holds the same average
    for g in got[1:]:
        np.testing.assert_array_equal(g[3]["out"], got[0][3]["out"])
    assert all(g[3]["backend"] == (world, [True] * 3) for g in got)
    want = _per_rank(lambda a: jcc.all_to_all_quant_reduce(
        {"g": a.reshape(-1)}, "inner", "outer", world, 1,
        group_size=2048)[0][None], world, xc[:, None], names=names)
    _close(np.stack([g[4]["out"] for g in got]), want.reshape(world, -1),
           "int8", m_odd, _sent(xc, world, "rs"))
    for i, chunk, gs in ((0, n // world, 256), (1, n // world, 2048),
                         (4, m_odd, m_odd)):
        assert got[0][i]["nbytes"]["quant_reduce_scatter"] == \
            world * chunk + 4 * world * (chunk // gs), got[0][i]["nbytes"]


def test_all_to_all_moves_every_dtype():
    """``comm.all_to_all``: block j of rank i lands as block i of rank j,
    bit for bit, for int8, uint8 and fp32."""
    world = 2
    rng = np.random.default_rng(3)
    arrays = [rng.integers(-128, 128, (world, 4, 6)).astype(np.int8),
              rng.integers(0, 256, (world, 10)).astype(np.uint8),
              rng.standard_normal((world, 2, 3)).astype(np.float32)]
    cases = [{"op": "a2a", "x": np.stack([a * 0 + a for _ in range(world)])}
             for a in arrays]
    # rank r sends its own x[r]; make each rank's distinct
    for c in cases:
        c["x"] = np.stack([c["x"][r] + np.asarray(r, c["x"].dtype)
                           for r in range(world)])
    got = launch(torch_dp_ranks.collectives, world, args=(cases,),
                 backend="gloo", device="cpu")
    for i, c in enumerate(cases):
        blk = c["x"].shape[1] // world
        for dst_rank in range(world):
            mine = got[dst_rank][i]["out"]
            assert mine.dtype == c["x"].dtype
            want = np.concatenate([c["x"][src][dst_rank * blk:
                                              (dst_rank + 1) * blk]
                                   for src in range(world)])
            np.testing.assert_array_equal(mine, want)
        assert got[0][i]["nbytes"]["all_to_all"] == c["x"][0].nbytes


def test_coalesced_reduce_scatter_and_gather_match_jax():
    """``reduce_scatter_coalesced`` of a two-leaf tree over 2 ranks (JAX
    tree order, padded to the world) against the JAX function under
    ``shard_map``, bit for bit (a sum of two), and
    ``all_gather_coalesced`` back to the tree: the sum of the ranks'
    leaves."""
    world, n = 2, 5 + 3 * 7
    x = np.random.default_rng(6).standard_normal((world, n)).astype(np.float32)
    got = launch(torch_dp_ranks.collectives, world,
                 args=([{"op": "coalesced", "x": x}],), backend="gloo",
                 device="cpu")
    def body(a):
        v = a.reshape(-1)
        return jcc.reduce_scatter_coalesced(
            {"b": v[:5], "a": {"w": v[5:].reshape(-1, 3)}}, "data",
            world)[0][None]

    want = _per_rank(body, world, x)
    np.testing.assert_array_equal(
        np.stack([g[0]["out"] for g in got]), want.reshape(world, -1))
    total = x.sum(0)
    for g in got:
        np.testing.assert_array_equal(g[0]["b"], total[:5])
        np.testing.assert_array_equal(g[0]["w"], total[5:].reshape(-1, 3))


@pytest.mark.parametrize("n", [13, 8, 1, 24, 100])
def test_pack_signs_pads_internally_like_jax(n):
    """The JAX test's lengths: packed bytes bit for bit with JAX, the true
    length restored after unpacking."""
    bits = np.random.default_rng(n).integers(0, 2, size=(3, n)).astype(np.uint8)
    packed = tc.pack_signs(torch.tensor(bits))
    assert packed.shape[-1] == -(-n // 8)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jc.pack_signs(jnp.asarray(bits))))
    np.testing.assert_array_equal(tc.unpack_signs(packed)[..., :n].numpy(),
                                  bits)


def test_compress_roundtrip_arbitrary_length():
    """``_compress``/``_decompress`` keep the sign pattern and the L1 scale
    at lengths 8 does not divide (the JAX test's)."""
    rng = np.random.default_rng(4)
    for n in (13, 21, 64):
        x = rng.standard_normal((2, n)).astype(np.float32)
        bits, scale = tc._compress(torch.tensor(x))
        back = tc._decompress(bits, scale, n).numpy()
        assert back.shape == (2, n)
        np.testing.assert_array_equal(np.sign(back), np.where(x >= 0, 1.0, -1.0))
        np.testing.assert_allclose(np.abs(back).max(-1),
                                   np.abs(x).mean(-1), rtol=1e-6)


# ----------------------------------------------------------------------
# mirrors of tests/test_quantized_comm.py's reduce cases (port only)
# ----------------------------------------------------------------------
def test_reduce_scatter_all_reduce_and_error_feedback_bounds():
    """At 4 ranks: the all-reduce's slice r equals rank r's reduce-scatter
    chunk (fp32 exactly; int8 within one step of the chunk's blocks, the
    gather's requantization); the all-reduce within 1e-6 (fp32), 3 %
    (int8) and 10 % (fp8) of the exact mean, relative to its largest
    value; with a constant input and error feedback the 8-step average's
    error is under half the first step's and the residual stays within two
    first-send steps; the fp32 wire's residual is zero."""
    world, n = 4, 4 * 512
    rng = np.random.default_rng(0)
    x = rng.standard_normal((world, n)).astype(np.float32)
    cases = []
    for wire in ("fp32", "int8"):
        cases += [{"op": "rs", "x": x, "wire": wire, "group_size": 64},
                  {"op": "ar", "x": x, "wire": wire, "group_size": 64}]
    for wire in ("fp32", "int8", "fp8"):
        cases.append({"op": "ar", "x": x, "wire": wire, "group_size": 256})
    zero = np.zeros_like(x)
    cases.append({"op": "ar", "x": x, "wire": "int8", "group_size": 64,
                  "residual": zero, "steps": 8})
    cases.append({"op": "ar", "x": x, "wire": "fp32", "group_size": 256,
                  "residual": zero})
    got = launch(torch_dp_ranks.collectives, world, args=(cases,),
                 backend="gloo", device="cpu")
    ref = x.mean(0)
    m = n // world
    for k, wire in enumerate(("fp32", "int8")):
        shards = np.concatenate([g[2 * k]["out"][0] for g in got])
        for g in got:
            full = g[2 * k + 1]["out"][0]
            if wire == "fp32":
                np.testing.assert_array_equal(full, shards)
            else:
                blocks = shards.reshape(world, m // 64, 64)
                tol = np.abs(blocks).max(-1, keepdims=True) / 127.0 + 1e-7
                assert (np.abs(full - shards).reshape(world, m // 64, 64)
                        <= tol).all()
    for k, (wire, bound) in enumerate((("fp32", 1e-6), ("int8", 0.03),
                                       ("fp8", 0.10))):
        out = got[0][4 + k]["out"][0]
        assert np.abs(out - ref).max() / np.abs(ref).max() <= bound, wire
    outs = got[0][7]["out"]
    err1 = np.abs(outs[0] - ref).mean()
    err_avg = np.abs(outs.mean(0) - ref).mean()
    assert err_avg < err1 / 2, (err_avg, err1)
    step = np.abs(x[0].reshape(world, -1, 64)).max(-1).max() / 127.0
    assert np.abs(got[0][7]["residual"]).max() <= 2 * step + 1e-6
    assert np.abs(got[0][8]["residual"]).max() == 0.0


def test_qgz_and_compressed_numerics_bounds():
    """One-level qgZ within 5 % of the exact mean (relative to its largest
    value; the JAX bound of two cascaded levels); the 1-bit all-reduce at
    chunks of 12 elements (8 does not divide them) finite, the same on
    every rank and correlated with the mean above 0.3 (the JAX test's)."""
    world, n = 4, 4 * 512
    rng = np.random.default_rng(1)
    x = rng.standard_normal((world, n)).astype(np.float32)
    xc = rng.standard_normal((world, world * 12)).astype(np.float32)
    cases = [{"op": "qgz", "x": x, "group_size": 256},
             {"op": "compressed", "x": xc, "werr": np.zeros_like(xc),
              "serr": np.zeros((world, 12), np.float32)}]
    got = launch(torch_dp_ranks.collectives, world, args=(cases,),
                 backend="gloo", device="cpu")
    recon = np.concatenate([g[0]["out"] for g in got])
    ref = x.mean(0)
    assert np.abs(recon - ref).max() / np.abs(ref).max() <= 0.05
    out = np.stack([g[1]["out"] for g in got])
    assert np.isfinite(out).all() and (out == out[0]).all()
    assert np.corrcoef(out[0], xc.mean(0))[0, 1] > 0.3


# ----------------------------------------------------------------------
# the engine against the JAX engine
# ----------------------------------------------------------------------
LR = 2e-3
CFG = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
       "optimizer": {"type": "AdamW", "params": {"lr": LR,
                                                 "weight_decay": 0.1}},
       "gradient_clipping": 1.0, "steps_per_print": 10_000,
       "activation_checkpointing": {"remat_policy": "none"},
       "mesh": {"data": 2}}
STEPS = 3
SEQ = 32
# The key bias shifts every score of a query by the same q·bk, which the
# softmax cancels: its gradient is zero up to rounding, and AdamW's update
# of it is that rounding noise normalised (two engines agree on it only
# elementwise, within lr).
NO_GRADIENT = {("layers", "attn", "bk")}


def _onebit(name, **params):
    return {"optimizer": {"type": name, "params": {
        "lr": LR, "freeze_step": 1, "weight_decay": 0.1, **params}}}


# mode -> (config keys, ZeRO stage).  The 1-bit variants switch to the
# compressed step after step 1, so steps 2-3 run it.
# The params' relative L2 bound on each leaf's update: 1e-3 (the other
# engine tests'), and INT8_UPDATE_RTOL for the int8 wires (grad_reduce
# int8, qgZ): there the JAX scale is one ulp off the port's in ~3 % of the
# blocks (module docstring), which moves every decoded element of such a
# block by an ulp, and three AdamW steps amplify that on the small-gradient
# biases (seen: 1.36e-3 on the attention output bias).
INT8_UPDATE_RTOL = 5e-3
ENGINE_MODES = {
    "int8-ef": ({"comm_quantization": {"enabled": True,
                                       "grad_reduce": "int8"}}, 1),
    "int8-no-ef": ({"comm_quantization": {"enabled": True,
                                          "grad_reduce": "int8",
                                          "error_feedback": False}}, 2),
    "fp8": ({"comm_quantization": {"enabled": True, "grad_reduce": "fp8"}},
            1),
    "fp32-explicit": ({"comm_quantization": {"enabled": True,
                                             "grad_reduce": "fp32"}}, 2),
    "qgz": ({"zero_optimization": {"zero_quantized_gradients": True}}, 1),
    "onebitadam": (_onebit("OnebitAdam"), 0),
    "onebitlamb": (_onebit("OnebitLamb"), 0),
    "zerooneadam": (_onebit("ZeroOneAdam", var_freeze_step=1), 0),
    "decomposed": ({"step_schedule": {"weight_update": "decomposed"}}, 0),
    "decomposed-fused-rs": ({"step_schedule": {
        "weight_update": "decomposed", "fused_reduce_scatter": True}}, 1),
}


def _batch(rows, seed=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (rows, SEQ + 1)).astype(np.int32)
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:].copy()}
    batch["labels"][0, :5] = -100     # the ranks' token counts differ
    return batch


def _mode_cfg(mode):
    extra, stage = ENGINE_MODES[mode]
    zc = {"stage": stage, **extra.get("zero_optimization", {})}
    return {**CFG, **{k: v for k, v in extra.items()
                      if k != "zero_optimization"},
            "zero_optimization": zc}


def _jax_engine(cfg, batch, steps=STEPS):
    try:
        eng, *_ = dsj.initialize(model=jax_model_config("gpt2-tiny"), seed=5,
                                 config=cfg)
        p0 = jax.tree.map(np.asarray, eng.params)
        losses = [float(np.asarray(eng.train_batch(batch)))
                  for _ in range(steps)]
        modes = {"comm_quant": eng._comm_quant is not None,
                 "onebit": None if eng._onebit is None
                 else eng._onebit.cfg.variant,
                 "decomposed": eng._decomposed_update,
                 "fused_rs": eng._fused_rs}
        return p0, losses, jax.tree.map(np.asarray, eng.params), modes
    finally:
        jtopology.set_topology(None)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_engine_modes_match_the_jax_data_mesh(mode):
    """gpt2-tiny over 2 gloo ranks against the JAX engine on a
    ``{"data": 2}`` CPU mesh, three steps: the gates choose the same mode,
    the losses match to 1e-5 relative, each leaf's params after the steps
    within 1e-3 relative L2 of the JAX engine's update (INT8_UPDATE_RTOL on
    the int8 wires; the key bias, NO_GRADIENT, elementwise only) and every
    element within lr of it, both ranks end with the same params, and the
    loss falls.  (Seen: losses within 4e-7.)"""
    cfg = _mode_cfg(mode)
    batch = _batch(CFG["gradient_accumulation_steps"]
                   * CFG["train_micro_batch_size_per_gpu"] * 2)
    p0, losses, params, jmodes = _jax_engine(cfg, batch)
    run = {"name": mode, "model": "gpt2-tiny",
           "params": params_from_jax(p0, get_model_config("gpt2-tiny"),
                                     device="cpu"),
           "cfg": cfg, "batch": batch, "steps": STEPS}
    ranks = launch(torch_dp_ranks.engine_runs, 2, args=([run],),
                   backend="gloo", device="cpu")
    got = ranks[0][mode]
    mine = {k: got["modes"][k] for k in jmodes}
    assert mine == jmodes, (mine, jmodes)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    assert got["losses"][-1] < got["losses"][0]
    assert ranks[1][mode]["losses"] == got["losses"]
    assert ranks[1][mode]["checksum"] == got["checksum"]
    bound = INT8_UPDATE_RTOL if mode in ("int8-ef", "int8-no-ef", "qgz") \
        else 1e-3
    for path, a in _paths(params):
        mine = _get(got["params"], path)
        if path not in NO_GRADIENT:
            update = a - _get(p0, path)
            assert np.linalg.norm(mine - a) <= bound * np.linalg.norm(update), \
                (path, np.linalg.norm(mine - a) / np.linalg.norm(update))
        assert np.abs(mine - a).max() <= LR, path
    if mode == "int8-ef":
        assert got["modes"]["residual"]
        # one quantized all-reduce a step: payload + scales of the padded
        # buffer on the reduce-scatter, a half of it on the all-gather
        nb = got["nbytes"]
        assert nb["quant_all_gather"] * 2 == nb["quant_reduce_scatter"]
    if mode in ("int8-no-ef", "fp32-explicit"):
        assert not got["modes"]["residual"]
    if mode.startswith("decomposed"):
        assert got["modes"]["scatter_buckets"] >= 1


def test_int8_wire_moves_fewer_bytes_than_the_fp32_control():
    """The JAX commquant acceptance check's byte reduction (>= 3×) between
    the explicit fp32 wire and the int8 wire, from ``comm.nbytes()``
    (exactly 4 / (1 + 4 / 256) for groups of 256), over 2 ranks."""
    batch = _batch(8)
    runs = [{"name": m, "model": "gpt2-tiny", "cfg": _mode_cfg(m),
             "batch": batch, "steps": 1}
            for m in ("fp32-explicit", "int8-ef")]
    ranks = launch(torch_dp_ranks.engine_runs, 2, args=(runs,),
                   backend="gloo", device="cpu")
    total = {m: sum(ranks[0][m]["nbytes"][op] for op in tq.QUANT_COMM_OPS)
             for m in ("fp32-explicit", "int8-ef")}
    ratio = total["fp32-explicit"] / total["int8-ef"]
    assert ratio == pytest.approx(4 / (1 + 4 / 256), rel=1e-9), ratio


# ----------------------------------------------------------------------
# gates and fallbacks, with the JAX engine's warnings
# ----------------------------------------------------------------------
def _jax_warnings(cfg, monkeypatch, **model_kw):
    from deepspeed_tpu.runtime import engine as jengine
    from deepspeed_tpu.runtime import optimizers as jopt

    seen = []
    for mod in (jengine, jopt):
        monkeypatch.setattr(mod.logger, "warning",
                            lambda msg, *a, **k: seen.append(str(msg)))
    try:
        eng, *_ = dsj.initialize(model=jax_model_config("gpt2-tiny",
                                                        **model_kw),
                                 seed=0, config=cfg)
    finally:
        jtopology.set_topology(None)
    return eng, seen


def _port_warnings(cfg, monkeypatch):
    from deepspeed_tpu_torch.runtime import engine as tengine
    from deepspeed_tpu_torch.runtime import optimizers as topt

    seen = []
    for mod in (tengine, topt):
        monkeypatch.setattr(mod.logger, "warning",
                            lambda msg, *a, **k: seen.append(str(msg)))
    eng, *_ = dst.initialize(model=get_model_config("gpt2-tiny"),
                             config=cfg, device="cpu")
    return eng, seen


@pytest.mark.parametrize("extra,reason", [
    ({"comm_quantization": {"enabled": True, "grad_reduce": "int8"}},
     "comm_quantization.grad_reduce: unsupported with this configuration "
     "(needs a >1 data-parallel mesh without TP/PP/SP, ZeRO stage <= 2"),
    ({"optimizer": {"type": "OnebitAdam", "params": {"lr": 1e-3}}},
     "onebitadam: using uncompressed"),
    ({"optimizer": {"type": "ZeroOneAdam", "params": {"lr": 1e-3}}},
     "zerooneadam: using uncompressed"),
    ({"step_schedule": {"weight_update": "decomposed"}},
     "step_schedule.weight_update='decomposed': unsupported with this "
     "configuration (no >1 ZeRO axis)"),
    ({"zero_optimization": {"stage": 1, "zero_quantized_gradients": True}},
     None),
], ids=["grad-reduce", "onebitadam", "zerooneadam", "decomposed", "qgz"])
def test_data_one_falls_back_as_jax_does(extra, reason, monkeypatch):
    """At data 1 the JAX engine keeps its plain step: no explicit reduce,
    no 1-bit step (the factory's AdamW, with its warning), no decomposed
    update; both engines warn alike (qgZ silently), and the port trains."""
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 1,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "mesh": {"data": 1}, "steps_per_print": 10_000, **extra}
    jeng, jwarn = _jax_warnings(cfg, monkeypatch)
    eng, warned = _port_warnings(cfg, monkeypatch)
    assert jeng._comm_quant is None and jeng._onebit is None
    assert not jeng._decomposed_update
    assert eng._comm_quant is None and eng._onebit is None
    assert not eng._decomposed
    for seen in (jwarn, warned):
        if reason is None:
            assert not any("zero_quantized" in w or "qgZ" in w for w in seen)
        else:
            assert any(w.startswith(reason) for w in seen), (reason, seen)
    batch = _batch(2)
    losses = [float(eng.train_batch(batch)) for _ in range(3)]
    assert losses[-1] < losses[0]


# the gates above one rank: config -> the JAX reason the port gives
GATES = {
    "grad-reduce-stage3": ({"zero_optimization": {"stage": 3},
                            "comm_quantization": {"enabled": True,
                                                  "grad_reduce": "int8"}},
                           "comm_quantization.grad_reduce: unsupported"),
    "grad-reduce-onebit": ({**_onebit("OnebitAdam"),
                            "comm_quantization": {"enabled": True,
                                                  "grad_reduce": "int8"}},
                           "comm_quantization.grad_reduce: unsupported"),
    "decomposed-onebit": ({**_onebit("OnebitLamb"), "step_schedule": {
        "weight_update": "decomposed"}}, "(1-bit optimizer)"),
    "decomposed-qgz": ({"zero_optimization": {
        "stage": 1, "zero_quantized_gradients": True},
        "step_schedule": {"weight_update": "decomposed"}},
        "(qgZ compressed gradients)"),
    "fused-rs-alone": ({"step_schedule": {"fused_reduce_scatter": True}},
                       "(requires weight_update='decomposed')"),
    "fused-rs-stage2": ({"zero_optimization": {"stage": 2}, "step_schedule": {
        "weight_update": "decomposed", "fused_reduce_scatter": True}},
        "(requires ZeRO stage <= 1"),
    "fused-rs-commq": ({"comm_quantization": {"enabled": True,
                                              "grad_reduce": "int8"},
                        "step_schedule": {"weight_update": "decomposed",
                                          "fused_reduce_scatter": True}},
                       "(comm_quantization grad reduce already owns the wire)"),
    "qgz-stage2": ({"zero_optimization": {"stage": 2,
                                          "zero_quantized_gradients": True}},
                   None),
    # over a seq axis (a ring model): the quantized reduce refused, the
    # decomposed update split over the seq world
    "grad-reduce-seq": ({"mesh": {"data": 1, "seq": 2},
                         "comm_quantization": {"enabled": True,
                                               "grad_reduce": "int8"}},
                        "comm_quantization.grad_reduce: unsupported"),
    "decomposed-seq": ({"mesh": {"data": 1, "seq": 2},
                        "step_schedule": {"weight_update": "decomposed"}},
                       None),
}


def test_gates_over_two_ranks_refuse_as_jax_does(monkeypatch):
    """Each refused configuration over two ranks (``{"data": 2}``, or a
    ring model over ``{"seq": 2}``): the JAX engine and the port keep the
    same mode (qgZ at stage 2 silently ignored and the decomposed update
    over a seq axis taken, as in JAX) and warn the JAX reason; every run
    trains one step."""
    runs, want = [], {}
    for name, (extra, reason) in GATES.items():
        cfg = {**CFG, **extra}
        seq = cfg["mesh"].get("seq", 1) > 1
        model_kw = {"seq_impl": "ring"} if seq else {}
        jeng, jwarn = _jax_warnings(cfg, monkeypatch, **model_kw)
        want[name] = {"comm_quant": jeng._comm_quant is not None,
                      "onebit": None if jeng._onebit is None
                      else jeng._onebit.cfg.variant,
                      "decomposed": jeng._decomposed_update,
                      "fused_rs": jeng._fused_rs}
        if reason is not None:
            assert any(reason in w for w in jwarn), (name, jwarn)
        runs.append({"name": name, "model": "gpt2-tiny", "cfg": cfg,
                     "model_kw": model_kw, "batch": _batch(4 if seq else 8),
                     "steps": 1})
    ranks = launch(torch_dp_ranks.engine_runs, 2, args=(runs,),
                   backend="gloo", device="cpu")
    for name, (_extra, reason) in GATES.items():
        got = ranks[0][name]
        assert {k: got["modes"][k] for k in want[name]} == want[name], name
        if reason is not None:
            assert any(reason in w for w in got["warnings"]), \
                (name, got["warnings"])
        assert np.isfinite(got["losses"]).all()


def test_hpz_mics_and_nontrainable_weights_still_raise(monkeypatch):
    """The keys are accepted as the JAX config accepts them (the flags
    nothing reads are logged as ignored); hpZ and MiCS over a data world
    their shard size does not divide still raise, the JAX engine's
    ``ValueError``."""
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    from deepspeed_tpu_torch.runtime import config as tconfig
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    seen = []
    monkeypatch.setattr(tconfig.logger, "warning",
                        lambda msg, *a, **k: seen.append(str(msg)))
    for zc in ({"stage": 3, "zero_hpz_partition_size": 2},
               {"stage": 3, "mics_shard_size": 2},
               {"stage": 3, "zero_quantized_nontrainable_weights": True},
               {"stage": 1, "zero_quantized_gradients": True,
                "zero_hpz_partition_size": 2}):
        cfg = {"train_micro_batch_size_per_gpu": 1, "zero_optimization": zc,
               "mesh": {"data": 1}}
        mine, theirs = DeepSpeedConfig(cfg), JaxConfig(cfg)
        for key, v in zc.items():
            assert getattr(mine.zero_config, key) == \
                getattr(theirs.zero_config, key) == v, key
        if zc.get("zero_hpz_partition_size", 1) > 1 or \
                zc.get("mics_shard_size", 0) > 0:
            with pytest.raises(ValueError, match="data-parallel world 1 not "
                               "divisible by secondary partition size 2"):
                dst.initialize(model=get_model_config("gpt2-tiny"),
                               config=cfg, device="cpu")
    assert any("zero_quantized_nontrainable_weights" in w and "ignored" in w
               for w in seen), seen


def test_config_reads_the_reduction_keys_as_jax_does():
    from deepspeed_tpu.runtime.config import (DeepSpeedConfig as JaxConfig,
                                              DeepSpeedConfigError as JErr)
    from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                    DeepSpeedConfigError)

    cfg = {"train_micro_batch_size_per_gpu": 1,
           "zero_optimization": {"stage": 1,
                                 "zero_quantized_gradients": True},
           "comm_quantization": {"enabled": True, "grad_reduce": "FP8",
                                 "error_feedback": False},
           "step_schedule": {"weight_update": "decomposed",
                             "fused_reduce_scatter": True}}
    j, t = JaxConfig(cfg), DeepSpeedConfig(cfg)
    assert t.zero_config.zero_quantized_gradients \
        == j.zero_config.zero_quantized_gradients is True
    for key in ("grad_reduce", "error_feedback", "group_size"):
        assert getattr(t.comm_quantization, key) \
            == getattr(j.comm_quantization, key)
    for key in ("weight_update", "fused_reduce_scatter"):
        assert getattr(t.step_schedule, key) == getattr(j.step_schedule, key)
    bad = {**cfg, "step_schedule": {"weight_update": "split"}}
    with pytest.raises(JErr, match="weight_update must be one of"):
        JaxConfig(bad)
    with pytest.raises(DeepSpeedConfigError,
                       match="weight_update must be one of"):
        DeepSpeedConfig(bad)


# ----------------------------------------------------------------------
# mirrors of tests/test_onebit.py
# ----------------------------------------------------------------------
def _onebit_runs(names, steps, freeze_step=3, **opt):
    batch = _batch(16, seed=9)
    cfg = {**CFG, "train_micro_batch_size_per_gpu": 4,
           "gradient_clipping": 0.0}
    runs = []
    for name, opt_type in names:
        c = {**cfg, "optimizer": {"type": opt_type, "params": {
            "lr": 1e-3, "freeze_step": freeze_step, **opt}}}
        if opt_type in ("qgz", "AdamW"):    # qgZ and its exact control
            c = {**cfg, "optimizer": {"type": "AdamW", "params": {
                "lr": 1e-3}}, "zero_optimization": {
                    "stage": 1, "zero_quantized_gradients": opt_type == "qgz"}}
        runs.append({"name": name, "model": "gpt2-tiny",
                     "model_kw": {"num_layers": 2}, "cfg": c,
                     "batch": batch, "steps": steps})
    return launch(torch_dp_ranks.engine_runs, 2, args=(runs,),
                  backend="gloo", device="cpu")[0]


def test_onebit_variants_converge_and_track_adam():
    """The three variants keep learning after the switch to compression
    (loss 8 below loss 1 and below loss 4, freeze_step 3); OnebitAdam's
    last loss within 25 % of AdamW's and qgZ's within 10 % (the JAX
    tests' bounds)."""
    got = _onebit_runs([("OnebitAdam", "OnebitAdam"),
                        ("OnebitLamb", "OnebitLamb"),
                        ("ZeroOneAdam", "ZeroOneAdam"),
                        ("0/1adam", "0/1adam"),
                        ("adam", "Adam"), ("qgz", "qgz"),
                        ("adamw", "AdamW")], steps=8, weight_decay=0.0)
    for name in ("OnebitAdam", "OnebitLamb", "ZeroOneAdam", "0/1adam"):
        losses = got[name]["losses"]
        assert got[name]["modes"]["onebit"] is not None
        assert losses[-1] < losses[0] and losses[-1] < losses[3], name
    assert got["0/1adam"]["losses"] == got["ZeroOneAdam"]["losses"]
    ref = got["adam"]["losses"]
    assert abs(got["OnebitAdam"]["losses"][-1] - ref[-1]) / ref[-1] < 0.25
    assert got["qgz"]["modes"]["onebit"] == "qgz"
    ref = got["adamw"]["losses"]
    assert abs(got["qgz"]["losses"][-1] - ref[-1]) / ref[-1] < 0.1


def test_onebit_state_is_per_rank_and_rejects_a_seq_axis():
    """The error state: ``worker_err`` of the padded length (a multiple of
    world · 8) and ``server_err`` of its 1/world; a seq axis raises."""
    params = {"w": torch.zeros(14), "b": torch.zeros(3)}
    topo = MeshTopology({"data": 1})
    topo.dp_size = 2          # the sizes alone: no process group here
    step = OnebitTrainStep(topo, lambda p, b: 0.0, params,
                           OnebitConfig({}, "onebitadam"), gas=1)
    st = step.init_state(params)
    assert st["worker_err"].shape == (32,) and st["server_err"].shape == (16,)
    assert st["m"].shape == st["v"].shape == (32,)
    topo.sp_size = 2
    with pytest.raises(ValueError, match="data-parallel"):
        OnebitTrainStep(topo, lambda p, b: 0.0, params,
                        OnebitConfig({}, "onebitadam"), gas=1)


def test_onebit_and_commquant_checkpoints_leave_the_error_state_out(tmp_path):
    """As in JAX, the 1-bit state and the residual are not saved: a
    checkpoint of a data-1 OnebitAdam engine holds the params and the
    factory AdamW's state only."""
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "optimizer": {"type": "OnebitAdam", "params": {"lr": 1e-3}},
           "steps_per_print": 10_000}
    logging.getLogger("deepspeed_tpu_torch").setLevel(logging.ERROR)
    eng, *_ = dst.initialize(model=get_model_config("gpt2-tiny"), config=cfg,
                             device="cpu")
    eng.train_batch(_batch(2))
    names = [leaf.name for leaf in eng._checkpoint_leaves()]
    assert not any("err" in n or "residual" in n for n in names)
    assert any(n.startswith("optimizer/") for n in names)
