"""The port's data parallelism over NCCL, one H100 a rank: ZeRO stages 1-3
at ``{"data": 4}`` (stage 3 also with the gather window at depth 2 over
buckets of about a third of a layer's gradients, and with the int8
weight gather, qwZ) and stages 1-2 at ``{"data": 2, "seq": 2}`` (the
ring, striped), each against one engine on the CPU at data 1 on the same
global batch (for qwZ, ZeRO-3 with qwZ at data 1: the codec's round trip
on every leaf), and the flat buckets against the per-leaf collectives.

The model is ``chip_smoke.py``'s mesh-reference model (llama3-8b's head
dim 128 and GQA group 4 at width 1024, 2 layers, fp32, seq 512).  Losses
and grad norms of two steps to 1e-5 relative, the params after them to
1e-6 relative L2 (cuBLAS and the ring kernels against the CPU's plain
versions, in fp32: summation order only).  One launch of four ranks runs
every configuration; each rank asserts that its backend is ``nccl``.

The buckets under NCCL: a four-rank sum does not come in one order
(NCCL picks its algorithm and its chunks by size), so on standard normals
a bucket and a per-leaf call are held to the bound two orders of a sum of
four terms can differ by, ``2 (4 - 1) 2^-24 sum_r |x_r|`` an element; on
multiples of 2^-10, whose sums are exact in any order, bit for bit.  The
quantized ring wire's int8 and uint8 payloads rotate around the seq groups
of ``{"data": 2, "seq": 2}`` byte for byte.  The quantized gradient
reduction's collectives at data 4 (``quantized_all_reduce`` int8 with error
feedback over two calls, one-level qgZ, the 1-bit ``compressed_allreduce``
with both error states) against the same body in four gloo ranks on the
CPU (plain versions): within a few fp32 ulps of each block's largest
input (the sums of four ranks come in other orders), for at most one
element in 1000 one wire step apart; the quantize kernels launched on
the card.

No JAX here: the machine with the cards has none.  Run on four cards
with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_nccl_cuda.py -m cuda

Every test skips with fewer than four CUDA devices.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.launcher import launch

RANKS = 4
MODEL = "llama3-8b"
MODEL_KW = {"hidden_size": 1024, "num_heads": 8, "num_kv_heads": 2,
            "intermediate_size": 3584, "vocab_size": 32000, "num_layers": 2,
            "seq_impl": "ring", "ring_placement": "striped"}
SEQ = 512
STEPS = 2
GAS = 2
ROWS = 8          # the global batch: micro x gas x data, every config
CFG = {"gradient_accumulation_steps": GAS,
       "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
       "gradient_clipping": 1.0, "steps_per_print": 10_000,
       "activation_checkpointing": {"remat_policy": "none"}}
RTOL = 1e-5
PARAMS_RTOL = 1e-6
# name: (mesh, ZeRO stage, reduce_bucket_size, extra keys)
DEPTH2 = {"step_schedule": {"gather_prefetch_depth": 2}}
QWZ = {"zero_optimization": {"zero_quantized_weights": True}}
CONFIGS = {"data4-stage1": ({"data": 4}, 1, 500_000_000, {}),
           "data4-stage1-per-leaf": ({"data": 4}, 1, 1, {}),
           "data4-stage2": ({"data": 4}, 2, 500_000_000, {}),
           "data4-stage3": ({"data": 4}, 3, 500_000_000, {}),
           "data4-stage3-prefetch2": ({"data": 4}, 3, 4_000_000, DEPTH2),
           "data4-stage3-qwz": ({"data": 4}, 3, 500_000_000, QWZ),
           "data2xseq2-stage1": ({"data": 2, "seq": 2}, 1, 500_000_000, {}),
           "data2xseq2-stage2": ({"data": 2, "seq": 2}, 2, 500_000_000, {})}
U = 2.0 ** -24


def config(mesh, stage, bucket, extra=None):
    extra = extra or {}
    data = mesh.get("data", 1)
    return {**CFG, **extra, "mesh": mesh,
            "train_micro_batch_size_per_gpu": ROWS // (GAS * data),
            "zero_optimization": {"stage": stage,
                                  "param_persistence_threshold": 0,
                                  "reduce_bucket_size": bucket,
                                  **extra.get("zero_optimization", {})}}


def _tree_cpu(tree):
    """Host copies of a tree's tensors."""
    if isinstance(tree, dict):
        return {k: _tree_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu().clone()


def _bucket_checks(device):
    """Bucketed against per-leaf all-reduce and reduce-scatter over the
    world on ``device``: per case, (the largest difference, the largest
    difference over the order bound) on normals, and bit equality on
    exact inputs."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.comm import comm

    world, rank = dist.get_world_size(), dist.get_rank()
    gen = torch.Generator(device="cpu").manual_seed(50 + rank)
    shapes = [(7, 4), (64, 33), (1000,), (3, 8, 16), (129, 2), (5,)]
    rs_shapes = [(8, 12), (4, 16, 8), (world * 6,), (12, world * 10)]
    rs_dims = [0, 1, 0, 1]
    out = {}
    for exact in (False, True):
        def draw(shape):
            if exact:
                x = torch.randint(-8192, 8192, shape, generator=gen) / 1024.0
            else:
                x = torch.randn(shape, generator=gen)
            return x.float().to(device)

        leaves = [draw(s) for s in shapes]
        mags = [x.abs() for x in leaves]
        per = [x.clone() for x in leaves]
        for t, m in zip(per, mags):
            comm.all_reduce(t)
            comm.all_reduce(m)
        rs = [draw(s) for s in rs_shapes]
        rs_per = [comm.reduce_scatter(t.clone(), d) for t, d in zip(rs, rs_dims)]
        rs_mag = [comm.reduce_scatter(t.abs(), d) for t, d in zip(rs, rs_dims)]
        for limit in (300, 2500, 10 ** 9):
            got = []
            for idx in comm.plan_buckets([x.numel() for x in leaves], limit):
                flat = torch.cat([leaves[i].reshape(-1) for i in idx])
                views = comm.flat_views(flat, [shapes[i] for i in idx])
                comm.all_reduce_bucket(views, flat)
                got += views
            sl = []
            for idx in comm.plan_buckets([x.numel() for x in rs], limit):
                seg = comm.reduce_scatter_bucket([rs[i] for i in idx],
                                                 [rs_dims[i] for i in idx])
                sl += comm.flat_views(seg, [rs_per[i].shape for i in idx])
            for kind, a, b, m in (("all_reduce", got, per, mags),
                                  ("reduce_scatter", sl, rs_per, rs_mag)):
                diff = max(float((x - y).abs().max()) for x, y in zip(a, b))
                over = max(float(((x - y).abs() / (2 * (world - 1) * U * z
                                                   * (1 + 1e-6) + 1e-30)).max())
                           for x, y, z in zip(a, b, m))
                equal = all(torch.equal(x, y) for x, y in zip(a, b))
                out[(kind, "exact" if exact else "normal", limit)] = (
                    diff, over, equal)
    return out


def _rotation_check(device):
    """int8 and uint8 payloads one hop around each seq group of
    ``{"data": 2, "seq": 2}``: every byte a rank receives is its ring
    predecessor's."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.parallel.topology import MeshTopology

    topo = MeshTopology({"data": 2, "seq": 2})

    def payload(rank):
        gen = torch.Generator(device="cpu").manual_seed(70 + rank)
        return [torch.randint(-128, 128, (4096,), generator=gen,
                              dtype=torch.int8),
                torch.randint(0, 256, (64, 65), generator=gen,
                              dtype=torch.uint8)]

    mine = [t.to(device) for t in payload(topo.rank)]
    got = comm.ring_rotate(mine, topo.seq_group)
    prev = topo.dp_rank * topo.sp_size + (topo.sp_rank - 1) % topo.sp_size
    return all(torch.equal(g.cpu(), w) and g.dtype == w.dtype
               for g, w in zip(got, payload(prev)))


def dp_collectives(rank, world, device="cpu"):
    """The quantized reduction's collectives on this rank's seeded inputs
    (numpy results): ``quantized_all_reduce`` int8 (groups of 256) twice,
    the residual fed back; one-level qgZ (groups of 2048); the 1-bit
    all-reduce with nonzero errors.  Also the quantize/dequantize launches
    they made.  Runs under NCCL on the card or gloo on the CPU."""
    from deepspeed_tpu_torch.comm import coalesced_collectives as cc
    from deepspeed_tpu_torch.comm import compressed as cp
    from deepspeed_tpu_torch.comm import quantized as tq
    from deepspeed_tpu_torch.ops import quantize as qk

    gen = torch.Generator(device="cpu").manual_seed(90 + rank)
    n = world * (1 << 16)
    x = torch.randn(n, generator=gen) * (rank + 1)
    res = torch.randn(n, generator=gen) * 1e-3
    werr = torch.randn(n, generator=gen) * 0.1
    serr = torch.randn(n // world, generator=gen) * 0.1
    x, res, werr, serr = (t.to(device) for t in (x, res, werr, serr))
    before = dict(qk.launches)
    out = {}
    for i in range(2):
        y, res = tq.quantized_all_reduce(x, None, world, wire_dtype="int8",
                                         group_size=256, residual=res)
        out[f"ar{i}"] = y.cpu().numpy()
    out["residual"] = res.cpu().numpy()
    shard, _ = cc.all_to_all_quant_reduce({"g": x}, None, None, world, 1,
                                          group_size=2048)
    out["qgz"] = shard.cpu().numpy()
    avg, we, se = cp.compressed_allreduce(x, werr, serr, None, world)
    out.update(onebit=avg.cpu().numpy(), werr=we.cpu().numpy(),
               serr=se.cpu().numpy())
    out["launches"] = {k: qk.launches[k] - before[k]
                       for k in ("quantize", "dequantize")}
    out["x"] = x.cpu().numpy()
    return out


def nccl_ranks(rank, world, params, configs, batch, device=None):
    """One rank: its backend, each config's losses, grad norms, ZeRO
    world, flat buckets and (rank 0) gathered params after the steps, the
    bucket checks and the int8 rotation.  ``device``: None for the card
    (``"cpu"`` rehearses the body over gloo)."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.models import get_model_config

    model = get_model_config(MODEL, **MODEL_KW)
    out = {"backend": dist.get_backend(), "runs": {}}
    for name, cfg in configs.items():
        eng, *_ = ds.initialize(model=model, config=cfg,
                                model_parameters=params, device=device)
        losses, norms = [], []
        for _ in range(STEPS):
            losses.append(float(eng.train_batch(batch)))
            norms.append(eng.get_global_grad_norm())
        with zero.GatheredParameters(eng.params) as full:
            gathered = _tree_cpu(full) if rank == 0 else None
        out["runs"][name] = {"losses": losses, "grad_norms": norms,
                             "zero": (eng.topology.rank,
                                      eng.topology.world_size),
                             "buckets": eng.grad_bucket_count,
                             "stage3_buckets": eng.stage3_buckets,
                             "depth": eng._prefetch_depth, "qwz": eng._qwz,
                             "params": gathered}
        del eng
        if device is None:
            torch.cuda.empty_cache()
    dev = device or torch.device("cuda", torch.cuda.current_device())
    out["buckets"] = _bucket_checks(dev)
    out["rotation"] = _rotation_check(dev)
    out["dp"] = dp_collectives(rank, world, dev)
    return out


def reference(rows_batch, params=None, stage=0, extra=None):
    """The CPU engine at data 1 on the global batch (from ``params``, or
    its own init): the initial params, two steps' losses and grad norms,
    the params after them."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import get_model_config

    eng, *_ = ds.initialize(model=get_model_config(MODEL, **MODEL_KW),
                            device="cpu", seed=4, model_parameters=params,
                            config=config({"data": 1}, stage, 500_000_000,
                                          extra))
    params = _tree_cpu(eng.params)
    want = []
    for _ in range(STEPS):
        want.append((float(eng.train_batch(rows_batch)),
                     eng.get_global_grad_norm()))
    return params, want, _tree_cpu(eng.params)


def global_batch():
    rng = np.random.default_rng(7)
    ids = rng.integers(0, MODEL_KW["vocab_size"], (ROWS, SEQ + 1))
    return {"input_ids": ids[:, :-1].astype(np.int64),
            "labels": ids[:, 1:].astype(np.int64)}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    else:
        yield tree


def params_rel(a_tree, b_tree):
    num = den = 0.0
    for a, b in zip(_leaves(a_tree), _leaves(b_tree)):
        a, b = a.double(), b.double()
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
    return (num / den) ** 0.5


@pytest.fixture(scope="module")
def nccl_run():
    if torch.cuda.device_count() < RANKS:
        pytest.skip(f"needs {RANKS} CUDA devices")
    from deepspeed_tpu_torch.ops import op_builder

    op_builder.build_all()      # before the ranks, which would race on it
    batch = global_batch()
    params, want, final = reference(batch)
    _, want_qwz, final_qwz = reference(batch, params, 3, QWZ)
    configs = {name: config(*spec) for name, spec in CONFIGS.items()}
    ranks = launch(nccl_ranks, RANKS, args=(params, configs, batch),
                   backend="nccl", device="cuda")
    cpu_dp = launch(dp_collectives, RANKS, backend="gloo", device="cpu")
    return {"ranks": ranks, "want": want, "final": final,
            "want_qwz": want_qwz, "final_qwz": final_qwz, "cpu_dp": cpu_dp}


@pytest.mark.cuda
def test_every_rank_runs_nccl(nccl_run):
    assert [r["backend"] for r in nccl_run["ranks"]] == ["nccl"] * RANKS


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_zero_over_nccl_matches_the_cpu_engine(name, nccl_run):
    mesh, stage, bucket, extra = CONFIGS[name]
    qwz = extra is QWZ
    ranks = nccl_run["ranks"]
    want = nccl_run["want_qwz" if qwz else "want"]
    final = nccl_run["final_qwz" if qwz else "final"]
    for i, r in enumerate(ranks):
        got = r["runs"][name]
        assert got["zero"] == (i, RANKS)
        for (loss, norm), (wl, wn) in zip(zip(got["losses"],
                                              got["grad_norms"]), want):
            assert loss == pytest.approx(wl, rel=RTOL)
            assert norm == pytest.approx(wn, rel=RTOL)
        assert got["losses"] == ranks[0]["runs"][name]["losses"]
    assert params_rel(ranks[0]["runs"][name]["params"], final) <= PARAMS_RTOL
    got = ranks[0]["runs"][name]
    assert got["depth"] == extra.get("step_schedule", {}).get(
        "gather_prefetch_depth", 1)
    assert (got["qwz"] is not None) == qwz
    per_leaf = got["buckets"]
    if stage < 3:
        assert per_leaf >= 1
    else:          # the stage-3 reducer's buckets, the last micro-step
        assert got["stage3_buckets"] >= (2 if bucket < 10 ** 8 else 1)
    if bucket == 1:
        assert per_leaf > ranks[0]["runs"][name.replace("-per-leaf", "")][
            "buckets"]


@pytest.mark.cuda
def test_buckets_equal_the_per_leaf_reduction_under_nccl(nccl_run):
    for r in nccl_run["ranks"]:
        for (kind, data, limit), (diff, over, equal) in r["buckets"].items():
            assert over <= 1.0, (kind, data, limit, diff)
            if data == "exact":
                assert equal, (kind, limit, diff)


@pytest.mark.cuda
def test_int8_ring_payloads_rotate_over_nccl(nccl_run):
    assert all(r["rotation"] for r in nccl_run["ranks"])


def _near(got, want, mag, block, step):
    """Within 8 fp32 ulps of each ``block``'s largest magnitude ``mag``
    (broadcast), but for at most one element in 1000, which stays within
    ``step`` of that magnitude."""
    d = np.abs(got - want).reshape(-1, block)
    big = np.broadcast_to(mag, got.shape).reshape(-1, block).max(
        -1, keepdims=True)
    far = d > 8 * U * big
    return far.mean() <= 1e-3 and bool((d <= step * big).all())


@pytest.mark.cuda
def test_quantized_reductions_over_nccl_match_gloo_on_the_cpu(nccl_run):
    cpu = nccl_run["cpu_dp"]
    top = np.abs(np.stack([r["x"] for r in cpu])).max(0)
    for rank, (card, want) in enumerate(zip(
            [r["dp"] for r in nccl_run["ranks"]], cpu)):
        assert card["launches"] == {"quantize": 5, "dequantize": 7}, card
        for key in ("ar0", "ar1"):
            assert _near(card[key], want[key], top, 256, 2 / 127), key
        assert _near(card["residual"], want["residual"],
                     np.abs(want["x"]), 256, 1 / 127)
        chunk = top.reshape(RANKS, -1)[rank]
        assert _near(card["qgz"], want["qgz"], chunk, 2048, 1 / 127)
        for key in ("onebit", "werr", "serr"):
            np.testing.assert_allclose(card[key], want[key], rtol=1e-5,
                                       atol=1e-5 * np.abs(want[key]).max())
        np.testing.assert_array_equal(card["onebit"],
                                      nccl_run["ranks"][0]["dp"]["onebit"])
