"""The port's data parallelism over NCCL, one H100 a rank: ZeRO stages 1-3
at ``{"data": 4}`` and stages 1-2 at ``{"data": 2, "seq": 2}`` (the ring,
striped), each against one engine on the CPU at data 1 on the same global
batch, and the flat buckets against the per-leaf collectives.

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
of ``{"data": 2, "seq": 2}`` byte for byte.

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
# name: (mesh, ZeRO stage, reduce_bucket_size)
CONFIGS = {"data4-stage1": ({"data": 4}, 1, 500_000_000),
           "data4-stage1-per-leaf": ({"data": 4}, 1, 1),
           "data4-stage2": ({"data": 4}, 2, 500_000_000),
           "data4-stage3": ({"data": 4}, 3, 500_000_000),
           "data2xseq2-stage1": ({"data": 2, "seq": 2}, 1, 500_000_000),
           "data2xseq2-stage2": ({"data": 2, "seq": 2}, 2, 500_000_000)}
U = 2.0 ** -24


def config(mesh, stage, bucket):
    data = mesh.get("data", 1)
    return {**CFG, "mesh": mesh, "train_micro_batch_size_per_gpu": ROWS // (GAS * data),
            "zero_optimization": {"stage": stage,
                                  "param_persistence_threshold": 0,
                                  "reduce_bucket_size": bucket}}


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
                             "params": gathered}
        del eng
        if device is None:
            torch.cuda.empty_cache()
    dev = device or torch.device("cuda", torch.cuda.current_device())
    out["buckets"] = _bucket_checks(dev)
    out["rotation"] = _rotation_check(dev)
    return out


def reference(rows_batch):
    """The CPU engine at data 1 on the global batch: the initial params,
    two steps' losses and grad norms, the params after them."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import get_model_config

    eng, *_ = ds.initialize(model=get_model_config(MODEL, **MODEL_KW),
                            device="cpu", seed=4,
                            config=config({"data": 1}, 0, 500_000_000))
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
    configs = {name: config(*spec) for name, spec in CONFIGS.items()}
    ranks = launch(nccl_ranks, RANKS, args=(params, configs, batch),
                   backend="nccl", device="cuda")
    return {"ranks": ranks, "want": want, "final": final}


@pytest.mark.cuda
def test_every_rank_runs_nccl(nccl_run):
    assert [r["backend"] for r in nccl_run["ranks"]] == ["nccl"] * RANKS


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_zero_over_nccl_matches_the_cpu_engine(name, nccl_run):
    ranks, want = nccl_run["ranks"], nccl_run["want"]
    for i, r in enumerate(ranks):
        got = r["runs"][name]
        assert got["zero"] == (i, RANKS)
        for (loss, norm), (wl, wn) in zip(zip(got["losses"],
                                              got["grad_norms"]), want):
            assert loss == pytest.approx(wl, rel=RTOL)
            assert norm == pytest.approx(wn, rel=RTOL)
        assert got["losses"] == ranks[0]["runs"][name]["losses"]
    assert params_rel(ranks[0]["runs"][name]["params"],
                      nccl_run["final"]) <= PARAMS_RTOL
    mesh, stage, bucket = CONFIGS[name]
    per_leaf = ranks[0]["runs"][name]["buckets"]
    if stage < 3:
        assert per_leaf >= 1
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
