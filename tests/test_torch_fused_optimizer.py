"""The port's fused AdamW and Lion (``deepspeed_tpu_torch/ops/
fused_optimizer.py``, their plain versions on the CPU, and
``runtime/optimizers.py``) against the JAX package: the Pallas
``fused_adamw_leaf`` and ``fused_lion_leaf`` run through the interpreter,
``build_optimizer``'s optax chains (the JAX engine's default), and the JAX
fused optimizers' state-dtype math for a bf16 leaf.

Tolerances: the Pallas kernel and the port's plain version perform the
same fp32 operations in the same order, so they agree to one fp32 ulp of
the result (|port - jax| <= 2^-23 (1 + |jax|); the bias corrections are
each framework's own fp32 ``pow``).  The optax chain adds its moment terms
in another order and forms its bias corrections from an integer power:
1e-6 relative over several steps.  bf16 state: one bf16 ulp, 2^-7.  Lion
has no division and no bias correction: its plain version and the Pallas
kernel round at the same points (one fp32 ulp), and a sign that flipped
between the two would move p by 2 lr, far outside that band.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.optimizers import build_optimizer as jax_build
from deepspeed_tpu_torch.ops import fused_optimizer as tfo
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer

from test_torch_engine_v2 import one_torch_thread  # noqa: F401

jfo = importlib.import_module("deepspeed_tpu.ops.pallas.fused_optimizer")

B1, B2, EPS = 0.9, 0.999, 1e-8


def _close(port, ref, rtol):
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref, dtype=np.float32)
    assert np.all(np.abs(port - ref) <= rtol * (1 + np.abs(ref))), \
        float(np.abs(port - ref).max())


@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["no-decay", "decay"])
def test_plain_fused_adamw_matches_pallas_kernel(wd, monkeypatch):
    """Leaves the JAX kernel serves (last dim a multiple of 128): four
    steps, the port's multi-tensor call against fused_adamw_leaf per leaf."""
    monkeypatch.setattr(jfo, "INTERPRET", True)
    rng = np.random.default_rng(0)
    shapes = [(8, 128), (2, 4, 256)]
    p = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jm = [jnp.zeros(s, jnp.float32) for s in shapes]
    jv = [jnp.zeros(s, jnp.float32) for s in shapes]
    jp = [jnp.asarray(x) for x in p]
    tp = [torch.from_numpy(x.copy()) for x in p]
    tm = [torch.zeros(s) for s in shapes]
    tv = [torch.zeros(s) for s in shapes]
    for count in range(4):
        g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        lr = 1e-3 * (count + 1)
        for i in range(len(shapes)):
            assert jfo.supports(shapes[i])
            jp[i], jm[i], jv[i] = jfo.fused_adamw_leaf(
                jp[i], jnp.asarray(g[i]), jm[i], jv[i], lr, jnp.int32(count),
                B1, B2, EPS, wd)
        tfo.fused_adamw(tp, [torch.from_numpy(x) for x in g], tm, tv, lr=lr,
                        count=count, b1=B1, b2=B2, eps=EPS, wd=wd)
    for t, j in zip(tp + tm + tv, jp + jm + jv):
        _close(t, j, 2.0 ** -23)


def _tree(rng, dtype=np.float32):
    """Leaves the JAX kernel does not serve, beside ones it does."""
    return {"w": rng.standard_normal((4, 256)).astype(dtype),
            "b": rng.standard_normal((7,)).astype(dtype),
            "odd": {"x": rng.standard_normal((3, 5)).astype(dtype),
                    "y": rng.standard_normal((1000,)).astype(dtype)}}


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_optimizer_matches_optax_chain_over_steps():
    """build_optimizer("AdamW") in both packages: state named alike
    (count, mu, nu) and the same trajectory over five steps with a moving
    learning rate."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    cfg = {"lr": 1e-3, "betas": [0.8, 0.99], "eps": 1e-7, "weight_decay": 0.05}
    jopt, topt = jax_build("AdamW", cfg), build_optimizer("AdamW", cfg)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = _torch_tree(params)
    ts = topt.init(tp)
    assert set(ts) == {"count", "mu", "nu"}
    for step in range(5):
        g = _tree(rng)
        lr = 1e-3 / (step + 1)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, lr)
        topt.update(_torch_tree(g), ts, tp, lr)
    adam = js[0]
    assert int(ts["count"]) == int(adam.count) == 5
    for port, ref in ((tp, jp), (ts["mu"], adam.mu), (ts["nu"], adam.nu)):
        jax.tree.map(lambda t, j: _close(t, j, 1e-6), port, ref)


def test_bf16_leaf_follows_the_state_dtype_path(monkeypatch):
    """A bf16 leaf steps in its own dtype, as the JAX fused optimizer's
    _jnp_leaf does (its Pallas kernel takes fp32 leaves only); fp32 leaves
    beside it take the fused kernel's path."""
    monkeypatch.setattr(jfo, "INTERPRET", True)
    rng = np.random.default_rng(2)
    params = {"w": rng.standard_normal((8, 128)).astype(np.float32),
              "h": rng.standard_normal((6, 10)).astype(np.float32)}
    jp = {"w": jnp.asarray(params["w"]),
          "h": jnp.asarray(params["h"], jnp.bfloat16)}
    tp = {"w": torch.from_numpy(params["w"].copy()),
          "h": torch.from_numpy(params["h"]).bfloat16()}
    jopt = jax_build("AdamW", {"pallas_fused": True, "weight_decay": 0.01})
    topt = build_optimizer("AdamW", {"pallas_fused": True, "weight_decay": 0.01})
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts["mu"]["h"].dtype == torch.bfloat16
    for _ in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        jp, js = jopt.update({"w": jnp.asarray(g["w"]),
                              "h": jnp.asarray(g["h"], jnp.bfloat16)}, js, jp,
                             jnp.float32(2e-3))
        topt.update({"w": torch.from_numpy(g["w"]),
                     "h": torch.from_numpy(g["h"]).bfloat16()}, ts, tp, 2e-3)
    assert tp["h"].dtype == torch.bfloat16
    _close(tp["h"], jp["h"].astype(jnp.float32), 2.0 ** -7)
    _close(ts["nu"]["h"], js[0].nu["h"].astype(jnp.float32), 2.0 ** -7)
    _close(tp["w"], jp["w"], 2.0 ** -23)


def test_cpu_step_counts_no_launch_and_checks_inputs():
    before = dict(tfo.fused_adamw.launches)
    p = [torch.ones(3)]
    tfo.fused_adamw(p, [torch.ones(3)], [torch.zeros(3)], [torch.zeros(3)],
                    lr=0.1, count=0)
    assert tfo.fused_adamw.launches == before
    assert float(p[0][0]) < 1.0
    with pytest.raises(TypeError):
        tfo.fused_adamw([torch.ones(3, dtype=torch.float64)], [torch.ones(3)],
                        [torch.zeros(3)], [torch.zeros(3)], lr=0.1, count=0)
    with pytest.raises(ValueError):
        tfo.fused_adamw([torch.ones(3)], [torch.ones(4)], [torch.zeros(3)],
                        [torch.zeros(3)], lr=0.1, count=0)


@pytest.mark.parametrize("wd", [0.0, 0.1], ids=["no-decay", "decay"])
def test_plain_fused_lion_matches_pallas_kernel(wd, monkeypatch):
    """Three Lion steps, the port's multi-tensor call against
    fused_lion_leaf per leaf (leaves the JAX kernel serves)."""
    monkeypatch.setattr(jfo, "INTERPRET", True)
    rng = np.random.default_rng(3)
    shapes = [(8, 128), (2, 4, 256)]
    p = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jp = [jnp.asarray(x) for x in p]
    jm = [jnp.zeros(s, jnp.float32) for s in shapes]
    tp = [torch.from_numpy(x.copy()) for x in p]
    tm = [torch.zeros(s) for s in shapes]
    for step in range(3):
        g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        lr = 1e-3 * (step + 1)
        for i in range(len(shapes)):
            jp[i], jm[i] = jfo.fused_lion_leaf(jp[i], jnp.asarray(g[i]), jm[i],
                                               lr, 0.9, 0.99, wd)
        tfo.fused_lion(tp, [torch.from_numpy(x) for x in g], tm, lr=lr,
                       b1=0.9, b2=0.99, wd=wd)
    for t, j in zip(tp + tm, jp + jm):
        _close(t, j, 2.0 ** -23)


@pytest.mark.parametrize("wd", [0.0, 0.1], ids=["no-decay", "decay"])
def test_lion_matches_optax_chain_over_steps(wd):
    """build_optimizer("Lion") in both packages: state named alike (count,
    mu), the JAX defaults (betas 0.9/0.99, no decay), and the same
    trajectory over three steps with a moving learning rate."""
    rng = np.random.default_rng(4)
    params = _tree(rng)
    cfg = {"lr": 1e-3, "weight_decay": wd}
    jopt, topt = jax_build("Lion", cfg), build_optimizer("FusedLion", cfg)
    assert topt.defaults == {"betas": (0.9, 0.99), "weight_decay": wd}
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = _torch_tree(params)
    ts = topt.init(tp)
    assert set(ts) == {"count", "mu"}
    for step in range(3):
        g = _tree(rng)
        lr = 1e-3 / (step + 1)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, lr)
        topt.update(_torch_tree(g), ts, tp, lr)
    lion = js[0]
    assert int(ts["count"]) == int(lion.count) == 3
    for port, ref in ((tp, jp), (ts["mu"], lion.mu)):
        jax.tree.map(lambda t, j: _close(t, j, 1e-6), port, ref)


def test_bf16_leaf_lion_follows_the_state_dtype_path(monkeypatch):
    """A bf16 leaf steps Lion in its own dtype, as the JAX fused Lion's
    _jnp_leaf does; the fp32 leaf beside it takes the fused path."""
    monkeypatch.setattr(jfo, "INTERPRET", True)
    rng = np.random.default_rng(6)
    params = {"w": rng.standard_normal((8, 128)).astype(np.float32),
              "h": rng.standard_normal((6, 10)).astype(np.float32)}
    jp = {"w": jnp.asarray(params["w"]),
          "h": jnp.asarray(params["h"], jnp.bfloat16)}
    tp = {"w": torch.from_numpy(params["w"].copy()),
          "h": torch.from_numpy(params["h"]).bfloat16()}
    cfg = {"pallas_fused": True, "weight_decay": 0.1}
    jopt, topt = jax_build("Lion", cfg), build_optimizer("Lion", cfg)
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts["mu"]["h"].dtype == torch.bfloat16
    for _ in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        jp, js = jopt.update({"w": jnp.asarray(g["w"]),
                              "h": jnp.asarray(g["h"], jnp.bfloat16)}, js, jp,
                             jnp.float32(2e-3))
        topt.update({"w": torch.from_numpy(g["w"]),
                     "h": torch.from_numpy(g["h"]).bfloat16()}, ts, tp, 2e-3)
    assert tp["h"].dtype == torch.bfloat16
    _close(tp["h"], jp["h"].astype(jnp.float32), 2.0 ** -7)
    _close(ts["mu"]["h"], js[0].mu["h"].astype(jnp.float32), 2.0 ** -7)
    _close(tp["w"], jp["w"], 2.0 ** -23)


def test_cpu_lion_counts_no_launch_and_keeps_jnp_sign():
    """No launch on the CPU; a zero or NaN momentum sum steps like
    jnp.sign (torch.sign would map NaN to 0); bad inputs raise."""
    before = dict(tfo.fused_lion.launches)
    p = [torch.ones(3)]
    g = [torch.tensor([1.0, 0.0, float("nan")])]
    tfo.fused_lion(p, g, [torch.zeros(3)], lr=0.1)
    assert tfo.fused_lion.launches == before
    assert float(p[0][0]) == pytest.approx(0.9) and float(p[0][1]) == 1.0
    assert torch.isnan(p[0][2])
    with pytest.raises(TypeError):
        tfo.fused_lion([torch.ones(3, dtype=torch.float64)], [torch.ones(3)],
                       [torch.zeros(3)], lr=0.1)
    with pytest.raises(ValueError):
        tfo.fused_lion([torch.ones(3)], [torch.ones(4)], [torch.zeros(3)],
                       lr=0.1)
