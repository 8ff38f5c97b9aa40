"""Optimizer factory for the port's training path.

Port of ``deepspeed_tpu/runtime/optimizers.py`` ``build_optimizer`` for
``AdamW``, for ``Adam``/``FusedAdam`` with ``adam_w_mode`` true, for
``Lion``/``FusedLion``, and for the 1-bit names (``OnebitAdam``,
``OnebitLamb``, ``ZeroOneAdam`` or ``0/1adam``), which build AdamW with the
JAX factory's warning: over a data axis the engine's compressed step
(``runtime/onebit.py``) replaces it, at data 1 it is the optimizer.  The fused multi-tensor kernels
(``ops/fused_optimizer.py``) are the default for fp32 leaves, as FusedAdam
and FusedLion are in DeepSpeed (the JAX package makes its Pallas kernels
opt-in through ``pallas_fused``, a key the port accepts and ignores).
Non-fp32 leaves follow the JAX ``_jnp_leaf`` math, every intermediate in
the state dtype.

The state is named like the JAX optax chain's ``ScaleByAdamState`` and
``ScaleByLionState``: ``{"count": int32 step counter (host), "mu": first
moments[, "nu": second moments]}``, the moment trees shaped like the
params, so a later checkpoint port can carry JAX optimizer state over.
``update`` steps params and state in place.  The learning rate is an
argument of ``update``, so host schedules drive it step by step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.models.transformer import (tree_leaves,
                                                    tree_map_with_path)
from deepspeed_tpu_torch.ops.fused_optimizer import (LeafTable,
                                                     bias_corrections,
                                                     fused_adamw, fused_lion)
from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config import not_ported
from deepspeed_tpu_torch.utils.logging import logger


def _adamw_state_dtype_leaf(p, g, m, v, lr: float, count: int, b1: float,
                            b2: float, eps: float, wd: float) -> None:
    """The JAX ``_jnp_leaf`` update for a non-fp32 leaf, in place: every
    intermediate stays in the state dtype (the params' dtype), as the optax
    chain computes it."""
    md = m.dtype
    bc1, bc2 = bias_corrections(count, b1, b2)
    g = g.to(md)
    m.copy_(b1 * m + (1.0 - b1) * g)
    v.copy_(b2 * v + (1.0 - b2) * g * g)
    mh = m / torch.tensor(bc1, dtype=md, device=m.device)
    vh = v / torch.tensor(bc2, dtype=md, device=m.device)
    u = mh / (torch.sqrt(vh) + eps)
    if wd:
        u = u + wd * p.to(md)
    step = (-lr * u).to(md)
    p.copy_((p + step).to(p.dtype))


def _lion_state_dtype_leaf(p, g, m, lr: float, b1: float, b2: float,
                           wd: float) -> None:
    """The JAX fused Lion's ``_jnp_leaf`` for a non-fp32 leaf, in place,
    every intermediate in the state dtype."""
    md = m.dtype
    g = g.to(md)
    u = torch.sign(b1 * m + (1.0 - b1) * g)
    if wd:
        u = u + wd * p.to(md)
    step = (-lr * u).to(md)
    p.copy_((p + step).to(p.dtype))
    m.copy_(b2 * m + (1.0 - b2) * g)


class Optimizer:
    """A fused optimizer over a param tree: the fp32 leaves step in one
    launch of a multi-tensor kernel (or its plain version on the CPU), the
    others one by one in their state dtype.  Subclasses name the moment
    trees of the state and the two leaf updates."""

    name = ""
    moments: Tuple[str, ...] = ()

    def __init__(self, **defaults):
        self.defaults = defaults
        self._table = LeafTable()

    def init(self, params) -> Dict[str, Any]:
        zeros = lambda _p, x: torch.zeros_like(x, memory_format=torch.contiguous_format)
        return {"count": torch.zeros((), dtype=torch.int32),
                **{k: tree_map_with_path(zeros, params) for k in self.moments}}

    @torch.no_grad()
    def update(self, grads, state, params, lr: float) -> None:
        """One step of every leaf, in place."""
        count = int(state["count"])
        fused = tuple([] for _ in range(2 + len(self.moments)))
        for leaf in zip(tree_leaves(params), tree_leaves(grads),
                        *(tree_leaves(state[k]) for k in self.moments)):
            if leaf[0].dtype == torch.float32:
                for bucket, x in zip(fused, leaf):
                    bucket.append(x)
            else:
                self._leaf(*leaf, lr=lr, count=count)
        if fused[0]:
            self._fused(*fused, lr=lr, count=count)
        state["count"] += 1

    def _leaf(self, p, g, *moments, lr: float, count: int) -> None:
        raise NotImplementedError

    def _fused(self, ps, gs, *moments, lr: float, count: int) -> None:
        raise NotImplementedError


class AdamW(Optimizer):
    """AdamW with decoupled weight decay (state ``count``, ``mu``, ``nu``)."""

    name = "fused_adamw"
    moments = ("mu", "nu")

    def __init__(self, b1: float, b2: float, eps: float, wd: float):
        super().__init__(betas=(b1, b2), eps=eps, weight_decay=wd)
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, wd

    def _leaf(self, p, g, m, v, lr: float, count: int) -> None:
        _adamw_state_dtype_leaf(p, g, m, v, lr, count, self.b1, self.b2,
                                self.eps, self.wd)

    def _fused(self, ps, gs, ms, vs, lr: float, count: int) -> None:
        fused_adamw(ps, gs, ms, vs, lr=lr, count=count, b1=self.b1,
                    b2=self.b2, eps=self.eps, wd=self.wd, table=self._table)


class Lion(Optimizer):
    """Lion (state ``count``, ``mu``: optax's ``ScaleByLionState``)."""

    name = "fused_lion"
    moments = ("mu",)

    def __init__(self, b1: float, b2: float, wd: float):
        super().__init__(betas=(b1, b2), weight_decay=wd)
        self.b1, self.b2, self.wd = b1, b2, wd

    def _leaf(self, p, g, m, lr: float, count: int) -> None:
        _lion_state_dtype_leaf(p, g, m, lr, self.b1, self.b2, self.wd)

    def _fused(self, ps, gs, ms, lr: float, count: int) -> None:
        fused_lion(ps, gs, ms, lr=lr, b1=self.b1, b2=self.b2, wd=self.wd,
                   table=self._table)


def _adamw(params_cfg: Dict[str, Any]) -> Optimizer:
    betas = params_cfg.get("betas", (0.9, 0.999))
    return AdamW(float(betas[0]), float(betas[1]),
                 float(params_cfg.get("eps", 1e-8)),
                 float(params_cfg.get("weight_decay", 0.01)))


def _lion(params_cfg: Dict[str, Any]) -> Optimizer:
    betas = params_cfg.get("betas", (0.9, 0.99))
    return Lion(float(betas[0]), float(betas[1]),
                float(params_cfg.get("weight_decay", 0.0)))


_NOT_PORTED = {
    C.LAMB_OPTIMIZER: "Queue A item 3 (Lamb)",
    "fusedlamb": "Queue A item 3 (Lamb)",
    C.ADAGRAD_OPTIMIZER: "Queue A item 3 (Adagrad)",
    C.SGD_OPTIMIZER: "Queue A item 3 (SGD)",
    C.MUON_OPTIMIZER: "Queue A item 11 (Muon)",
}


def build_optimizer(opt_type: str,
                    params_cfg: Optional[Dict[str, Any]] = None) -> Optimizer:
    """The optimizer named by a DeepSpeed config's ``optimizer`` block."""
    params_cfg = dict(params_cfg or {})
    params_cfg.pop("lr", None)            # lr flows through update()
    params_cfg.pop("pallas_fused", None)  # the fused kernel is the default
    t = opt_type.lower()
    if t in (C.ADAM_OPTIMIZER, C.FUSED_ADAM_OPTIMIZER):
        if not bool(params_cfg.pop("adam_w_mode", True)):
            raise not_ported("Adam with L2 decay (adam_w_mode false)",
                             "Queue A item 3 (Adam L2)")
        return _adamw(params_cfg)
    if t == C.ADAMW_OPTIMIZER:
        params_cfg.pop("adam_w_mode", None)
        return _adamw(params_cfg)
    if t in (C.LION_OPTIMIZER, "fusedlion"):
        return _lion(params_cfg)
    if t in C.ONEBIT_OPTIMIZERS:
        # the compressed-communication optimizers: the engine runs their
        # step over a data axis (runtime/onebit.py); this is the plain one
        logger.warning(f"{opt_type}: using uncompressed variant "
                       "(all-reduced grads)")
        if not bool(params_cfg.pop("adam_w_mode", True)):
            raise not_ported("Adam with L2 decay (adam_w_mode false)",
                             "Queue A item 3 (Adam L2)")
        return _adamw(params_cfg)
    if t in _NOT_PORTED:
        raise not_ported(f"the {opt_type} optimizer", _NOT_PORTED[t])
    raise ValueError(f"unknown optimizer type '{opt_type}'")
