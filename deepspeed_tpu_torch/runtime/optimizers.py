"""Optimizer factory for the port's training path.

Port of ``deepspeed_tpu/runtime/optimizers.py`` ``build_optimizer`` for
``AdamW`` and for ``Adam``/``FusedAdam`` with ``adam_w_mode`` true.  The
fused multi-tensor kernel (``ops/fused_optimizer.py``) is the default for
fp32 leaves, as FusedAdam is in DeepSpeed (the JAX package makes its
Pallas kernel opt-in through ``pallas_fused``, a key the port accepts and
ignores).  Non-fp32 leaves follow the JAX ``_jnp_leaf`` math, every
intermediate in the state dtype.

The state is named like the JAX optax chain's ``ScaleByAdamState``:
``{"count": int32 step counter (host), "mu": first moments, "nu": second
moments}``, the moment trees shaped like the params, so a later checkpoint
port can carry JAX optimizer state over.  ``update`` steps params and
state in place.  The learning rate is an argument of ``update``, so host
schedules drive it step by step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch.models.transformer import (tree_leaves,
                                                    tree_map_with_path)
from deepspeed_tpu_torch.ops.fused_optimizer import (AdamWTable,
                                                     bias_corrections,
                                                     fused_adamw)
from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config import not_ported


def _state_dtype_leaf(p, g, m, v, lr: float, count: int, b1: float, b2: float,
                      eps: float, wd: float) -> None:
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


class Optimizer:
    """AdamW with decoupled weight decay over a param tree."""

    name = "fused_adamw"

    def __init__(self, b1: float, b2: float, eps: float, wd: float):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, wd
        self.defaults = dict(betas=(b1, b2), eps=eps, weight_decay=wd)
        self._table = AdamWTable()

    def init(self, params) -> Dict[str, Any]:
        zeros = lambda _p, x: torch.zeros_like(x, memory_format=torch.contiguous_format)
        return {"count": torch.zeros((), dtype=torch.int32),
                "mu": tree_map_with_path(zeros, params),
                "nu": tree_map_with_path(zeros, params)}

    @torch.no_grad()
    def update(self, grads, state, params, lr: float) -> None:
        """One step of every leaf, in place; fp32 leaves in one launch of
        the fused kernel (or its plain version on the CPU)."""
        count = int(state["count"])
        fused = ([], [], [], [])
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["mu"]), tree_leaves(state["nu"])):
            if p.dtype == torch.float32:
                for bucket, x in zip(fused, (p, g, m, v)):
                    bucket.append(x)
            else:
                _state_dtype_leaf(p, g, m, v, lr, count, self.b1, self.b2,
                                  self.eps, self.wd)
        if fused[0]:
            fused_adamw(*fused, lr=lr, count=count, b1=self.b1, b2=self.b2,
                        eps=self.eps, wd=self.wd, table=self._table)
        state["count"] += 1


def _adamw(params_cfg: Dict[str, Any]) -> Optimizer:
    betas = params_cfg.get("betas", (0.9, 0.999))
    return Optimizer(float(betas[0]), float(betas[1]),
                     float(params_cfg.get("eps", 1e-8)),
                     float(params_cfg.get("weight_decay", 0.01)))


_NOT_PORTED = {
    C.LION_OPTIMIZER: "Queue B item 3 (Lion, kernel row 15)",
    "fusedlion": "Queue B item 3 (Lion, kernel row 15)",
    C.LAMB_OPTIMIZER: "Queue A item 3 (Lamb)",
    "fusedlamb": "Queue A item 3 (Lamb)",
    C.ADAGRAD_OPTIMIZER: "Queue A item 3 (Adagrad)",
    C.SGD_OPTIMIZER: "Queue A item 3 (SGD)",
    C.MUON_OPTIMIZER: "Queue A item 11 (Muon)",
    C.ONEBIT_ADAM_OPTIMIZER: "Queue A item 8 (1-bit optimizers)",
    C.ONEBIT_LAMB_OPTIMIZER: "Queue A item 8 (1-bit optimizers)",
    C.ZERO_ONE_ADAM_OPTIMIZER: "Queue A item 8 (1-bit optimizers)",
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
    if t in _NOT_PORTED:
        raise not_ported(f"the {opt_type} optimizer", _NOT_PORTED[t])
    raise ValueError(f"unknown optimizer type '{opt_type}'")
