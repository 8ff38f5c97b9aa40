"""1-bit optimizers (OnebitAdam, OnebitLamb, ZeroOneAdam) and qgZ over a
data axis.

Port of ``deepspeed_tpu/runtime/onebit.py``.  The JAX step is one jitted
``shard_map`` program over the data axis; here each rank runs it eagerly
on its own rows and the data group's collectives take the place of the
mesh's:

* warm-up (``step <= freeze_step``): the exact mean all-reduce of the
  gradient, then Adam's moments (momentum and variance both learn);
* compression (after ``freeze_step``): the variance is frozen; each rank
  folds its local gradient into the momentum, and the momenta are
  mean-all-reduced through ``comm/compressed.py``'s 1-bit
  ``compressed_allreduce`` with worker and server error feedback;
* ``qgz`` (``zero_quantized_gradients`` without ZeRO-3): the gradient is
  averaged through int8 all-to-all reduction (``_quant_chunked_reduce``,
  groups of 2048, the ``quantize``/``dequantize`` kernels on the card) and
  all-gathered; both moments learn.  Over a data axis factored by hpZ or
  MiCS (subdata above one) the reduction runs two levels, as
  ``deepspeed_tpu/runtime/onebit.py:159-178`` does: within the inner group
  (subdata), then across the outer group (data), through
  ``comm/coalesced_collectives.py``'s ``all_to_all_quant_reduce``; the
  all-gathers run outer first, then inner.  Otherwise one level over the
  data group.

Then, as in JAX, bias correction, clipping on the update's global norm,
and the step: decoupled weight decay (Adam) or the LAMB trust ratio a leaf
(OnebitLamb).  ZeroOneAdam reads its policy fields and steps as OnebitAdam,
as the JAX step does.  The JAX step branches with ``lax.cond`` on the step
count; here the host's count decides.

The params are the engine's fp32 masters, stepped in place (the JAX step
updates the engine's params, its fp32 masters, and the model casts them to
its compute dtype).  The gradient is flattened in the JAX tree order (dict
keys sorted) and padded to a multiple of ``world · 8``; the state is
``m``/``v`` of that length (equal on every rank) and this rank's
``worker_err`` [padded] and ``server_err`` [padded / world].  As in JAX,
none of it is checkpointed.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.coalesced_collectives import (
    _quant_chunked_reduce, all_to_all_quant_reduce)
from deepspeed_tpu_torch.comm.compressed import compressed_allreduce
from deepspeed_tpu_torch.models.transformer import (tree_leaves,
                                                    tree_map_with_path)
from deepspeed_tpu_torch.parallel.topology import MeshTopology
from deepspeed_tpu_torch.utils.logging import log_dist

# qgZ's int8 block (the JAX step's)
QGZ_GROUP = 2048


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def jax_order(tree) -> List[int]:
    """Positions of ``tree``'s leaves (in ``tree_map_with_path`` order)
    sorted into the JAX tree order (dict keys sorted at every level)."""
    paths = []
    tree_map_with_path(lambda p, _x: paths.append(p), tree)
    return sorted(range(len(paths)), key=lambda i: paths[i])


class OnebitConfig:
    def __init__(self, params: Dict[str, Any], variant: str):
        self.variant = variant
        self.lr = float(params.get("lr", 1e-3))
        betas = params.get("betas", (0.9, 0.999))
        self.beta1, self.beta2 = float(betas[0]), float(betas[1])
        self.eps = float(params.get("eps", 1e-8))
        self.weight_decay = float(params.get("weight_decay", 0.0))
        self.freeze_step = int(params.get("freeze_step", 100))
        # ZeroOneAdam policies (read, as in JAX, and not acted on)
        self.var_freeze_step = int(params.get("var_freeze_step",
                                              self.freeze_step))
        self.var_update_scaler = int(params.get("var_update_scaler", 16))
        self.local_step_scaler = int(params.get("local_step_scaler", 32678))
        self.local_step_clipper = int(params.get("local_step_clipper", 16))
        # LAMB extras
        self.max_coeff = float(params.get("max_coeff", 10.0))
        self.min_coeff = float(params.get("min_coeff", 0.01))


class OnebitTrainStep:
    """The compressed data-parallel step of one rank.  Data-parallel
    meshes only (as the reference's 1-bit optimizers); the params are
    whole on every rank and their state is replicated but for the
    error feedback."""

    def __init__(self, topology: MeshTopology, loss_fn: Callable,
                 params: Any, cfg: OnebitConfig, gas: int,
                 grad_clip: float = 0.0):
        if (topology.tp_size > 1 or topology.pp_size > 1
                or topology.sp_size > 1):
            raise ValueError("1-bit optimizers support data-parallel meshes "
                             "only (ref: 1-bit Adam is incompatible with "
                             "ZeRO>=2/TP/PP)")
        self.topo = topology
        self.group = topology.data_group
        self.cfg = cfg
        # the data-parallel world, data · subdata (the batch group)
        self.world = topology.dp_size
        self.inner = getattr(topology, "subdata_size", 1)
        self.gas = gas
        self.loss_fn = loss_fn
        self.grad_clip = grad_clip
        self._order = jax_order(params)
        n = sum(x.numel() for x in tree_leaves(params))
        self._n = n
        # chunks divide evenly into world ranks x 8-bit packing
        self._padded = -(-n // (self.world * 8)) * self.world * 8
        log_dist(f"1-bit {cfg.variant}: world={self.world} params={n} "
                 f"freeze_step={cfg.freeze_step}")

    def init_state(self, params) -> Dict[str, Any]:
        dev = tree_leaves(params)[0].device
        pad, world = self._padded, self.world

        def zeros(k):
            return torch.zeros(k, dtype=torch.float32, device=dev)

        return {"m": zeros(pad), "v": zeros(pad), "step": 0,
                "worker_err": zeros(pad), "server_err": zeros(pad // world)}

    def _ordered(self, leaves):
        return [leaves[i] for i in self._order]

    def _flat_grad(self, params) -> torch.Tensor:
        leaves = self._ordered(tree_leaves(params))
        flat = torch.zeros(self._padded, dtype=torch.float32,
                           device=leaves[0].device)
        off = 0
        for p in leaves:
            k = p.numel()
            if p.grad is not None:
                flat[off:off + k].copy_(p.grad.reshape(-1))
            off += k
        return flat

    def __call__(self, params, state, micro_batches, lr: float
                 ) -> torch.Tensor:
        """One step over this rank's micro-batches (its rows of each),
        params and ``state`` in place; returns the loss, the mean of the
        ranks' micro-batch means."""
        cfg, world = self.cfg, self.world
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        loss_sum = None
        for mb in micro_batches:
            loss = self.loss_fn(params, mb)
            loss.backward()
            v = loss.detach().float()
            loss_sum = v if loss_sum is None else loss_sum + v
        with torch.no_grad():
            g = self._flat_grad(params)
            for p in leaves:
                p.grad = None
            g.mul_(_f32(1.0, g) / _f32(float(self.gas), g))
            loss = loss_sum / _f32(float(self.gas), g)
            comm.all_reduce(loss, self.group)
            loss = loss / _f32(float(world), g)
            state["step"] += 1
            step = state["step"]
            m, v = state["m"], state["v"]
            b1, b2 = _f32(cfg.beta1, g), _f32(cfg.beta2, g)
            if cfg.variant == "qgz":
                g = self._qgz_mean(g)
                m.copy_(b1 * m + (1 - b1) * g)
                v.copy_(b2 * v + (1 - b2) * g * g)
            elif step <= cfg.freeze_step:
                comm.all_reduce(g, self.group)
                g = g / _f32(float(world), g)
                m.copy_(b1 * m + (1 - b1) * g)
                v.copy_(b2 * v + (1 - b2) * g * g)
            else:
                m_local = b1 * m + (1 - b1) * g
                m_avg, werr, serr = compressed_allreduce(
                    m_local, state["worker_err"], state["server_err"],
                    self.group, world)
                m.copy_(m_avg)
                state["worker_err"], state["server_err"] = werr, serr
            del g
            t = _f32(float(step), m)
            bc1 = 1 - b1 ** t
            bc2 = 1 - b2 ** t
            update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if self.grad_clip and self.grad_clip > 0:
                gnorm = torch.linalg.vector_norm(update)
                update = update * torch.clamp(
                    self.grad_clip / (gnorm + 1e-6), max=1.0)
            self._apply(leaves, update, _f32(lr, m))
        return loss

    def _qgz_mean(self, g: torch.Tensor) -> torch.Tensor:
        """qgZ's mean of the ranks' flat gradients ``g``: one level of
        int8 all-to-all reduction over the data group, or two over a
        factored data axis (the inner group, then the outer), each rank's
        chunk then all-gathered (outer first)."""
        topo = self.topo
        if self.inner <= 1:
            shard = _quant_chunked_reduce(g, self.group, self.world,
                                          QGZ_GROUP)
            return comm.all_gather(shard, 0, self.group)
        outer = self.world // self.inner
        shard, _meta = all_to_all_quant_reduce(
            g, topo.inner_group, topo.outer_group, self.inner, outer,
            QGZ_GROUP)
        if outer > 1:
            shard = comm.all_gather(shard, 0, topo.outer_group)
        return comm.all_gather(shard, 0, topo.inner_group)

    def _apply(self, leaves, update: torch.Tensor, lr: torch.Tensor) -> None:
        cfg = self.cfg
        wd = _f32(cfg.weight_decay, update)
        off = 0
        for p in self._ordered(leaves):
            k = p.numel()
            u = update[off:off + k].view(p.shape)
            off += k
            p32 = p.float()
            if cfg.variant == "onebitlamb":
                wn = torch.linalg.vector_norm(p32)
                d = u + wd * p32
                un = torch.linalg.vector_norm(d)
                ratio = torch.clamp(wn / (un + 1e-12), cfg.min_coeff,
                                    cfg.max_coeff)
                ratio = torch.where(wn > 0, ratio, 1.0)
                p.copy_((p32 - lr * ratio * d).to(p.dtype))
            else:
                p.copy_((p32 * (1 - lr * wd) - lr * u).to(p.dtype))
