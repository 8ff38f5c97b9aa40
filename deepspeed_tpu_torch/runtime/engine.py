"""DeepSpeedEngine — the training engine of the port, on one GPU.

Port of the ``deepspeed_tpu/runtime/engine.py`` subset behind
``train_batch``: the model's compute dtype from the ``bf16`` flag, fp32
master params (from ``init_params`` or ``model_parameters``), the stacked
micro-batches of one train batch, fp32 gradient accumulation over the
``gradient_accumulation_steps`` micro-steps, the ``1/(scale·gas)``
scaling, the global-norm clip coefficient ``min(1, clip/(norm+1e-6))`` and
the fused AdamW step.  PyTorch runs eagerly, so the one jitted XLA program
of the JAX engine becomes a loop of ``loss.backward()`` calls (gradients
accumulate in place in each master leaf's ``.grad``) and an in-place
optimizer step.

The model is a :class:`TransformerConfig` (the built-in model) or, as in
the JAX engine, any duck-typed trainable with ``init(generator) ->
params`` and ``loss(params, batch) -> scalar``: the engine passes it a
``torch.Generator`` seeded from the config (the JAX engine passes a PRNG
key), keeps the params it returns as the masters (``model_parameters``
overrides ``init``), and calls ``loss(params, micro_batch).backward()`` per
micro-step.  Whatever the trainable holds outside ``params`` (a frozen
quantized base, for instance) takes no gradient and no optimizer state.
The ``bf16`` flag sets the built-in model's compute dtype; a duck-typed
trainable chooses its own, as in the JAX engine, and the flag is logged
as ignored for it.

Ring sequence parallelism (``{"mesh": {"seq": N}}`` with a built-in
model of ``seq_impl="ring"``): every rank of the seq process group (which
the launcher initialised) takes the same global batch, as the JAX engine
does, keeps its shard of the sequence (striped first under
``ring_placement="striped"``, as ``_maybe_stripe_ring``), runs its shard's
forward and backward with attention around the ring, all-reduces each
micro-step's token NLL sum and count and, before clipping, the fp32
gradients over the group, and steps the same replicated params.

Not ported yet (ROADMAP Queue A): the ``forward``/``backward``/``step``
trio, telemetry and the watchdog, checkpoints, fp16 loss scaling, ZeRO
stage 2 and 3, offload, and data-parallel worlds above one device.  ZeRO
stage 1 without a data-parallel world equals stage 0 and runs.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.models import transformer as tf_model
from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                    tree_leaves,
                                                    tree_map_with_path)
from deepspeed_tpu_torch.parallel.topology import MeshTopology
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, not_ported
from deepspeed_tpu_torch.runtime.lr_schedules import (LRSchedule,
                                                      build_lr_schedule,
                                                      constant_lr)
from deepspeed_tpu_torch.runtime.optimizers import Optimizer, build_optimizer
from deepspeed_tpu_torch.sequence.ring import stripe_sequence
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.logging import log_dist

Batch = Dict[str, Any]
# batch keys with a sequence axis: striped and sharded over a seq axis
SEQ_KEYS = ("input_ids", "labels", "loss_mask", "attention_mask",
            "token_type_ids", "position_ids")


def _as_array(v):
    """A batch value as a tensor (kept where it lies) or a numpy array."""
    return v if torch.is_tensor(v) else np.asarray(v)


def _global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    sums = torch.stack([torch.sum(torch.square(g.float())) for g in leaves])
    return torch.sqrt(torch.sum(sums))


class DeepSpeedEngine:
    """Training engine over a functional model: the built-in transformer
    (a :class:`TransformerConfig`) or a duck-typed trainable."""

    def __init__(self, model: Any,
                 config: Union[DeepSpeedConfig, Dict[str, Any], str, None] = None,
                 model_params: Optional[Any] = None,
                 optimizer: Optional[Optimizer] = None,
                 lr_scheduler: Optional[LRSchedule] = None,
                 seed: Optional[int] = None, device=None):
        builtin = isinstance(model, TransformerConfig)
        if not builtin and not (callable(getattr(model, "init", None))
                                and callable(getattr(model, "loss", None))):
            raise TypeError("model must be a TransformerConfig or a "
                            "trainable with init(generator) and "
                            "loss(params, batch)")
        self.config = config if isinstance(config, DeepSpeedConfig) \
            else DeepSpeedConfig(config)
        cfg = self.config
        self.device = resolve_device(device)
        self.zero_stage = cfg.zero_config.stage
        self.micro_batch_size = cfg.train_micro_batch_size_per_gpu
        self.gradient_accumulation_steps_value = cfg.gradient_accumulation_steps
        self.train_batch_size_value = cfg.train_batch_size
        self.seed = seed if seed is not None else cfg.seed

        # -- the seq axis: ring sequence parallelism over the process group
        # the launcher initialised ---------------------------------------
        if cfg.seq_parallel_size > 1:
            if not builtin:
                raise not_ported("a seq mesh axis with a duck-typed "
                                 "trainable", "Queue A item 9")
            if model.seq_impl != "ring":
                raise not_ported(f"seq_impl={model.seq_impl!r} (Ulysses) "
                                 "over a seq axis above one",
                                 "Queue A item 9")
        self.topology = MeshTopology({"seq": cfg.seq_parallel_size})

        # -- model: compute dtype from the precision block, remat policy
        # from activation_checkpointing (the JAX engine's rule) ----------
        if builtin:
            mc = model.replace(dtype=torch.bfloat16 if cfg.bf16.enabled
                               else torch.float32)
            ac = cfg.activation_checkpointing
            if ac.partition_activations or ac.remat_policy != "nothing_saveable":
                mc = mc.replace(remat_policy=ac.remat_policy)
            if cfg.step_schedule.ring_interleave > 1 and mc.seq_impl == "ring":
                mc = mc.replace(ring_interleave=cfg.step_schedule.ring_interleave)
            self.model_config = mc
            self._loss_fn = lambda params, batch: tf_model.loss_fn(params,
                                                                   batch, mc)
        else:
            self.model_config = None
            self._loss_fn = model.loss
            if cfg.bf16.enabled:
                log_dist("bf16.enabled is ignored for a duck-typed trainable: "
                         "it computes in the dtype it chooses itself",
                         level="warning")

        # -- params: masters (fp32 for the built-in model), leaves of the
        # autograd graph -------------------------------------------------
        if model_params is not None:
            params = tree_map_with_path(
                lambda _p, x: torch.as_tensor(x).detach().to(
                    self.device, copy=True), model_params)
        elif builtin:
            params = tf_model.init_params(mc, seed=self.seed,
                                          device=self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            params = tree_map_with_path(
                lambda _p, x: x.detach().to(self.device), model.init(gen))
        for p in tree_leaves(params):
            p.requires_grad_(True)
        self.params = params

        # -- optimizer and schedule ---------------------------------------
        if optimizer is not None:
            self.optimizer = optimizer
        elif cfg.optimizer is not None:
            self.optimizer = build_optimizer(cfg.optimizer.type,
                                             cfg.optimizer.params)
        else:
            self.optimizer = build_optimizer("adamw", {})
        self.base_lr = cfg.optimizer.lr if cfg.optimizer else 1e-3
        self.opt_state = self.optimizer.init(self.params)
        if lr_scheduler is not None:
            self.lr_scheduler = lr_scheduler
        elif cfg.scheduler is not None:
            self.lr_scheduler = build_lr_schedule(
                cfg.scheduler.type, cfg.scheduler.params, base_lr=self.base_lr)
        else:
            self.lr_scheduler = constant_lr(self.base_lr)

        self.global_steps = 0
        self.micro_steps = 0
        self._last_metrics: Dict[str, torch.Tensor] = {}

    # ------------------------------------------------------------------
    def _stack_micro_batches(self, data) -> Batch:
        """Accept a stacked batch dict [gas*micro, ...] of any keys, a dict
        already shaped [gas, micro, ...], or an iterator of micro-batches;
        return arrays shaped [gas, micro, ...].  A dict's values may be
        numpy arrays or tensors (tensors stay where they lie)."""
        gas = self.gradient_accumulation_steps_value
        per_step = self.micro_batch_size
        if isinstance(data, dict):
            first = next(iter(data.values()))
            n = np.shape(first)[0]
            if n == gas and np.ndim(first) >= 2 and np.shape(first)[1] == per_step:
                return {k: _as_array(v) for k, v in data.items()}
            if n != gas * per_step:
                raise ValueError(
                    f"batch dim {n} != gas({gas}) * micro*dp({per_step})")
            return {k: _as_array(v).reshape((gas, per_step)
                                            + tuple(np.shape(v)[1:]))
                    for k, v in data.items()}
        micros = [next(data) for _ in range(gas)]
        return {k: np.stack([np.asarray(m[k]) for m in micros], axis=0)
                for k in micros[0]}

    def _to_device(self, batch: Batch) -> Batch:
        return {k: torch.as_tensor(_as_array(v)).to(self.device)
                for k, v in batch.items()}

    def _seq_shard(self, batch: Batch, seq_axis: int) -> Batch:
        """This rank's shard of the sequence keys of a global batch,
        striped first under striped ring placement (the JAX engine's
        ``_maybe_stripe_ring``, then its seq sharding)."""
        sp, rank = self.topology.sp_size, self.topology.sp_rank
        if sp <= 1:
            return batch
        s = np.shape(batch["input_ids"])[seq_axis]
        if s % sp:
            raise ValueError(f"sequence length {s} not divisible by the seq "
                             f"axis {sp}")
        s_l = s // sp
        cut = (slice(None),) * seq_axis + (slice(rank * s_l, (rank + 1) * s_l),)
        striped = self.model_config.ring_placement == "striped"
        out = dict(batch)
        for k in SEQ_KEYS:
            v = out.get(k)
            if v is not None and np.ndim(v) > seq_axis \
                    and np.shape(v)[seq_axis] == s:
                if striped:
                    v = stripe_sequence(v, sp, axis=seq_axis)
                out[k] = v[cut]
        return out

    def _micro_loss(self, mb: Batch):
        """The micro-batch loss to differentiate.  Over a seq axis each
        rank's share of the global token mean: its NLL sum over the token
        count all-reduced with the sum (so the summed grads are the global
        mean's); returns ``(loss to differentiate, global mean loss)``."""
        if self.topology.sp_size <= 1:
            loss = self._loss_fn(self.params, mb)
            return loss, loss.detach().float()
        nll, count = tf_model.loss_fn(self.params, mb, self.model_config,
                                      topo=self.topology, sum_count=True)
        tot = torch.stack([nll.detach().float(), count.float()])
        comm.all_reduce(tot, self.topology.seq_group)
        denom = torch.clamp(tot[1], min=1)
        return nll / denom, tot[0] / denom

    def _dropout_seeds(self, gas: int):
        """Per-micro-step dropout seeds when the built-in model trains with
        dropout (the JAX engine's per-step PRNG keys); None otherwise."""
        if self.model_config is None or self.model_config.dropout <= 0.0:
            return None
        step = tf_model._fold(self.seed + 7919, self.global_steps)
        return [tf_model._fold(step, i) for i in range(gas)]

    def _accum_grads(self, batch_stack: Batch):
        """Run the gas micro-steps, accumulating fp32 gradients in each
        master leaf's ``.grad``; returns (grad leaves, summed loss)."""
        leaves = tree_leaves(self.params)
        for p in leaves:
            if p.grad is not None:
                p.grad.zero_()
        gas = self.gradient_accumulation_steps_value
        seeds = self._dropout_seeds(gas)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(gas):
            mb = self._to_device({k: v[i] for k, v in batch_stack.items()})
            if seeds is not None:
                mb["dropout_seed"] = seeds[i]
            loss, value = self._micro_loss(mb)
            loss.backward()
            loss_sum += value
        grads = []
        for p in leaves:
            if p.grad is None:   # a leaf the loss does not reach
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if self.topology.sp_size > 1:
            for g in grads:
                comm.all_reduce(g, self.topology.seq_group)
        return grads, loss_sum

    @torch.no_grad()
    def _apply_update(self, grads, lr: float) -> torch.Tensor:
        """``grads *= 1/(scale·gas)``; global norm; clip; optimizer step
        (the JAX ``apply_update`` with a loss scale of one)."""
        inv = float(np.float32(1.0) / np.float32(
            self.gradient_accumulation_steps_value))
        for g in grads:
            g.mul_(inv)
        grad_norm = _global_norm(grads)
        clip = self.config.gradient_clipping
        if clip and clip > 0:
            coef = torch.clamp(clip / (grad_norm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(coef)
        grad_tree = tree_map_with_path(lambda _p, p: p.grad, self.params)
        self.optimizer.update(grad_tree, self.opt_state, self.params, lr)
        return grad_norm

    # ------------------------------------------------------------------
    # Public API (DeepSpeed parity)
    # ------------------------------------------------------------------
    def train_batch(self, data) -> torch.Tensor:
        """One full train batch (gas micro-batches + optimizer step);
        returns the mean micro-batch loss as a 0-dim fp32 tensor."""
        batch_stack = self._seq_shard(self._stack_micro_batches(data),
                                      seq_axis=2)
        lr = float(self.lr_scheduler(self.global_steps))
        grads, loss_sum = self._accum_grads(batch_stack)
        grad_norm = self._apply_update(grads, lr)
        gas = self.gradient_accumulation_steps_value
        metrics = {"loss": loss_sum / gas, "grad_norm": grad_norm}
        self.global_steps += 1
        self.micro_steps += gas
        self.lr_scheduler.step()
        self._after_step(metrics)
        return metrics["loss"]

    def eval_batch(self, batch: Batch) -> torch.Tensor:
        batch = self._seq_shard(batch, seq_axis=1)
        with torch.no_grad():
            return self._micro_loss(self._to_device(batch))[1]

    def _after_step(self, metrics) -> None:
        self._last_metrics = metrics
        if self.global_steps % self.config.steps_per_print == 0:
            m = {k: float(v) for k, v in metrics.items()}
            log_dist(f"step={self.global_steps} "
                     + " ".join(f"{k}={v:.6g}" for k, v in m.items())
                     + f" lr={self.lr_scheduler(self.global_steps - 1):.3e}")

    def get_global_grad_norm(self) -> float:
        gn = self._last_metrics.get("grad_norm")
        return float(gn) if gn is not None else 0.0

    def get_lr(self):
        return self.lr_scheduler.get_last_lr()

    @property
    def train_micro_batch_size_per_gpu(self) -> int:
        return self.micro_batch_size

    def train_batch_size(self) -> int:
        return self.train_batch_size_value

    def gradient_accumulation_steps(self) -> int:
        return self.gradient_accumulation_steps_value
