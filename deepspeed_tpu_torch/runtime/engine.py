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

Not ported yet (ROADMAP Queue A): the ``forward``/``backward``/``step``
trio, telemetry and the watchdog, checkpoints, fp16 loss scaling, ZeRO
stage 2 and 3, offload, and data-parallel worlds above one device.  ZeRO
stage 1 on one device equals stage 0 and runs.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from deepspeed_tpu_torch.models import transformer as tf_model
from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                    tree_leaves,
                                                    tree_map_with_path)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.lr_schedules import (LRSchedule,
                                                      build_lr_schedule,
                                                      constant_lr)
from deepspeed_tpu_torch.runtime.optimizers import Optimizer, build_optimizer
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.logging import log_dist

Batch = Dict[str, Any]


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

        # -- model: compute dtype from the precision block, remat policy
        # from activation_checkpointing (the JAX engine's rule) ----------
        if builtin:
            mc = model.replace(dtype=torch.bfloat16 if cfg.bf16.enabled
                               else torch.float32)
            ac = cfg.activation_checkpointing
            if ac.partition_activations or ac.remat_policy != "nothing_saveable":
                mc = mc.replace(remat_policy=ac.remat_policy)
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
            loss = self._loss_fn(self.params, mb)
            loss.backward()
            loss_sum += loss.detach().float()
        grads = []
        for p in leaves:
            if p.grad is None:   # a leaf the loss does not reach
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
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
        batch_stack = self._stack_micro_batches(data)
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
        with torch.no_grad():
            return self._loss_fn(self.params, self._to_device(batch))

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
