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
Over a data axis each rank calls ``loss`` on its equal share of the rows
and the gradients are averaged over the data group, so the step is the
global mean's, as the JAX engine's ``loss`` over the sharded batch; its
state splits where the oracle's rules match its paths (a ZeRO-3 slice is
gathered whole before ``loss`` sees it).
The ``bf16`` flag sets the built-in model's compute dtype; a duck-typed
trainable chooses its own, as in the JAX engine, and the flag is logged
as ignored for it.

Sequence parallelism (``{"mesh": {"seq": N}}``): every rank of the seq
process group (which the launcher initialised) takes the same global
batch, as the JAX engine does, and keeps its shard of the sequence: the
rank-th contiguous block, striped first only under a ring model's
``ring_placement="striped"``, as ``_maybe_stripe_ring`` (the port stripes
``loss_mask`` with the labels, ROADMAP Queue C).  A built-in model runs
its shard's forward and backward with attention around the ring
(``seq_impl="ring"``) or through Ulysses' all-to-alls (``"ulysses"``),
and all-reduces each micro-step's token NLL sum and count and, before
clipping, the fp32 gradients over the group.  A duck-typed trainable
(whose attention may be ``sequence.UlyssesAttentionHF``) gets the
contiguous shard of the sequence keys; its loss is divided by dp·sp and
its gradients summed over the world.  ZeRO splits its state over the seq
axis as over a data axis (the JAX ``ZERO_AXES``).
``comm_quantization.ring_rotation`` ``"int8"`` or ``"fp8"`` sets the ring's
wire on the model (``sequence/ring.py``); without a seq axis above one, or
with another ``seq_impl``, it warns and keeps the fp32 wire.

Data parallelism and ZeRO (``{"mesh": {"data": N}}``, with or without a
seq axis beside it): each micro-step's ``micro·dp`` rows are split by data
rank, as the JAX engine's ``BATCH_AXES`` sharding splits them, and the loss
is the global token mean (NLL sum and token count all-reduced over the
data and seq ranks together).  ZeRO's world is the data and seq axes:
while no other axis is above one, the whole world (``world_group``).  The
:class:`PartitionOracle` decides, leaf by leaf, the dim a param, its
optimizer state and its gradient accumulator are split on over that world
(or none):

* stage 0: grads are all-reduced, every rank steps the whole tree;
* stage 1: grads are all-reduced; each rank steps its slice of each leaf
  (its optimizer state only) and the params are all-gathered;
* stage 2: as stage 1, but each micro-step's grads are reduce-scattered
  into fp32 slice accumulators;
* stage 3: the params are slices too; the forward gathers them (one flat
  all-gather a layer, ``step_schedule.gather_prefetch_depth`` - 1 layers
  ahead of their use; ``zero.py``) and the backward hands the full
  gradients to a :class:`~deepspeed_tpu_torch.zero.Stage3Reducer`, which
  reduce-scatters them through flat buckets as they come (asynchronously
  under NCCL, waited on at the end of each micro-step's backward) into
  fp32 accumulators, each slice's ``.grad``; the update runs on the
  slices.  Leaves the persistence threshold keeps whole are treated as in
  stage 2.  Under qwZ (``comm_quantization.zero3_gather`` int8/fp8, or
  ``zero_optimization.zero_quantized_weights``) the gathers move the
  wire's payload and block scales (``parallel/zeropp.py``).

hpZ and MiCS (``zero_hpz_partition_size`` / ``mics_shard_size`` k) factor
the data axis into outer ``data`` × inner ``subdata`` (k) before the
topology is built, as the JAX engine does; each leaf's place is a
:class:`zero.Split` (``_place_leaves``).  Under hpZ a stage-3 param holds
its slice over the inner group, where its gathers run; its master and
optimizer state are its world slice nested in the param slice, the
gradient summed over the inner group by the reducer and reduce-scattered
across the outer group once a step, the stepped slices all-gathered over
the outer group.  Under MiCS params and state both split over the inner
group; the outer group holds replicas, across which the gradients are
summed once a step, and the grad norm counts each slice once.  Below
stage 3, hpZ changes only the factoring.

The gradient reduction runs through flat buckets of at most
``zero_optimization.reduce_bucket_size`` elements, in leaf order (one
``all_reduce`` or one rank-major ``reduce_scatter`` a bucket over the ZeRO
world, ``comm.all_reduce_bucket``/``comm.reduce_scatter_bucket``).  An
all-reduced leaf's ``.grad`` is a view of its bucket, made once, so
autograd accumulates in place and nothing is packed; a reduce-scattered
leaf's full ``.grad`` lives from its backward to its bucket's
reduce-scatter, so ZeRO-2 keeps no full gradient between micro-steps.
A ``reduce_bucket_size`` of 1 gives every leaf a
bucket of its own: the per-leaf reduction (at stage 3, every gathered
leaf's gradient).  The global grad norm counts
each element once: slice sums of squares are all-reduced, and a leaf that
stays whole on every rank is added once.
``step_schedule.fused_gather_matmul`` goes through the JAX engine's gate
(ZeRO 3, no other parallel axis, MLP weights split in the fsdp pattern);
where it is refused the engine warns with the JAX reason and keeps the
unfused stage-3 gather.

The gradient reduction over a data-only axis (data above one, no seq
axis) has the JAX engine's other modes, each behind the JAX gate and its
warnings:

* ``comm_quantization.grad_reduce`` (the block enabled, ZeRO stage <= 2,
  no 1-bit step): each rank's gradients of its own rows' loss accumulate
  locally over the micro-steps in one flat buffer laid out in the JAX tree
  order and padded to ``world · group_size`` blocks, and one
  ``comm/quantized.py`` ``quantized_all_reduce`` of that wire averages it
  (int8 through the ``quantize``/``dequantize`` kernels), with the first
  send's residual carried per rank to the next step under
  ``error_feedback``; the loss is the mean of the ranks' losses;
* the 1-bit optimizers and qgZ (``zero_optimization.
  zero_quantized_gradients`` at stage <= 1 with Adam/AdamW): the step is
  ``runtime/onebit.py``'s, on the fp32 masters;
* ``step_schedule.weight_update: "decomposed"``: at stages 0-1 the
  optimizer state and the gradient accumulator split as at stage 2
  (reduce-scattered buckets, the stepped slices all-gathered), and with
  ``fused_reduce_scatter`` the micro-steps accumulate locally and each
  bucket is reduce-scattered once after the last backward.

Checkpoints (``save_checkpoint``/``load_checkpoint``, the JAX engine's
dispatch): the pickle engine by default, the ``fast`` and ``decoupled``
writers of ``checkpoint.writer.type``, and with
``load_universal_checkpoint`` the universal format (``checkpoint/``).
Every leaf is saved whole under the JAX package's name, gathered through
its ZeRO split dim, and a load keeps each rank's slice for the loading
engine's own ZeRO world, so a checkpoint moves between meshes and between
the two packages.

Not ported yet (ROADMAP Queue A): the ``forward``/``backward``/``step``
trio, telemetry and the watchdog, fp16 loss scaling and offload.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from deepspeed_tpu_torch import zero
from deepspeed_tpu_torch.checkpoint.engine import (CkptLeaf, LeafSpec,
                                                   chain_names, check_leaves,
                                                   nest, numpy_dtype)
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.quantized import quantized_all_reduce
from deepspeed_tpu_torch.models import transformer as tf_model
from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                    is_norm_path,
                                                    tree_leaves,
                                                    tree_map_with_path)
from deepspeed_tpu_torch.parallel import zeropp
from deepspeed_tpu_torch.parallel.topology import (MeshTopology,
                                                   factor_data_axis,
                                                   set_topology)
from deepspeed_tpu_torch.resilience.oracle import (PartitionOracle,
                                                   secondary_mode_from_config)
from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.lr_schedules import (LRSchedule,
                                                      build_lr_schedule,
                                                      constant_lr)
from deepspeed_tpu_torch.runtime.onebit import (OnebitConfig,
                                                OnebitTrainStep, jax_order)
from deepspeed_tpu_torch.runtime.optimizers import Optimizer, build_optimizer
from deepspeed_tpu_torch.sequence.ring import stripe_sequence
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.logging import log_dist, logger

Batch = Dict[str, Any]
# batch keys with a sequence axis: striped and sharded over a seq axis
SEQ_KEYS = ("input_ids", "labels", "loss_mask", "attention_mask",
            "token_type_ids", "position_ids")


def _as_array(v):
    """A batch value as a tensor (kept where it lies) or a numpy array."""
    return v if torch.is_tensor(v) else np.asarray(v)


def _unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map_with_path(lambda _p, _x: next(it), tree)


def _global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    sums = torch.stack([torch.sum(torch.square(g.float())) for g in leaves])
    return torch.sqrt(torch.sum(sums))


class _Place(NamedTuple):
    """Where a leaf's tensors lie in the full leaf: the param (``param``,
    a :class:`zero.Split` or None: whole), the master the optimizer steps
    and its state (``master``), and the master's split of the param
    tensor (``rel``: None where the master is the param itself)."""
    param: Optional[zero.Split]
    master: Optional[zero.Split]
    rel: Optional[zero.Split]


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

        # hpZ and MiCS factor the data axis before the topology is built
        # (the JAX engine's order, deepspeed_tpu/runtime/engine.py:183-195)
        sizes = {"data": cfg.world_size, "seq": cfg.seq_parallel_size}
        zc = cfg.zero_config
        self._secondary_mode = secondary_mode_from_config(zc)
        if self._secondary_mode != "none":
            sizes = factor_data_axis(sizes, zc.zero_hpz_partition_size
                                     if self._secondary_mode == "hpz"
                                     else zc.mics_shard_size)
            log_dist(f"ZeRO++ {self._secondary_mode}: DP world factored "
                     f"into outer={sizes['data']} × "
                     f"inner={sizes['subdata']}")
        self.topology = MeshTopology(sizes)
        set_topology(self.topology)

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
            self._prefetch_depth = self._clamp_depth(
                cfg.step_schedule.gather_prefetch_depth, mc.num_layers)
            cq = cfg.comm_quantization
            if cq.enabled and cq.ring_rotation != "fp32":
                if mc.seq_impl == "ring" and self.topology.sp_size > 1:
                    # the quantized ring wire: K/V and the traveling dk/dv
                    # move as int8/fp8 payloads with fp32 row scales
                    mc = mc.replace(ring_wire_dtype=cq.ring_rotation)
                    log_dist("comm_quantization: ring rotation wire = "
                             f"{cq.ring_rotation} over "
                             f"sp={self.topology.sp_size}")
                else:
                    logger.warning(
                        "comm_quantization.ring_rotation: no >1 'seq' mesh "
                        "axis (or seq_impl != 'ring'): nothing travels a "
                        "ring; keeping the fp32 wire")
            self.model_config = mc
            # closes over mc, not self: an engine in a reference cycle
            # would hold its tensors after the caller drops it.  The fused
            # gate changes the config only over a data axis, where the
            # loss goes through _micro_loss's sum-and-count branch.
            self._loss_fn = lambda params, batch: tf_model.loss_fn(params,
                                                                   batch, mc)
        else:
            self.model_config = None
            self._loss_fn = model.loss
            # the JAX engine reads the depth in its built-in-model branch
            self._prefetch_depth = 1
            if cfg.bf16.enabled:
                log_dist("bf16.enabled is ignored for a duck-typed trainable: "
                         "it computes in the dtype it chooses itself",
                         level="warning")

        self._qwz = zeropp.qwz_of(cfg)
        if self._qwz is not None:
            log_dist(f"ZeRO-3 weight gather (qwZ): wire {self._qwz[0]}, "
                     f"group size {self._qwz[1]}")
        self._reduction_modes()

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
        self._partition(params)

        # -- optimizer and schedule ---------------------------------------
        if optimizer is not None:
            self.optimizer = optimizer
        elif cfg.optimizer is not None:
            self.optimizer = build_optimizer(cfg.optimizer.type,
                                             cfg.optimizer.params)
        else:
            self.optimizer = build_optimizer("adamw", {})
        self.base_lr = cfg.optimizer.lr if cfg.optimizer else 1e-3
        self.opt_state = self.optimizer.init(self._masters)
        self._onebit = self._onebit_state = None
        if self._onebit_variant is not None:
            self._onebit = OnebitTrainStep(
                self.topology, self._loss_fn, self.params,
                OnebitConfig(cfg.optimizer.params, self._onebit_variant),
                gas=self.gradient_accumulation_steps_value,
                grad_clip=cfg.gradient_clipping)
            self._onebit_state = self._onebit.init_state(self.params)
        if lr_scheduler is not None:
            self.lr_scheduler = lr_scheduler
        elif cfg.scheduler is not None:
            self.lr_scheduler = build_lr_schedule(
                cfg.scheduler.type, cfg.scheduler.params, base_lr=self.base_lr)
        else:
            self.lr_scheduler = constant_lr(self.base_lr)

        self.global_steps = 0
        self.micro_steps = 0
        # reduce-scatter buckets of the last micro-step's stage-3 gradients
        self.stage3_buckets = 0
        self._last_metrics: Dict[str, torch.Tensor] = {}
        # the loss-scale state the JAX engine keeps outside fp16 (fp16
        # raises, Queue A item 3): scale 1, and no step is ever skipped
        # there, so its checkpoints carry these values
        self.loss_scale_state = {"scale": np.asarray(1.0, np.float32),
                                 "good_steps": np.asarray(0, np.int32),
                                 "skipped": np.asarray(0, np.int32)}
        self._checkpoint_engine = None
        # the last pickle save's host seconds (gather, whole save)
        self.last_checkpoint_stats: Dict[str, float] = {}

    @staticmethod
    def _clamp_depth(depth: int, num_layers: int) -> int:
        """``step_schedule.gather_prefetch_depth`` clamped to the largest
        divisor of ``num_layers`` at or below it, with the JAX engine's
        warning (``deepspeed_tpu/runtime/engine.py:279-298``: its layer
        scan unrolls only by a divisor of its length)."""
        clamped = depth
        while num_layers % clamped:
            clamped -= 1
        if clamped != depth:
            logger.warning(f"step_schedule.gather_prefetch_depth={depth} "
                           f"does not divide num_layers={num_layers}; "
                           f"clamped to {clamped}")
        return clamped

    def _reduction_modes(self) -> None:
        """The JAX engine's gates for the data axis's reduction modes
        (``deepspeed_tpu/runtime/engine.py:500-540``, ``:969-1110``), reason
        for reason and in its order: the decomposed weight update, the
        1-bit or qgZ step, the explicit quantized reduce of
        ``comm_quantization`` and the fused reduce-scatter.  Sets
        ``_decomposed``, ``_onebit_variant``, ``_comm_quant`` (the config
        block, or None) and ``_fused_rs``."""
        cfg, topo = self.config, self.topology
        zc, cq, ss = cfg.zero_config, cfg.comm_quantization, cfg.step_schedule
        opt = cfg.optimizer.type if cfg.optimizer is not None else None
        onebit_opt = opt in C.ONEBIT_OPTIMIZERS
        dp_only = topo.dp_size > 1 and topo.sp_size == 1

        self._decomposed = False
        if ss.weight_update == "decomposed":
            blocked = ("no >1 ZeRO axis" if topo.world_size <= 1 else
                       "1-bit optimizer" if onebit_opt else
                       "qgZ compressed gradients"
                       if zc.zero_quantized_gradients
                       and self.zero_stage <= 1 else "")
            if blocked:
                logger.warning(
                    "step_schedule.weight_update='decomposed': unsupported "
                    f"with this configuration ({blocked}) — keeping the "
                    "stage's native update layout")
            else:
                self._decomposed = True
                log_dist("step_schedule: decomposed weight update — "
                         "optimizer state + grad accumulator split over "
                         f"the ZeRO world (world={topo.world_size}, "
                         f"stage={self.zero_stage})")

        self._onebit_variant = None
        if dp_only and onebit_opt:
            self._onebit_variant = ("zerooneadam" if opt in (
                C.ZERO_ONE_ADAM_OPTIMIZER, "0/1adam") else opt)
        elif (zc.zero_quantized_gradients and dp_only
              and self.zero_stage <= 1
              and opt in (C.ADAM_OPTIMIZER, C.ADAMW_OPTIMIZER,
                          C.FUSED_ADAM_OPTIMIZER)):
            self._onebit_variant = "qgz"
        if self._onebit_variant is not None and self.zero_stage >= 3:
            raise ValueError("the 1-bit optimizers step whole params: ZeRO "
                             "stage 3 splits them (ref: 1-bit Adam is "
                             "incompatible with ZeRO>=2/TP/PP)")

        self._comm_quant = None
        if cq.enabled:
            if dp_only and self.zero_stage <= 2 \
                    and self._onebit_variant is None:
                self._comm_quant = cq
                log_dist(f"comm_quantization: explicit grad reduce over "
                         f"dp={topo.dp_size} wire={cq.grad_reduce} "
                         f"group_size={cq.group_size} error_feedback="
                         f"{cq.error_feedback and cq.grad_reduce != 'fp32'}")
            elif cq.grad_reduce != "fp32":
                logger.warning(
                    "comm_quantization.grad_reduce: unsupported with this "
                    "configuration (needs a >1 data-parallel mesh without "
                    "TP/PP/SP, ZeRO stage <= 2, no 1-bit optimizer) — "
                    "falling back to the fp32 reduction of the gradient "
                    "buckets")

        self._fused_rs = False
        if ss.fused_reduce_scatter:
            blocked = (
                "requires weight_update='decomposed'"
                if not self._decomposed else
                "requires ZeRO stage <= 1 (stage >= 2 grads are already "
                "reduce-scattered each micro-step)" if self.zero_stage > 1
                else "needs a >1 data-parallel mesh without TP/PP/SP"
                if not dp_only else
                "hierarchical (hpz/mics) partitioning unsupported"
                if self._secondary_mode != "none" else
                "comm_quantization grad reduce already owns the wire"
                if self._comm_quant is not None else
                "1-bit/qgZ optimizer owns the reduction"
                if self._onebit_variant is not None else "")
            if blocked:
                logger.warning(
                    "step_schedule.fused_reduce_scatter: unsupported with "
                    f"this configuration ({blocked}) — keeping the "
                    "reduce-scatter of every micro-step")
            else:
                self._fused_rs = True
                log_dist("step_schedule: fused reduce-scatter — one "
                         "reduce-scatter a bucket after the last micro-step "
                         f"over dp={topo.dp_size}")

    @property
    def _grad_split(self) -> bool:
        """Whether the gradients of leaves whose state alone is split are
        reduce-scattered into slice accumulators (stage >= 2, or the
        decomposed update)."""
        return self.zero_stage >= 2 or self._decomposed

    # ------------------------------------------------------------------
    # ZeRO partitioning over the ZeRO world (the data and seq axes)
    # ------------------------------------------------------------------
    def _partition(self, params) -> None:
        """Decide each leaf's splits with the oracle (over a ZeRO world
        above one), run the fused gather-matmul gate, keep this rank's
        slices of the stage-3 params, build the tree the optimizer steps
        (``_masters``: a stage-3 slice itself, a slice copy of a leaf, or of
        an hpZ param slice, whose optimizer state is split further, or the
        whole leaf) and the flat buckets of the gradient reduction."""
        topo = self.topology
        param_dims = state_dims = tree_map_with_path(lambda _p, _x: None,
                                                     params)
        self.oracle = None
        if topo.world_size > 1:
            self.oracle = PartitionOracle.from_config(topo, self.config)
            param_dims = self.oracle.param_specs(params)
            # the decomposed update: the always-split specs (stage 2's)
            state_dims = self.oracle.tree_specs(params, param_style=False) \
                if self._decomposed else self.oracle.optimizer_specs(params)
            offenders = self.oracle.audit_replicated(params)
            if offenders:
                desc = ", ".join(f"{p} {s} ({b / 1e6:.1f}MB)"
                                 for p, s, b in offenders[:8])
                log_dist(f"{len(offenders)} large param(s) could not be "
                         "sharded (no dim divisible by the shard world) and "
                         f"will be REPLICATED on every device: {desc}",
                         level="warning")
        self._places = self._place_leaves(params, param_dims, state_dims)
        if self.config.step_schedule.fused_gather_matmul:
            self._fused_gate(param_dims)
        self._zero = None
        if self.zero_stage >= 3 and self.oracle is not None:
            mc = self.model_config
            if mc is not None:
                def dtype_of(path):
                    return mc.param_dtype if is_norm_path(path) else mc.dtype
            else:    # a duck-typed trainable's leaves keep their dtypes
                dtypes = tree_map_with_path(lambda _p, x: x.dtype, params)

                def dtype_of(path):
                    tree = dtypes
                    for key in path:
                        tree = tree[key]
                    return tree
            with zero.Init(topology=topo, oracle=self.oracle) as zinit:
                params = zinit.partition(params)
            # a stage-3 slice's fp32 gradient accumulator, its .grad, into
            # which the reducer adds each micro-step's reduced slices (the
            # sum over the param's group)
            accs = {}
            paths = []
            tree_map_with_path(lambda path, _x: paths.append(path), params)
            for path, p, place in zip(paths, tree_leaves(params),
                                      self._places):
                if place.param is not None:
                    p.grad = accs[path] = torch.zeros_like(p)
            zc = self.config.zero_config
            group = topo.level(self.oracle.group_of(param_style=True)).group
            self._zero = zero.ParamGather(
                params, param_dims, group, dtype_of,
                zero.Stage3Reducer(accs, group, zc.reduce_bucket_size),
                depth=self._prefetch_depth, qwz=self._qwz)
            log_dist(f"ZeRO-3: gather window depth {self._prefetch_depth}, "
                     f"gradient buckets of {zc.reduce_bucket_size} elements "
                     f"(prefetch_bucket_size {zc.prefetch_bucket_size}, "
                     "as in JAX, bounds nothing)")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        self.params = params

        self._leaves = tree_leaves(params)
        # a leaf whose state is split further than its param steps a slice
        # copy, and its fp32 slice gradient (stage 1: filled after the
        # all-reduce; stage >= 2: the accumulator the micro-steps
        # reduce-scatter into; an hpZ param slice's: reduce-scattered over
        # the outer group once a step)
        masters, self._slice_grads = [], []
        for p, place in zip(self._leaves, self._places):
            m = p
            if place.rel is not None:
                m = zero.take(p, place.rel)
                m.ds_split = place.master
                m.ds_full_shape = tuple(getattr(p, "ds_full_shape", p.shape))
            masters.append(m)
            self._slice_grads.append(torch.zeros_like(m) if m is not p
                                     else None)
        self._masters = _unflatten(params, masters)
        self._build_buckets()

    def _place_leaves(self, params, param_dims, state_dims) -> List[_Place]:
        """Each leaf's :class:`_Place`.  The param splits over the
        oracle's param group (the world, or hpZ's and MiCS's inner group);
        the optimizer state over its state group: where the param lies,
        except under hpZ, whose state splits over the whole world.  An hpZ
        param slice's state is its chunk over the outer group (the
        world's slice ``inner_rank · outer + outer_rank`` of the leaf, so
        that it lies inside the param slice); where the JAX oracle splits
        that state on another dim, or not at all, the state stays on the
        param slice, replicated across the outer group, with a warning."""
        topo, oracle = self.topology, self.oracle
        pdims, sdims = tree_leaves(param_dims), tree_leaves(state_dims)
        places = [_Place(None, None, None)] * len(pdims)
        if oracle is None:
            return places
        param_split = zero.param_split(topo, oracle)
        kind = oracle.group_of(param_style=False)
        replicas = kind == "inner" and topo.outer_size > 1
        state_level = topo.level(kind)
        writer = not replicas or topo.outer_rank == 0
        paths = []
        tree_map_with_path(lambda path, _x: paths.append("/".join(path)),
                           params)
        for i, (pdim, sdim, path) in enumerate(zip(pdims, sdims, paths)):
            psplit = param_split(pdim)
            if psplit is None:
                master = None if sdim is None else zero.Split(
                    sdim, (state_level,), replicas, writer)
                places[i] = _Place(None, master, master)
            elif oracle.group_of(param_style=True) == kind:
                places[i] = _Place(psplit, psplit, None)
            elif sdim == pdim:          # hpZ: nested in the param slice
                rel = zero.Split(pdim, (topo.level("outer"),))
                places[i] = _Place(psplit, psplit.then(rel), rel)
            else:
                logger.warning(
                    f"hpZ: '{path}' splits its param on dim {pdim} over the "
                    "inner group and its optimizer state on "
                    f"{'no dim' if sdim is None else f'dim {sdim}'} over the "
                    "world; its state stays on the param slice, replicated "
                    "across the outer group")
                places[i] = _Place(psplit, psplit, None)
        return places

    def _build_buckets(self) -> None:
        """Lay the gradient reduction out in flat buckets of at most
        ``reduce_bucket_size`` elements, by dtype, in ``_leaves`` order (a
        larger leaf alone).  ``_reduce_buckets`` are all-reduced over the
        ZeRO world once a step: every leaf at stages 0/1, at stages 2/3
        the leaves that stay whole everywhere.  Their ``.grad`` are views
        of the bucket's flat buffer, set here, before any backward, so that
        autograd accumulates into them in place.  ``_scatter_buckets``
        (stages 2/3: whole leaves whose state alone is split) are
        reduce-scattered rank-major over the state's group each micro-step
        into a flat accumulator whose views are the leaves' slice
        gradients (under MiCS all-reduced across the outer group once a
        step); their full ``.grad`` are autograd's own, made by the
        backward and dropped once reduce-scattered, and the rank-major pack
        takes a buffer of the bucket's size then, after the backward has
        freed the activations.  A stage-3 slice's gradient goes through the
        reducer of its gather (``zero.Stage3Reducer``, buckets of the same
        size) and takes none of these; under hpZ ``_outer_buckets``
        reduce-scatter those sums over the outer group once a step into
        the state's slice gradients."""
        self._reduce_buckets: List[tuple] = []
        self._scatter_buckets: List[tuple] = []
        self._outer_buckets: List[tuple] = []
        self._quant_flat = None
        if self.topology.world_size <= 1 or self._onebit_variant is not None:
            return       # the 1-bit step keeps its own flat gradient
        if self._comm_quant is not None:
            self._build_quant_flat()
            return
        limit = self.config.zero_config.reduce_bucket_size
        reduce_idx, scatter_idx, outer_idx = [], [], []
        for i, place in enumerate(self._places):
            if place.param is not None:
                if place.rel is not None:
                    outer_idx.append(i)
            elif self._grad_split and place.rel is not None:
                scatter_idx.append(i)
            else:
                reduce_idx.append(i)
        for kind, indices in (("reduce", reduce_idx),
                              ("scatter", scatter_idx),
                              ("outer", outer_idx)):
            by_dtype: Dict[torch.dtype, List[int]] = {}
            for i in indices:
                by_dtype.setdefault(self._leaves[i].dtype, []).append(i)
            for dtype, idx in by_dtype.items():
                for b in comm.plan_buckets(
                        [self._leaves[i].numel() for i in idx], limit):
                    bidx = [idx[j] for j in b]
                    ps = [self._leaves[i] for i in bidx]
                    if kind == "reduce":
                        flat = torch.zeros(sum(p.numel() for p in ps),
                                           dtype=dtype, device=self.device)
                        for p, v in zip(ps, comm.flat_views(
                                flat, [p.shape for p in ps])):
                            p.grad = v
                        self._reduce_buckets.append((bidx, flat))
                        continue
                    acc = torch.zeros(sum(self._slice_grads[i].numel()
                                          for i in bidx),
                                      dtype=dtype, device=self.device)
                    for i, v in zip(bidx, comm.flat_views(acc, [
                            self._slice_grads[i].shape for i in bidx])):
                        self._slice_grads[i] = v
                    (self._scatter_buckets if kind == "scatter" else
                     self._outer_buckets).append(
                        (bidx, [self._places[i].rel.dim for i in bidx], acc))

    def _build_quant_flat(self) -> None:
        """The explicit quantized reduce's buffer (JAX
        ``engine.py:1010-1068``): every leaf's gradient in the JAX tree
        order, padded to ``ceil(n / (world · group_size)) · world ·
        group_size`` elements, so that the wire's blocks fall where the JAX
        engine's do.  An fp32 leaf's ``.grad`` is its view of the buffer,
        set here; another leaf's gradient is added in after each backward.
        The error-feedback residual is this rank's, of the same length."""
        cq, world = self._comm_quant, self.topology.dp_size
        n = sum(p.numel() for p in self._leaves)
        base = world * cq.group_size
        self._quant_flat = torch.zeros(-(-n // base) * base,
                                       dtype=torch.float32, device=self.device)
        self._quant_offsets = [0] * len(self._leaves)
        off = 0
        for i in jax_order(self.params):
            self._quant_offsets[i] = off
            off += self._leaves[i].numel()
        self._quant_views = self._quant_views_of(self._quant_flat)
        for p, view in zip(self._leaves, self._quant_views):
            if p.dtype == torch.float32:
                p.grad = view
        self._quant_residual = None
        if cq.error_feedback and cq.grad_reduce != "fp32":
            # not checkpointed, as in JAX: a resume starts it from zero
            self._quant_residual = torch.zeros_like(self._quant_flat)

    def _quant_views_of(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Each leaf's view of a buffer laid out as ``_quant_flat``."""
        return [flat[o:o + p.numel()].view(p.shape) for p, o
                in zip(self._leaves, self._quant_offsets)]

    @property
    def grad_bucket_count(self) -> int:
        """The flat buckets of the gradient reduction (all-reduced and
        reduce-scattered)."""
        return len(self._reduce_buckets) + len(self._scatter_buckets)

    def _fused_gate(self, param_dims) -> None:
        """The JAX engine's gate for ``step_schedule.fused_gather_matmul``
        (``deepspeed_tpu/runtime/engine.py:369-436``), reason for reason:
        the fused MLP runs only where the MLP weights carry the fsdp
        pattern (wi/wg split on the embed dim 1 of the stacked leaf, wo on
        dim 2, bi on dim 1; ``param_dims``: the oracle's param split
        dims); anything else warns and keeps the unfused path."""
        cfg, mc, topo = self.config, self.model_config, self.topology
        zc = cfg.zero_config
        blocked = (
            "requires the built-in transformer model" if mc is None
            else "requires ZeRO stage 3" if self.zero_stage < 3 else
            "TP/PP/SP/EP mesh axes unsupported" if (
                topo.tp_size > 1 or topo.pp_size > 1 or topo.sp_size > 1
                or topo.ep_size > 1) else
            "hierarchical (hpz/mics) partitioning unsupported"
            if self._secondary_mode != "none" else
            "param streaming unsupported" if mc.param_stream else
            "quantized zero3_gather (qwZ) already owns the gather"
            if self._qwz is not None or zc.zero_quantized_weights else
            "compression masking unsupported"
            if cfg.to_dict().get("compression_training") else
            "MoE layers unsupported" if mc.is_moe else "")
        if not blocked:
            mlp = param_dims["layers"]["mlp"]
            ok = mlp.get("wi") == 1 and mlp.get("wo") == 2
            if ok and mc.activation == "swiglu":
                ok = mlp.get("wg") == 1
            elif ok and "bi" in mlp:
                # the pre-activation bias rides the fused region: an
                # indivisible bias dim must fall back
                ok = mlp["bi"] == 1
            if not ok:
                blocked = ("MLP weights do not carry the expected fsdp "
                           "sharding pattern (persistence threshold or "
                           "indivisible dims)")
        if blocked:
            logger.warning("step_schedule.fused_gather_matmul: unsupported "
                           f"with this configuration ({blocked}) — keeping "
                           "the unfused gather path")
            return
        axes = self.oracle.fsdp_axes()
        self.model_config = mc.replace(fused_gather_matmul=True,
                                       fused_gather_axes=axes)
        log_dist("step_schedule: fused gather-matmul — MLP all-gathers "
                 f"issued in-region over {axes}")

    # ------------------------------------------------------------------
    def _stack_micro_batches(self, data) -> Batch:
        """Accept a stacked batch dict [gas*micro*dp, ...] of any keys, a
        dict already shaped [gas, micro*dp, ...], or an iterator of
        micro-batches; return arrays shaped [gas, micro*dp, ...].  A dict's
        values may be numpy arrays or tensors (tensors stay where they
        lie)."""
        gas = self.gradient_accumulation_steps_value
        per_step = self.micro_batch_size * self.topology.dp_size
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

    def _data_shard(self, batch: Batch, row_axis: int) -> Batch:
        """This data rank's rows of a global batch: the rank-th of dp
        equal blocks along ``row_axis`` of every value that has it."""
        dp, rank = self.topology.dp_size, self.topology.dp_rank
        if dp <= 1:
            return batch
        n = np.shape(next(iter(batch.values())))[row_axis]
        if n % dp:
            raise ValueError(f"{n} batch rows do not divide by the data "
                             f"axis {dp}")
        per = n // dp
        cut = (slice(None),) * row_axis + (slice(rank * per, (rank + 1) * per),)
        return {k: v[cut] if np.ndim(v) > row_axis else v
                for k, v in batch.items()}

    def _seq_shard(self, batch: Batch, seq_axis: int) -> Batch:
        """This rank's shard of the sequence keys of a global batch: the
        rank-th contiguous block (``sequence/alst.py`` ``sp_shard_batch``),
        striped first only under the ring's striped placement (the JAX
        engine's ``_maybe_stripe_ring``, then its seq sharding)."""
        sp, rank = self.topology.sp_size, self.topology.sp_rank
        if sp <= 1:
            return batch
        s = np.shape(batch["input_ids"])[seq_axis]
        if s % sp:
            raise ValueError(f"sequence length {s} not divisible by the seq "
                             f"axis {sp}")
        s_l = s // sp
        cut = (slice(None),) * seq_axis + (slice(rank * s_l, (rank + 1) * s_l),)
        mc = self.model_config
        striped = (mc is not None and mc.seq_impl == "ring"
                   and mc.ring_placement == "striped")
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
        """The micro-batch loss to differentiate.  Over a data or seq axis
        each rank's share of the global token mean: its NLL sum over the
        token count all-reduced with the sum over the data and seq ranks
        (so the summed grads are the global mean's); for a duck-typed
        trainable its loss over the rank's rows and sequence shard divided
        by dp·sp.  Returns ``(loss to differentiate, global mean loss)``."""
        topo = self.topology
        if topo.world_size <= 1:
            params = self.params
            if self._qwz is not None:    # nothing gathered: the round trip
                params = zeropp.qwz_weight_gather(params, *self._qwz)
            loss = self._loss_fn(params, mb)
            return loss, loss.detach().float()
        if self.model_config is None:
            params = (self._zero.whole(self.params) if self._zero is not None
                      else self.params)
            loss = self._loss_fn(params, mb) / (topo.dp_size * topo.sp_size)
            value = loss.detach().float().clone()
            comm.all_reduce(value, topo.world_group)
            return loss, value
        nll, count = tf_model.loss_fn(self.params, mb, self.model_config,
                                      topo=topo, sum_count=True,
                                      zero=self._zero)
        tot = torch.stack([nll.detach().float(), count.float()])
        comm.all_reduce(tot, topo.world_group)
        denom = torch.clamp(tot[1], min=1)
        return nll / denom, tot[0] / denom

    def _dropout_seeds(self, gas: int):
        """Per-micro-step dropout seeds when the built-in model trains with
        dropout (the JAX engine's per-step PRNG keys); None otherwise."""
        if self.model_config is None or self.model_config.dropout <= 0.0:
            return None
        step = tf_model._fold(self.seed + 7919, self.global_steps)
        return [tf_model._fold(step, i) for i in range(gas)]

    def _zero_grads(self) -> None:
        """Zero the last step's gradients: every ``.grad`` that outlived it
        and the stage-2 accumulators.  (Stage 1's slice gradients are
        overwritten whole each step.)"""
        for p in self._leaves:
            if p.grad is not None:
                p.grad.zero_()
        for _idx, _dims, acc in self._scatter_buckets:
            acc.zero_()

    def _rank_loss(self, mb: Batch):
        """This rank's own rows' mean loss (the JAX shard_map modes'
        local loss): ``(loss to differentiate, its value)``."""
        loss = self._loss_fn(self.params, mb)
        return loss, loss.detach().float()

    def _mean_over_ranks(self, value: torch.Tensor) -> torch.Tensor:
        """``value`` all-reduced over the data group and divided by its
        size (``lax.pmean``)."""
        comm.all_reduce(value, self.topology.data_group)
        return value * (1.0 / self.topology.dp_size)

    def _accum_grads(self, batch_stack: Batch):
        """Run the gas micro-steps, accumulating fp32 gradients in each
        param's ``.grad`` (a stage-3 slice's through the reducer's
        buckets, finished after each backward) or, for a leaf whose state
        alone is split at stage >= 2 (or under the decomposed update), in
        its slice accumulator (one reduce-scatter a bucket each micro-step,
        or under ``fused_reduce_scatter`` once after the last backward, of
        the locally accumulated gradients); then all-reduce the whole
        leaves' buckets over the ZeRO world, and run hpZ's and MiCS's sums
        across the outer group (:meth:`_reduce_across_outer`).  Returns
        (the gradient of each ``_masters`` leaf, summed loss)."""
        if self._comm_quant is not None:
            return self._accum_grads_quant(batch_stack)
        topo = self.topology
        self._zero_grads()
        gas = self.gradient_accumulation_steps_value
        seeds = self._dropout_seeds(gas)
        fused_rs = self._fused_rs
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(gas):
            mb = self._to_device({k: v[i] for k, v in batch_stack.items()})
            if seeds is not None:
                mb["dropout_seed"] = seeds[i]
            loss, value = self._rank_loss(mb) if fused_rs \
                else self._micro_loss(mb)
            loss.backward()
            if self._zero is not None:     # the stage-3 buckets, reduced
                self.stage3_buckets = self._zero.reducer.finish()
            loss_sum += value
            if not fused_rs:
                self._scatter_micro_step()
        if fused_rs:         # the local sums, reduce-scattered once
            self._scatter_micro_step()
        for idx, flat in self._reduce_buckets:
            comm.all_reduce_bucket([self._leaves[j].grad for j in idx],
                                   flat, topo.world_group)
        self._reduce_across_outer()
        if fused_rs:         # psum_scatter / world and pmean, as in JAX
            inv = 1.0 / topo.dp_size
            for _idx, _dims, acc in self._scatter_buckets:
                acc.mul_(inv)
            for _idx, flat in self._reduce_buckets:
                flat.mul_(inv)
            loss_sum = self._mean_over_ranks(loss_sum)
        grads = []
        for p, place, acc in zip(self._leaves, self._places,
                                 self._slice_grads):
            if acc is not None and self._grad_split:
                grads.append(acc)          # reduce-scattered into its slice
                continue
            if p.grad is None:   # a leaf the loss does not reach
                p.grad = torch.zeros_like(p)
            if acc is not None:            # stage 1: this rank's slice
                acc.copy_(place.rel.slice(p.grad))
                grads.append(acc)
            else:     # whole on every rank, or a stage-3 slice (its gather
                grads.append(p.grad)       # reduced it already)
        return grads, loss_sum

    def _scatter_micro_step(self) -> None:
        """Reduce-scatter each scatter bucket's full gradients over the
        state's group into its slice accumulator and drop them."""
        for idx, dims, acc in self._scatter_buckets:
            ps = [self._leaves[j] for j in idx]
            group = self._places[idx[0]].master.levels[0].group
            acc += comm.reduce_scatter_bucket(
                [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in ps], dims, group)
            for p in ps:
                p.grad = None

    def _reduce_across_outer(self) -> None:
        """Once a step, the sums that hpZ and MiCS leave to the outer
        group: under hpZ each stage-3 slice's gradient (summed over the
        inner group) reduce-scattered into its state's slice (the outer
        buckets); the gradients of slices replicated across the outer
        group (MiCS's, and hpZ's slices whose state stays on them)
        all-reduced over it, packed in flat buckets."""
        topo = self.topology
        for idx, dims, acc in self._outer_buckets:
            acc.copy_(comm.reduce_scatter_bucket(
                [self._leaves[j].grad for j in idx], dims,
                topo.outer_group))
        if topo.outer_size <= 1:
            return
        tensors = [p.grad for p, place in zip(self._leaves, self._places)
                   if place.param is not None and place.rel is None
                   and place.param.replicas]
        tensors += [acc for idx, _dims, acc in self._scatter_buckets
                    if self._places[idx[0]].master.replicas]
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            for b in comm.plan_buckets(
                    [t.numel() for t in ts],
                    self.config.zero_config.reduce_bucket_size):
                flat = torch.cat([ts[j].reshape(-1) for j in b])
                comm.all_reduce(flat, topo.outer_group)
                for j, v in zip(b, comm.flat_views(
                        flat, [ts[j].shape for j in b])):
                    ts[j].copy_(v)

    def _accum_grads_quant(self, batch_stack: Batch):
        """The explicit quantized reduce (JAX ``engine.py:1328-1398``):
        the micro-steps' gradients of each rank's own rows' loss accumulate
        locally in the flat buffer (``_build_quant_flat``), then one
        ``quantized_all_reduce`` averages it over the data group, with this
        rank's residual under error feedback (in unscaled units; the port
        has no loss scale, fp16 being Queue A item 3); the loss is the
        ranks' mean.  A leaf whose optimizer state is split keeps its slice
        of the mean (stage 1 and 2 alike).  Returns as :meth:`_accum_grads`."""
        topo, cq = self.topology, self._comm_quant
        flat = self._quant_flat
        flat.zero_()
        gas = self.gradient_accumulation_steps_value
        seeds = self._dropout_seeds(gas)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(gas):
            mb = self._to_device({k: v[i] for k, v in batch_stack.items()})
            if seeds is not None:
                mb["dropout_seed"] = seeds[i]
            loss, value = self._rank_loss(mb)
            loss.backward()
            loss_sum += value
            for p, view in zip(self._leaves, self._quant_views):
                if p.grad is not None and p.grad is not view:
                    view.add_(p.grad.float())     # a non-fp32 leaf
                    p.grad = None
        loss_sum = self._mean_over_ranks(loss_sum)
        avg, new_res = quantized_all_reduce(
            flat, topo.data_group, topo.dp_size, wire_dtype=cq.grad_reduce,
            group_size=cq.group_size, residual=self._quant_residual)
        if new_res is not None:
            self._quant_residual = new_res
        grads = []
        for place, acc, g in zip(self._places, self._slice_grads,
                                 self._quant_views_of(avg)):
            if acc is not None:      # this rank's slice of the mean
                acc.copy_(place.rel.slice(g))
                grads.append(acc)
            else:
                grads.append(g)
        return grads, loss_sum

    def _grad_norm(self, grads) -> torch.Tensor:
        """The global L2 norm, each element counted once: the sums of
        squares of split gradients are all-reduced over the group whose
        ranks hold each slice of their leaves once (the ZeRO world; under
        MiCS, and for hpZ slices whose state stays on them, the inner
        group, so that the outer replicas are not added again); a gradient
        every rank holds whole is added once."""
        topo = self.topology
        if topo.world_size <= 1:
            return _global_norm(grads)
        zero_ = torch.zeros((), dtype=torch.float32, device=self.device)

        def sumsq(gs):
            return sum((torch.sum(torch.square(g.float())) for g in gs),
                       zero_)

        split: Dict[Any, List[torch.Tensor]] = {}   # in leaf order
        whole = []
        for g, place in zip(grads, self._places):
            m = place.master
            if m is None:
                whole.append(g)
            else:
                group = topo.world_group if len(m.levels) > 1 \
                    else m.levels[0].group
                split.setdefault(group, []).append(g)
        sq = None
        for group, gs in split.items():
            part = comm.all_reduce(sumsq(gs), group)
            sq = part if sq is None else sq + part
        return torch.sqrt(sumsq(whole) if sq is None else sq + sumsq(whole))

    @torch.no_grad()
    def _apply_update(self, grads, lr: float) -> torch.Tensor:
        """``grads *= 1/(scale·gas)``; global norm; clip; optimizer step
        (the JAX ``apply_update`` with a loss scale of one)."""
        inv = float(np.float32(1.0) / np.float32(
            self.gradient_accumulation_steps_value))
        for g in grads:
            g.mul_(inv)
        grad_norm = self._grad_norm(grads)
        clip = self.config.gradient_clipping
        if clip and clip > 0:
            coef = torch.clamp(clip / (grad_norm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(coef)
        self.optimizer.update(_unflatten(self._masters, grads), self.opt_state,
                              self._masters, lr)
        # a param whose state is split further: gather the stepped slices
        # (under hpZ over the outer group, into the param's inner slice)
        for place, p, m in zip(self._places, tree_leaves(self.params),
                               tree_leaves(self._masters)):
            if place.rel is not None:
                p.copy_(place.rel.gather(m))
        return grad_norm

    # ------------------------------------------------------------------
    # Public API (DeepSpeed parity)
    # ------------------------------------------------------------------
    def train_batch(self, data) -> torch.Tensor:
        """One full train batch (gas micro-batches + optimizer step);
        returns the mean micro-batch loss as a 0-dim fp32 tensor."""
        batch_stack = self._seq_shard(self._data_shard(
            self._stack_micro_batches(data), row_axis=1), seq_axis=2)
        lr = float(self.lr_scheduler(self.global_steps))
        gas = self.gradient_accumulation_steps_value
        if self._onebit is not None:
            # the compressed step (JAX _train_batch_onebit): no grad norm
            loss = self._onebit(self.params, self._onebit_state, [
                self._to_device({k: v[i] for k, v in batch_stack.items()})
                for i in range(gas)], lr)
            metrics = {"loss": loss}
        else:
            grads, loss_sum = self._accum_grads(batch_stack)
            grad_norm = self._apply_update(grads, lr)
            metrics = {"loss": loss_sum / gas, "grad_norm": grad_norm}
        self.global_steps += 1
        self.micro_steps += gas
        self.lr_scheduler.step()
        self._after_step(metrics)
        return metrics["loss"]

    def eval_batch(self, batch: Batch) -> torch.Tensor:
        batch = self._seq_shard(self._data_shard(batch, row_axis=0),
                                seq_axis=1)
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

    @property
    def skipped_steps(self) -> int:
        return int(self.loss_scale_state["skipped"])

    # ------------------------------------------------------------------
    # Checkpointing (checkpoint/: the pickle, fast and decoupled engines
    # and the universal format)
    # ------------------------------------------------------------------
    @property
    def checkpoint_engine(self):
        """The writer ``checkpoint.writer.type`` names: ``"fast"``,
        ``"decoupled"``, or the pickle engine (``""``), as the JAX engine
        chooses (its ``"orbax"`` and ``async_save`` raise in the
        config).  A writer named anew in the config replaces the last one
        once that one's write has landed."""
        from deepspeed_tpu_torch.checkpoint.engine import \
            PickleCheckpointEngine
        from deepspeed_tpu_torch.checkpoint.fast_engine import (
            DecoupledCheckpointEngine, FastCheckpointEngine)

        writer = {"fast": FastCheckpointEngine,
                  "decoupled": DecoupledCheckpointEngine}.get(
            self.config.checkpoint_config.writer_type, PickleCheckpointEngine)
        if type(self._checkpoint_engine) is not writer:
            if self._checkpoint_engine is not None:
                self._checkpoint_engine.wait()
            self._checkpoint_engine = writer()
        return self._checkpoint_engine

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict] = None) -> None:
        """Save params, optimizer state, scheduler and counters under
        ``save_dir/<tag>`` (default ``global_step<N>``) and point
        ``latest`` at it.  Every rank of the engine's world must call it;
        a failed write raises on every rank (the decoupled writer's, from
        its ``wait``)."""
        self.checkpoint_engine.save(
            self, save_dir, tag or f"global_step{self.global_steps}",
            client_state=client_state or {})

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True):
        """Load what ``save_checkpoint`` wrote (``tag=None``: the one
        ``latest`` names) or, with ``load_universal_checkpoint``, a
        universal checkpoint (``load_dir`` the universal dir itself or a
        root whose tags hold one).  Returns ``(path, client_state)``.  (The
        JAX engine then pushes the state into its offload store,
        ``_sync_store_after_load``; the port has no offload store until
        Queue A item 7.)"""
        if self.config.load_universal_checkpoint:
            from deepspeed_tpu_torch.checkpoint.universal import (
                load_universal, resolve_universal_dir)

            load_universal(self, resolve_universal_dir(load_dir, tag))
            return load_dir, {}
        return self.checkpoint_engine.load(
            self, load_dir, tag=tag,
            load_optimizer_states=load_optimizer_states,
            load_lr_scheduler_states=load_lr_scheduler_states)

    def _opt_state_template(self):
        """The optimizer state as the JAX optax chain lays it out, each
        leaf a :class:`~deepspeed_tpu_torch.checkpoint.engine.LeafSpec` of
        its full shape: the template a universal load checks against."""
        return nest({leaf.name[len("optimizer/"):]: LeafSpec(
            leaf.shape, numpy_dtype(leaf.tensor.dtype))
            for leaf in self._checkpoint_leaves(optimizer=True)
            if leaf.name.startswith("optimizer/")})

    def _checkpoint_leaves(self, optimizer: bool = True) -> List[CkptLeaf]:
        """Every saved leaf of this rank:
        ``module/<path>`` for each master param, and with ``optimizer``
        the state under the JAX chain's names (``optimizer/0/.count``,
        ``optimizer/0/.mu/<path>``), each with its :class:`zero.Split` in
        the full leaf (None: whole) and its full shape."""
        paths = []
        tree_map_with_path(lambda p, _x: paths.append("/".join(p)),
                           self.params)
        shapes = [tuple(getattr(p, "ds_full_shape", p.shape))
                  for p in self._leaves]
        out = [CkptLeaf("module/" + path, p, place.param, shape)
               for path, p, place, shape in zip(
                   paths, self._leaves, self._places, shapes)]
        if optimizer:
            names = chain_names(self.optimizer)
            out.append(CkptLeaf("optimizer/" + names["count"],
                                self.opt_state["count"], None, ()))
            for key in self.optimizer.moments:
                # a moment is split where its master is
                for path, place, shape, m in zip(
                        paths, self._places, shapes,
                        tree_leaves(self.opt_state[key])):
                    out.append(CkptLeaf(f"optimizer/{names[key]}/{path}", m,
                                        place.master, shape))
        return out

    @torch.no_grad()
    def _load_leaves(self, flat: Dict[str, np.ndarray],
                     optimizer: bool = True) -> None:
        """Copy full saved leaves (``{name: array}``) into this rank's
        tensors, in place on their device: each rank keeps its slice of the
        leaf's split.  Every leaf is checked (presence, shape, dtype) before
        any is changed."""
        pairs = check_leaves(self._checkpoint_leaves(optimizer=optimizer),
                             flat)
        for leaf, arr in pairs:
            src = torch.from_numpy(np.asarray(arr))
            if leaf.split is not None:
                src = leaf.split.slice(src)
            leaf.tensor.copy_(src.to(leaf.tensor.dtype))
        # a param whose optimizer state is split further steps a slice copy
        # of itself: refresh it from the loaded param
        for place, p, m in zip(self._places, tree_leaves(self.params),
                               tree_leaves(self._masters)):
            if m is not p:
                m.copy_(place.rel.slice(p))
