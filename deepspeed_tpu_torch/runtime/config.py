"""DeepSpeed JSON config → typed config objects, for the port's training path.

Port of ``deepspeed_tpu/runtime/config.py`` over the keys the training
path reads: the batch triple, ``optimizer``, ``scheduler``, ``bf16``,
``gradient_clipping``, ``zero_optimization.stage``,
``.param_persistence_threshold``, ``.reduce_bucket_size`` (the flat
buckets of the gradient reduction), ``.prefetch_bucket_size``,
``.zero_quantized_weights`` (qwZ), ``.zero_quantized_gradients`` (qgZ),
``.zero_hpz_partition_size`` (hpZ) and ``.mics_shard_size`` (MiCS),
``activation_checkpointing.remat_policy``,
the ``checkpoint`` block's writer and ``load_universal`` (and
``load_universal_checkpoint``), ``steps_per_print``, ``seed``, ``dataloader_drop_last``, the ``mesh``'s
``data`` and ``seq`` axes (or ``sequence_parallel_size``; every other axis
1) and the ``step_schedule`` keys
``ring_interleave``, ``fused_gather_matmul``,
``param_persistence_threshold``, ``gather_prefetch_depth``,
``prefetch_bucket_size``, ``weight_update`` and ``fused_reduce_scatter``,
and ``comm_quantization`` (``grad_reduce``, ``ring_rotation`` and
``zero3_gather`` run).  Those keys get the JAX config's
rejections (:class:`DeepSpeedConfigError`: inconsistent batch sizes, a ZeRO
stage outside [0, 3], fp16 together with bf16).  A key that turns on a
feature the port has not got yet raises ``NotImplementedError`` naming the
ROADMAP item that brings it.  Any other key of the ``fp16``, ``bf16``,
``zero_optimization`` and ``activation_checkpointing`` blocks (the
all-gather bucket size, overlap knobs, loss-scale settings
of a disabled fp16) is logged as
ignored: none of them changes the numbers of a step.
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional, Union

from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.utils.logging import logger


class DeepSpeedConfigError(Exception):
    pass


def not_ported(what: str, item: str):
    """The error for a config value whose feature is not ported yet."""
    return NotImplementedError(f"{what} is not ported to deepspeed_tpu_torch "
                               f"yet (ROADMAP {item})")


def _from_dict(cls, data: Optional[Dict[str, Any]], context: str):
    data = data or {}
    if not isinstance(data, dict):
        raise DeepSpeedConfigError(f"'{context}' must be a dict, got {type(data)}")
    valid = {f.name for f in fields(cls)}
    for k in data:
        if k not in valid:
            logger.warning(f"Config: ignoring key '{k}' in '{context}' "
                           "(not read by deepspeed_tpu_torch)")
    return cls(**{k: v for k, v in data.items() if k in valid})


@dataclass
class OptimizerConfig:
    """``"optimizer": {"type": ..., "params": {...}}``"""
    type: str = C.ADAMW_OPTIMIZER
    params: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.type = self.type.lower()

    @property
    def lr(self) -> float:
        return float(self.params.get("lr", 1e-3))


@dataclass
class SchedulerConfig:
    """``"scheduler": {"type": ..., "params": {...}}``"""
    type: str = "WarmupLR"
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class FP16Config:
    enabled: bool = False


@dataclass
class BF16Config:
    enabled: bool = False


@dataclass
class ZeroConfig:
    """The ``zero_optimization`` keys the port reads or rejects: stages 0
    to 3 run (over the data and seq axes, ``runtime/engine.py``), with the
    ZeRO-3 ``param_persistence_threshold`` (elements a parameter; smaller
    ones stay gathered, ``resilience/oracle.py``); the gradient reduction
    goes through flat buckets of at most ``reduce_bucket_size`` elements
    (DeepSpeed's default, as in the JAX config), always contiguous:
    ``contiguous_gradients`` false is logged as ignored, as the JAX config
    accepts it and XLA decides the layout there.  ``zero_quantized_weights``
    (qwZ: the ZeRO-3 gather on the int8 wire, ``parallel/zeropp.py``)
    runs; ``prefetch_bucket_size`` (the JAX default, 50,000,000) is
    accepted, validated and reported, and bounds nothing: the JAX package
    reads it nowhere outside its config and autotuner either, the window
    of ``step_schedule.gather_prefetch_depth`` decides what is issued
    ahead.  ``zero_quantized_gradients`` (qgZ) is read by the engine,
    whose gate decides where it runs (``runtime/onebit.py``), as the JAX
    engine's does.  ``zero_hpz_partition_size`` (hpZ) and
    ``mics_shard_size`` (MiCS) factor the data axis (the engine,
    ``parallel/topology.py``); ``zero_quantized_nontrainable_weights`` and
    ``mics_hierarchical_params_gather`` are accepted and logged as
    ignored, as the JAX package reads them nowhere.  Offload raises."""
    stage: int = 0
    param_persistence_threshold: int = 100_000
    reduce_bucket_size: int = 500_000_000
    prefetch_bucket_size: int = 50_000_000
    contiguous_gradients: bool = True
    offload_param: Optional[Dict[str, Any]] = None
    offload_optimizer: Optional[Dict[str, Any]] = None
    cpu_offload: Optional[bool] = None
    cpu_offload_params: Optional[bool] = None
    zero_hpz_partition_size: int = 1
    zero_quantized_weights: bool = False
    zero_quantized_nontrainable_weights: bool = False
    zero_quantized_gradients: bool = False
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False

    def __post_init__(self):
        if not 0 <= self.stage <= 3:
            raise DeepSpeedConfigError(
                f"zero_optimization.stage must be in [0,3], got {self.stage}")
        if int(self.param_persistence_threshold) < 0:
            raise DeepSpeedConfigError(
                "zero_optimization.param_persistence_threshold must be >= 0")
        self.param_persistence_threshold = int(self.param_persistence_threshold)
        if int(self.reduce_bucket_size) < 1:
            raise DeepSpeedConfigError(
                "zero_optimization.reduce_bucket_size must be >= 1")
        self.reduce_bucket_size = int(self.reduce_bucket_size)
        self.prefetch_bucket_size = int(self.prefetch_bucket_size)
        self.zero_quantized_weights = bool(self.zero_quantized_weights)
        if not self.contiguous_gradients:
            logger.warning("Config: ignoring zero_optimization."
                           "contiguous_gradients=false (the gradients are "
                           "always laid out in their flat buckets)")
        for name, off in (("offload_param", self.offload_param),
                          ("offload_optimizer", self.offload_optimizer)):
            if off and (off.get("device", "none") != "none"):
                raise not_ported(f"zero_optimization.{name}",
                                 "Queue A item 7")
        if self.cpu_offload or self.cpu_offload_params:
            raise not_ported("zero_optimization.cpu_offload", "Queue A item 7")
        self.zero_quantized_gradients = bool(self.zero_quantized_gradients)
        self.zero_hpz_partition_size = int(self.zero_hpz_partition_size)
        self.mics_shard_size = int(self.mics_shard_size)
        for name in ("zero_quantized_nontrainable_weights",
                     "mics_hierarchical_params_gather"):
            if getattr(self, name):
                logger.warning(f"Config: zero_optimization.{name} is read "
                               "and ignored (the JAX package reads it "
                               "nowhere either)")


# the JAX config's remat policy names; the port runs the first three
REMAT_POLICIES = ("none", "full", "nothing_saveable", "dots_saveable",
                  "dots_flash_saveable", "flash_saveable",
                  "dots_with_no_batch_dims_saveable", "offload_dots")


@dataclass
class ActivationCheckpointingConfig:
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    remat_policy: str = "nothing_saveable"

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise DeepSpeedConfigError(
                f"activation_checkpointing.remat_policy={self.remat_policy!r}"
                f": expected one of {REMAT_POLICIES}")
        if self.remat_policy not in ("none", "full", "nothing_saveable"):
            raise not_ported(
                f"the {self.remat_policy!r} remat policy (selective "
                "activation checkpointing)", "Queue A item 13")
        if self.cpu_checkpointing:
            raise not_ported("activation_checkpointing.cpu_checkpointing",
                             "Queue A item 13")


# top-level blocks whose feature is not ported: key -> (is it switched on,
# ROADMAP item).  A block present but switched off is accepted.
def _enabled(block) -> bool:
    if isinstance(block, dict):
        return bool(block.get("enabled", True)) and bool(block)
    return bool(block)


_UNPORTED_BLOCKS = {
    "torch_autocast": (_enabled, "Queue A item 3 (torch_autocast)"),
    "sparse_gradients": (bool, "Queue A item 11"),
    "compression_training": (lambda b: bool(b), "Queue A item 11"),
    "data_efficiency": (_enabled, "Queue A item 11"),
    "curriculum_learning": (_enabled, "Queue A item 11"),
    "progressive_layer_drop": (_enabled, "Queue A item 11"),
    "telemetry": (_enabled, "Queue A item 12"),
    "flops_profiler": (_enabled, "Queue A item 12"),
    "tensorboard": (_enabled, "Queue A item 12"),
    "wandb": (_enabled, "Queue A item 12"),
    "csv_monitor": (_enabled, "Queue A item 12"),
    "comet": (_enabled, "Queue A item 12"),
    "elasticity": (_enabled, "Queue A item 12"),
}


@dataclass
class CommQuantizationConfig:
    """``"comm_quantization"``: a wire dtype per collective (the JAX
    config's block).  ``ring_rotation`` (``fp32``, ``int8`` or ``fp8``)
    runs: the ring's K/V and traveling dk/dv move as block-quantized
    payloads with fp32 row scales (``sequence/ring.py``); the engine sets
    it on the model over a seq axis.  ``zero3_gather`` runs: the ZeRO-3
    weight gather moves the payload and block scales of ``group_size``
    blocks (qwZ, ``parallel/zeropp.py``).  ``grad_reduce`` runs: with the
    block enabled, the engine's gate (the JAX engine's) sends the data
    axis's gradient reduction through one explicit
    ``comm/quantized.py`` ``quantized_all_reduce`` of that wire, fp32
    spelled out included, with ``error_feedback`` carrying the first
    send's residual to the next step.  The ``collectives`` dict is the
    same choice spelled per collective; unknown collective names and wire
    dtypes are rejected as in JAX."""
    enabled: bool = False
    grad_reduce: str = "fp32"
    zero3_gather: str = "fp32"
    ring_rotation: str = "fp32"
    group_size: int = 256
    error_feedback: bool = True
    collectives: Optional[Dict[str, str]] = None

    COLLECTIVES = ("grad_reduce", "zero3_gather", "ring_rotation")
    WIRE_DTYPES = ("fp32", "int8", "fp8")

    def __post_init__(self):
        if self.collectives is not None:
            if not isinstance(self.collectives, dict):
                raise DeepSpeedConfigError(
                    "comm_quantization.collectives must be a dict of "
                    "{collective: wire_dtype}")
            for name, dtype in self.collectives.items():
                if name not in self.COLLECTIVES:
                    raise DeepSpeedConfigError(
                        f"comm_quantization.collectives: unknown collective "
                        f"{name!r} (known: {list(self.COLLECTIVES)})")
                setattr(self, name, dtype)
        for name in self.COLLECTIVES:
            val = str(getattr(self, name)).lower()
            if val not in self.WIRE_DTYPES:
                raise DeepSpeedConfigError(
                    f"comm_quantization.{name} must be one of "
                    f"{list(self.WIRE_DTYPES)}, got {val!r}")
            setattr(self, name, val)
        if int(self.group_size) <= 0:
            raise DeepSpeedConfigError(
                f"comm_quantization.group_size must be positive, got "
                f"{self.group_size}")
        self.group_size = int(self.group_size)
        self.error_feedback = bool(self.error_feedback)


@dataclass
class CheckpointConfig:
    """``"checkpoint"``: the writer the engine saves through
    (``runtime/engine.py`` ``checkpoint_engine``) and ``load_universal``.
    ``writer.type`` ``""`` (the pickle engine), ``"fast"`` and
    ``"decoupled"`` run (``checkpoint/``); ``"orbax"`` and ``async_save``
    raise: the JAX package routes both to its orbax engine, a JAX library
    (``deepspeed_tpu/runtime/engine.py:2582-2585``), whose role a sharded
    asynchronous writer takes (ROADMAP Queue A item 7).  The JAX block's
    ``tag_validation``, ``use_node_local_storage`` and
    ``parallel_write_pipeline`` are read by nothing there either: logged
    as ignored."""
    load_universal: bool = False
    async_save: bool = False
    writer: Optional[Dict[str, Any]] = None

    WRITERS = ("", "fast", "decoupled")

    def __post_init__(self):
        writer = self.writer or {}
        if not isinstance(writer, dict):
            raise DeepSpeedConfigError("checkpoint.writer must be a dict "
                                       "like {\"type\": \"fast\"}")
        self.writer_type = str(writer.get("type", "") or "")
        unread = sorted(set(writer) - {"type"})
        if unread:
            logger.warning(f"Config: ignoring keys {unread} in "
                           "'checkpoint.writer' (not read by "
                           "deepspeed_tpu_torch)")
        if self.writer_type == "orbax" or self.async_save:
            raise not_ported("checkpoint writer 'orbax' and async_save (the "
                             "JAX package's orbax engine); a sharded "
                             "asynchronous writer takes its role",
                             "Queue A item 7")
        if self.writer_type not in self.WRITERS:
            raise DeepSpeedConfigError(
                f"checkpoint.writer.type={self.writer_type!r}: expected one "
                f"of {list(self.WRITERS) + ['orbax']}")
        self.load_universal = bool(self.load_universal)


@dataclass
class StepScheduleConfig:
    """``step_schedule``: the port reads ``ring_interleave`` (1 or 2, the
    JAX ring's hop order; accepted, and the port's ring runs attend then
    rotate for both, ``sequence/ring.py``), ``fused_gather_matmul`` (the
    ZeRO-3 fused gather-matmul MLP; the engine's gate decides whether it
    runs, as the JAX engine's does), ``param_persistence_threshold`` (None
    keeps the ``zero_optimization`` value; a value wins over it, as in the
    JAX ``PartitionOracle.from_config``), ``gather_prefetch_depth`` (at
    least 1: the ZeRO-3 gathers of the next depth - 1 layers are issued
    while a layer runs, ``zero.Window``; the engine clamps it to a divisor
    of the layer count, as the JAX engine clamps its scan unroll) and
    ``prefetch_bucket_size`` (positive or None; accepted, validated and
    reported, and, as in the JAX package, which reads it nowhere outside
    its config and autotuner, it bounds nothing in the schedule),
    ``weight_update`` (``"fused"``, the stage's own layout, or
    ``"decomposed"``: the optimizer state and the gradient accumulator split
    over the ZeRO world at stages 0-1 too) and ``fused_reduce_scatter``
    (with the decomposed update, one reduce-scatter a bucket after the
    last micro-step's backward); the engine's gates decide whether the
    last two run, as the JAX engine's do.  The block's other keys are
    accepted at their defaults and raise when they ask for something else
    (``_UNPORTED_SCHEDULE``)."""
    ring_interleave: int = 1
    fused_gather_matmul: bool = False
    param_persistence_threshold: Optional[int] = None
    gather_prefetch_depth: int = 1
    prefetch_bucket_size: Optional[int] = None
    weight_update: str = "fused"
    fused_reduce_scatter: bool = False

    RING_INTERLEAVES = (1, 2)
    WEIGHT_UPDATES = ("fused", "decomposed")

    def __post_init__(self):
        if self.weight_update not in self.WEIGHT_UPDATES:
            raise DeepSpeedConfigError(
                f"step_schedule.weight_update must be one of "
                f"{list(self.WEIGHT_UPDATES)}, got {self.weight_update!r}")
        self.fused_reduce_scatter = bool(self.fused_reduce_scatter)
        if int(self.ring_interleave) not in self.RING_INTERLEAVES:
            raise DeepSpeedConfigError(
                f"step_schedule.ring_interleave must be one of "
                f"{list(self.RING_INTERLEAVES)}, got {self.ring_interleave}")
        self.ring_interleave = int(self.ring_interleave)
        self.fused_gather_matmul = bool(self.fused_gather_matmul)
        if int(self.gather_prefetch_depth) < 1:
            raise DeepSpeedConfigError(
                "step_schedule.gather_prefetch_depth must be >= 1, got "
                f"{self.gather_prefetch_depth}")
        self.gather_prefetch_depth = int(self.gather_prefetch_depth)
        if self.param_persistence_threshold is not None:
            if int(self.param_persistence_threshold) < 0:
                raise DeepSpeedConfigError(
                    "step_schedule.param_persistence_threshold must be >= 0")
            self.param_persistence_threshold = \
                int(self.param_persistence_threshold)
        if self.prefetch_bucket_size is not None:
            if int(self.prefetch_bucket_size) <= 0:
                raise DeepSpeedConfigError(
                    "step_schedule.prefetch_bucket_size must be positive")
            self.prefetch_bucket_size = int(self.prefetch_bucket_size)


# the JAX step_schedule keys the port has no actuator for: key -> (its
# default, ROADMAP item)
_UNPORTED_SCHEDULE = {
    "mode": ("static", "Queue A item 12"),
    "probe_steps": (3, "Queue A item 12"),
    "overlap_threshold": (0.5, "Queue A item 12"),
    "decisions": (None, "Queue A item 12"),
}


def _step_schedule(block) -> StepScheduleConfig:
    block = dict(block or {})
    read = {f.name for f in fields(StepScheduleConfig)}
    for key in sorted(set(block) - read):
        default, item = _UNPORTED_SCHEDULE.get(key, (object(), "Queue A item 12"))
        if block[key] != default:
            raise not_ported(f"step_schedule.{key}={block[key]!r}", item)
    return StepScheduleConfig(**{k: v for k, v in block.items() if k in read})


def _check_world(d: Dict[str, Any]) -> Dict[str, int]:
    """The port's parallel axes are ``data`` (data parallelism and ZeRO)
    and ``seq`` (ring sequence parallelism; ``sequence_parallel_size``
    stands for it when the mesh does not name it, as in the JAX config),
    either or both above one.  Any other mesh axis, tensor, pipeline
    or expert parallel size above one raises.  Returns ``{"data": ...,
    "seq": ...}`` with ``data`` resolved (``parallel/topology.py``)."""
    mesh = dict(d.get(C.MESH) or {})
    if "seq" not in mesh and d.get(C.SEQUENCE_PARALLEL_SIZE):
        mesh["seq"] = int(d[C.SEQUENCE_PARALLEL_SIZE])
    seq = int(mesh.pop("seq", 1))
    if seq < 1:
        raise DeepSpeedConfigError(f"mesh.seq must be >= 1, got {seq}")
    data = int(mesh.pop("data", -1))
    if data < 1 and data != -1:
        raise DeepSpeedConfigError(f"mesh.data must be >= 1 or -1, got {data}")
    sizes = {k: v for k, v in mesh.items() if v not in (1, -1)}
    tp = d.get(C.TENSOR_PARALLEL) or {}
    for key, size in (("tensor_parallel", tp.get("autotp_size",
                                                 tp.get("tp_size", 1))),
                      ("pipeline", (d.get(C.PIPELINE) or {}).get("stages", 1)),
                      (C.EXPERT_PARALLEL_SIZE,
                       d.get(C.EXPERT_PARALLEL_SIZE, 1))):
        if (size or 1) > 1:
            sizes[key] = size
    if sizes:
        raise not_ported(f"tensor, pipeline or expert parallelism "
                         f"({sizes})", "Queue A item 10")
    from deepspeed_tpu_torch.parallel.topology import resolve_data_axis

    return {"data": resolve_data_axis({"data": data, "seq": seq}), "seq": seq}


class DeepSpeedConfig:
    """Parsed and validated config (JSON path or dict).  The data-parallel
    world is the data axis (the ranks of a seq axis share each batch row),
    so ``train_batch_size == micro * gas * dp``."""

    def __init__(self, config: Union[str, Dict[str, Any], None]):
        if config is None:
            config = {}
        if isinstance(config, str):
            with open(config, "r") as f:
                config = json.load(f)
        if not isinstance(config, dict):
            raise DeepSpeedConfigError(
                f"config must be a dict or JSON path, got {type(config)}")
        self._param_dict = copy.deepcopy(config)
        d = self._param_dict

        self.train_batch_size: Optional[int] = d.get(C.TRAIN_BATCH_SIZE)
        self.train_micro_batch_size_per_gpu: Optional[int] = d.get(
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        self.gradient_accumulation_steps: Optional[int] = d.get(
            C.GRADIENT_ACCUMULATION_STEPS)

        opt = d.get(C.OPTIMIZER)
        self.optimizer: Optional[OptimizerConfig] = (
            _from_dict(OptimizerConfig, opt, "optimizer")
            if opt is not None else None)
        sched = d.get(C.SCHEDULER)
        self.scheduler: Optional[SchedulerConfig] = (
            _from_dict(SchedulerConfig, sched, "scheduler")
            if sched is not None else None)
        self.fp16 = _from_dict(FP16Config, d.get(C.FP16), "fp16")
        self.bf16 = _from_dict(BF16Config, d.get(C.BFLOAT16,
                                                 d.get(C.BFLOAT16_OLD)),
                               "bf16")
        if self.fp16.enabled and self.bf16.enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        if self.fp16.enabled:
            raise not_ported("fp16 with loss scaling",
                             "Queue A item 3 (fp16 loss scaling)")
        self.zero_config = _from_dict(ZeroConfig, d.get(C.ZERO_OPTIMIZATION),
                                      "zero_optimization")
        self.activation_checkpointing = _from_dict(
            ActivationCheckpointingConfig, d.get(C.ACTIVATION_CHECKPOINTING),
            "activation_checkpointing")
        world = _check_world(d)
        self.seq_parallel_size: int = world["seq"]
        self.world_size: int = world["data"]
        self.step_schedule = _step_schedule(d.get("step_schedule"))
        self.comm_quantization = _from_dict(
            CommQuantizationConfig, d.get("comm_quantization"),
            "comm_quantization")
        self.checkpoint_config = _from_dict(CheckpointConfig,
                                            d.get(C.CHECKPOINT), "checkpoint")
        self.load_universal_checkpoint: bool = bool(d.get(
            C.LOAD_UNIVERSAL_CHECKPOINT, self.checkpoint_config.load_universal))
        for key, (on, item) in _UNPORTED_BLOCKS.items():
            if key in d and on(d[key]):
                raise not_ported(f"the '{key}' block", item)
        dtypes = d.get("data_types")
        if isinstance(dtypes, dict) and dtypes.get(
                "grad_accum_dtype", "fp32") != "fp32":
            raise not_ported("a grad_accum_dtype other than fp32",
                             "Queue A item 3")

        self.gradient_clipping: float = float(
            d.get(C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT))
        self.steps_per_print: int = int(
            d.get(C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT))
        self.dataloader_drop_last: bool = bool(
            d.get(C.DATALOADER_DROP_LAST, False))
        self.seed: int = int(d.get("seed", 42))
        self._resolve_batch_sizes()

    @property
    def zero_optimization_stage(self) -> int:
        return self.zero_config.stage

    def _resolve_batch_sizes(self) -> None:
        """The JAX config's resolution rules over the data-parallel world:
        train == micro * gas * world; any one may be inferred."""
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        world = self.world_size
        if train is not None and micro is not None and gas is not None:
            pass
        elif train is not None and micro is not None:
            if train % (micro * world) != 0:
                raise DeepSpeedConfigError(
                    f"train_batch_size {train} not divisible by "
                    f"micro_batch*world {micro * world}")
            gas = train // (micro * world)
        elif train is not None and gas is not None:
            if train % (gas * world) != 0:
                raise DeepSpeedConfigError(
                    f"train_batch_size {train} not divisible by gas*world "
                    f"{gas * world}")
            micro = train // (gas * world)
        elif micro is not None:
            gas = gas or C.GRADIENT_ACCUMULATION_STEPS_DEFAULT
            train = micro * gas * world
        elif train is not None:
            if train % world != 0:
                raise DeepSpeedConfigError(
                    f"train_batch_size {train} not divisible by world "
                    f"{world}")
            gas, micro = 1, train // world
        else:
            raise DeepSpeedConfigError(
                "At least one of train_batch_size / "
                "train_micro_batch_size_per_gpu must be set")
        if train != micro * gas * world:
            raise DeepSpeedConfigError(
                f"Inconsistent batch config: train_batch_size={train} != "
                f"micro({micro}) * gas({gas}) * dp_world({world})")
        self.train_batch_size = int(train)
        self.train_micro_batch_size_per_gpu = int(micro)
        self.gradient_accumulation_steps = int(gas)

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._param_dict)
