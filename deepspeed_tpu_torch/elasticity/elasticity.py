"""Elastic training configuration (a copy of
``deepspeed_tpu/elasticity/elasticity.py``, pure Python).

Analog of the reference's elasticity v1 (``elasticity/elasticity.py``):
pre-compute the set of device counts at which a job can (re)start while
keeping the SAME effective batch size, so a job that lost ranks resumes
on fewer (or more) with identical optimization behaviour (ref
_get_compatible_gpus_v01 :83, compute_elastic_config :233).  The restart
itself reloads the universal checkpoint
(``deepspeed_tpu_torch/checkpoint/universal.py``) at the new data axis.
The config's ``elasticity`` block still raises in the port's engine
(ROADMAP Queue A item 12).
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Tuple

LATEST_ELASTICITY_VERSION = 0.2
MINIMUM_DEEPSPEED_VERSION = "0.1.0"


class ElasticityError(Exception):
    pass


class ElasticityConfigError(ElasticityError):
    pass


class ElasticityIncompatibleWorldSize(ElasticityError):
    pass


class ElasticityConfig:
    """Parsed `elasticity` config block (ref elasticity/config.py).

    Keys: enabled, max_train_batch_size, micro_batch_sizes, min_gpus,
    max_gpus, min_time, prefer_larger_batch, ignore_non_elastic_batch_info,
    version; v2 adds model_parallel_size / num_gpus_per_node.
    """

    def __init__(self, d: Dict[str, Any]):
        self.enabled = bool(d.get("enabled", False))
        self.max_train_batch_size = int(d.get("max_train_batch_size", 2000))
        self.micro_batches = [int(m) for m in d.get("micro_batch_sizes", [2, 4, 6])]
        if any(m <= 0 for m in self.micro_batches):
            raise ElasticityConfigError("micro_batch_sizes must be positive")
        self.min_gpus = int(d.get("min_gpus", 1))
        self.max_gpus = int(d.get("max_gpus", 10000))
        if self.min_gpus < 1 or self.max_gpus < self.min_gpus:
            raise ElasticityConfigError(
                f"invalid gpu range [{self.min_gpus}, {self.max_gpus}]")
        self.min_time = int(d.get("min_time", 0))
        self.version = float(d.get("version", LATEST_ELASTICITY_VERSION))
        self.prefer_larger_batch = bool(d.get("prefer_larger_batch", True))
        self.ignore_non_elastic_batch_info = bool(
            d.get("ignore_non_elastic_batch_info", False))
        self.model_parallel_size = int(d.get("model_parallel_size", 1))
        self.num_gpus_per_node = int(d.get("num_gpus_per_node", 1))


def get_valid_gpus(batch_size: int, micro_batches: List[int],
                   min_valid_gpus: int, max_valid_gpus: int) -> List[int]:
    """All chip counts that evenly tile `batch_size` with some micro batch.

    Ref: _get_valid_gpus (elasticity.py:63).
    """
    valid = set()
    for mb in micro_batches:
        if batch_size % mb != 0:
            continue
        max_gpus = batch_size // mb
        for i in range(1, max_gpus + 1):
            if max_gpus % i == 0 and min_valid_gpus <= i <= max_valid_gpus:
                valid.add(i)
    return sorted(valid)


def get_compatible_gpus_v01(micro_batches: List[int],
                            max_acceptable_batch_size: int,
                            min_gpus: int = 1,
                            max_gpus: int = 10000,
                            prefer_larger: bool = True
                            ) -> Tuple[int, List[int]]:
    """Pick the final batch size ≤ max with the largest set of valid chip
    counts. Ref: _get_compatible_gpus_v01 (elasticity.py:83)."""
    if not micro_batches:
        raise ElasticityConfigError("micro_batch_sizes is empty")
    if max(micro_batches) > max_acceptable_batch_size:
        raise ElasticityConfigError(
            f"micro batch {max(micro_batches)} exceeds "
            f"max_train_batch_size {max_acceptable_batch_size}")
    base = math.lcm(*micro_batches)
    if base <= max_acceptable_batch_size:
        candidate_batches = list(range(base, max_acceptable_batch_size + 1, base))
    else:
        # No batch is a multiple of every micro batch; fall back to multiples
        # of each micro batch individually, still under the cap.
        candidate_batches = sorted({m * i for m in micro_batches
                                    for i in range(1, max_acceptable_batch_size // m + 1)})

    best_batch, best_gpus = 0, []
    for b in candidate_batches:
        gpus = get_valid_gpus(b, micro_batches, min_gpus, max_gpus)
        better = (len(gpus), b if prefer_larger else -b) > \
                 (len(best_gpus), best_batch if prefer_larger else -best_batch)
        if better:
            best_batch, best_gpus = b, gpus
    if not best_gpus:
        raise ElasticityConfigError(
            f"no valid chip count in [{min_gpus},{max_gpus}] for "
            f"batch ≤ {max_acceptable_batch_size} with micro batches {micro_batches}")
    return best_batch, best_gpus


def get_compatible_gpus_v02(micro_batches, max_acceptable_batch_size,
                            current_num_gpus, min_gpus, max_gpus,
                            prefer_larger, num_gpus_per_node,
                            model_parallel_size) -> Tuple[int, List[int]]:
    """v2: chip counts must also be multiples of mp_size (whole model
    replicas). Ref: _get_compatible_gpus_v02 (elasticity.py:129)."""
    if model_parallel_size > 1:
        if num_gpus_per_node % model_parallel_size != 0:
            raise ElasticityConfigError(
                f"model_parallel_size {model_parallel_size} must divide "
                f"chips per node {num_gpus_per_node}")
    if max_gpus < model_parallel_size:
        raise ElasticityConfigError(
            f"max_gpus {max_gpus} < model_parallel_size {model_parallel_size}")
    dp_min = -(-min_gpus // model_parallel_size)  # ceil: stay ≥ min_gpus
    dp_max = max_gpus // model_parallel_size      # floor: stay ≤ max_gpus
    batch, dp_counts = get_compatible_gpus_v01(
        micro_batches, max_acceptable_batch_size, dp_min, dp_max, prefer_larger)
    return batch, [c * model_parallel_size for c in dp_counts]


def compute_elastic_config(ds_config: Dict[str, Any], target_deepspeed_version: str = "",
                           world_size: int = 0, return_microbatch: bool = False):
    """(final_batch_size, valid_gpus[, micro_batch]) for this config.

    Ref: compute_elastic_config (elasticity.py:233).  When `world_size` > 0
    also validates it and resolves the per-chip micro batch.
    """
    if "elasticity" not in ds_config:
        raise ElasticityConfigError("'elasticity' block missing from config")
    cfg = ElasticityConfig(ds_config["elasticity"])
    if not cfg.enabled:
        raise ElasticityConfigError("elasticity is not enabled")

    if cfg.version >= 0.2 and cfg.model_parallel_size > 1:
        final_batch, valid_gpus = get_compatible_gpus_v02(
            cfg.micro_batches, cfg.max_train_batch_size, world_size,
            cfg.min_gpus, cfg.max_gpus, cfg.prefer_larger_batch,
            cfg.num_gpus_per_node, cfg.model_parallel_size)
    else:
        final_batch, valid_gpus = get_compatible_gpus_v01(
            cfg.micro_batches, cfg.max_train_batch_size,
            cfg.min_gpus, cfg.max_gpus, cfg.prefer_larger_batch)

    if world_size > 0:
        dp = world_size // cfg.model_parallel_size if cfg.version >= 0.2 else world_size
        if world_size not in valid_gpus:
            raise ElasticityIncompatibleWorldSize(
                f"world size {world_size} not in valid set {valid_gpus}")
        micro = _resolve_micro_batch(final_batch, dp, cfg.micro_batches,
                                     cfg.prefer_larger_batch)
        if return_microbatch:
            return final_batch, valid_gpus, micro
    if return_microbatch:
        return final_batch, valid_gpus, None
    return final_batch, valid_gpus


def _resolve_micro_batch(batch: int, dp: int, micro_batches: List[int],
                         prefer_larger: bool) -> int:
    per_rank = batch // dp
    candidates = [m for m in sorted(micro_batches, reverse=prefer_larger)
                  if per_rank % m == 0]
    if not candidates:
        raise ElasticityIncompatibleWorldSize(
            f"no micro batch in {micro_batches} divides per-rank batch {per_rank}")
    return candidates[0]


def elasticity_enabled(ds_config: Dict[str, Any]) -> bool:
    return bool(ds_config.get("elasticity", {}).get("enabled", False))


def ensure_immutable_elastic_config(runtime_elastic_config_dict,
                                    stored_elastic_config_dict) -> None:
    """A resumed job must not silently change its elastic envelope.

    Ref: ensure_immutable_elastic_config (elasticity.py:202).
    """
    if json.dumps(runtime_elastic_config_dict, sort_keys=True) != \
            json.dumps(stored_elastic_config_dict, sort_keys=True):
        raise ElasticityConfigError(
            "elasticity config changed across restarts; set "
            "ignore_elastic_config_changes to override")
