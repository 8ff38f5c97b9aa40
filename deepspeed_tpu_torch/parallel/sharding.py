"""Parameter sharding rules — compatibility shim over
:mod:`deepspeed_tpu_torch.resilience.oracle`, as in the JAX package:
``ShardingRules`` is the :class:`PartitionOracle` under its historical
name, so there is one derivation of the partitioning only."""

from __future__ import annotations

from deepspeed_tpu_torch.resilience.oracle import (DEFAULT_RULES,  # noqa: F401
                                                   PartitionOracle,
                                                   ShardingRules, path_str)

__all__ = ["ShardingRules", "PartitionOracle", "DEFAULT_RULES", "path_str"]
