"""Self-healing elastic training: the sharding oracle, the recovery
supervisor and its worker, and fault injection (``chaos.py``, shared with
the serving layer).

* :mod:`~deepspeed_tpu_torch.resilience.oracle`: :class:`PartitionOracle`,
  the one name-based source of every leaf's split dim, shared by the
  engine's ZeRO stages and the checkpoints (which is what lets a
  universal checkpoint saved at one data axis load at another), and
  :func:`plan_mesh`.
* :mod:`~deepspeed_tpu_torch.resilience.supervisor`: the watchdog →
  elastic agent → universal-resume recovery loop; ``worker.py`` is the
  resumable training process it runs.
"""

from deepspeed_tpu_torch.resilience.oracle import (DEFAULT_RULES,
                                                   PartitionOracle, path_str,
                                                   plan_mesh)

__all__ = ["PartitionOracle", "DEFAULT_RULES", "path_str", "plan_mesh"]
