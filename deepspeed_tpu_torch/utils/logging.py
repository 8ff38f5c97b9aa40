"""Rank-aware logging for deepspeed_tpu_torch.

Copy of ``deepspeed_tpu/utils/logging.py`` without JAX: a singleton
``logger`` plus ``log_dist``, which filters by the torch.distributed rank
(0 when no process group is initialised) where the JAX package reads the
JAX process index.
"""

from __future__ import annotations

import functools
import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


@functools.lru_cache(None)
def _create_logger(name: str = "deepspeed_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    logger_ = logging.getLogger(name)
    logger_.setLevel(level)
    logger_.propagate = False
    if not logger_.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(
            logging.Formatter(
                "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s",
                datefmt="%Y-%m-%d %H:%M:%S",
            ))
        logger_.addHandler(handler)
    return logger_


_default_level = LOG_LEVELS.get(os.environ.get("DSTPU_LOG_LEVEL", "info").lower(), logging.INFO)
logger = _create_logger(level=_default_level)


def _process_index() -> int:
    """Current process index; 0 in single-process mode.

    Lazy so that importing logging never forces distributed init.
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks=None, level=logging.INFO) -> None:
    """Log ``message`` only on the given process ranks (default: rank 0).

    ``ranks=[-1]`` logs on every process. Mirrors the reference ``log_dist``
    (deepspeed/utils/logging.py) with process-index semantics.  ``level``
    may be an int or a level name ("warning").
    """
    if isinstance(level, str):
        resolved = logging.getLevelName(level.upper())
        if not isinstance(resolved, int):
            raise ValueError(f"unknown log level name {level!r}")
        level = resolved
    ranks = ranks or [0]
    my_rank = _process_index()
    if my_rank in ranks or -1 in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


def warning_once(message: str) -> None:
    _warn_cached(message)


@functools.lru_cache(None)
def _warn_cached(message: str) -> None:
    logger.warning(message)


def should_log_le(max_log_level_str: str) -> bool:
    if not isinstance(max_log_level_str, str):
        raise ValueError("max_log_level_str must be a string")
    max_log_level_str = max_log_level_str.lower()
    if max_log_level_str not in LOG_LEVELS:
        raise ValueError(f"{max_log_level_str} is not one of the logging levels")
    return logger.getEffectiveLevel() <= LOG_LEVELS[max_log_level_str]
