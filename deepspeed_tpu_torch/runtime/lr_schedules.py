"""LR schedules: a copy of ``deepspeed_tpu/runtime/lr_schedules.py`` (pure
Python), with the same names and params as the reference's
``runtime/lr_schedules.py`` (LRRangeTest, OneCycle, WarmupLR,
WarmupDecayLR, WarmupCosineLR).

Schedules are host-side callables ``step -> lr``; the engine reads the
scalar each step and hands it to the optimizer.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

VALID_LR_SCHEDULES = ["LRRangeTest", "OneCycle", "WarmupLR", "WarmupDecayLR", "WarmupCosineLR"]


class LRSchedule:
    """Minimal scheduler object with the reference's step/get_lr surface."""

    def __init__(self, fn: Callable[[int], float], name: str = "custom"):
        self._fn = fn
        self.name = name
        self.last_batch_iteration = -1
        self._last_lr = [fn(0)]

    def step(self, last_batch_iteration: Optional[int] = None) -> None:
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        self._last_lr = [self._fn(max(0, last_batch_iteration))]

    def get_lr(self):
        return list(self._last_lr)

    def get_last_lr(self):
        return list(self._last_lr)

    def state_dict(self) -> Dict[str, Any]:
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.last_batch_iteration = int(sd["last_batch_iteration"])
        self._last_lr = [self._fn(max(0, self.last_batch_iteration))]

    def __call__(self, step: int) -> float:
        return self._fn(step)


def _warmup(step: int, warmup_min_lr: float, warmup_max_lr: float,
            warmup_num_steps: int, warmup_type: str = "log") -> float:
    if warmup_num_steps <= 0 or step >= warmup_num_steps:
        return warmup_max_lr
    if warmup_type == "log":
        # ref WarmupLR: min + (max-min) * log(1+step)/log(1+warmup)
        gamma = math.log(1 + step) / math.log(1 + warmup_num_steps)
    else:
        gamma = step / warmup_num_steps
    return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * gamma


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log", **_) -> LRSchedule:
    return LRSchedule(
        lambda s: _warmup(s, warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type),
        "WarmupLR")


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_) -> LRSchedule:
    def fn(s: int) -> float:
        if s < warmup_num_steps:
            return _warmup(s, warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)
        frac = max(0.0, (total_num_steps - s) / max(1.0, total_num_steps - warmup_num_steps))
        return warmup_max_lr * frac

    return LRSchedule(fn, "WarmupDecayLR")


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 0.0001,
                     warmup_type: str = "log", lr: float = 0.001, **_) -> LRSchedule:
    def fn(s: int) -> float:
        if s < warmup_num_steps:
            ratio = _warmup(s, warmup_min_ratio, 1.0, warmup_num_steps, warmup_type)
        else:
            progress = min(1.0, (s - warmup_num_steps) / max(1, total_num_steps - warmup_num_steps))
            ratio = cos_min_ratio + (1 - cos_min_ratio) * 0.5 * (1 + math.cos(math.pi * progress))
        return lr * ratio

    return LRSchedule(fn, "WarmupCosineLR")


def lr_range_test(lr_range_test_min_lr: float = 1e-3, lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False, **_) -> LRSchedule:
    def fn(s: int) -> float:
        interval = s / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1 + interval * lr_range_test_step_rate)

    return LRSchedule(fn, "LRRangeTest")


def one_cycle(cycle_min_lr: float = 1e-3, cycle_max_lr: float = 1e-2,
              cycle_first_step_size: int = 2000, cycle_second_step_size: Optional[int] = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0, **_) -> LRSchedule:
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size

    def fn(s: int) -> float:
        if s <= cycle_first_step_size:
            frac = s / cycle_first_step_size
            return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * frac
        if s <= cycle_first_step_size + second:
            frac = (s - cycle_first_step_size) / second
            return cycle_max_lr - (cycle_max_lr - cycle_min_lr) * frac
        if decay_step_size > 0:
            decay_steps = (s - cycle_first_step_size - second) / decay_step_size
            return cycle_min_lr / (1 + decay_steps * decay_lr_rate)
        return cycle_min_lr

    return LRSchedule(fn, "OneCycle")


_FACTORIES = {
    "WarmupLR": warmup_lr,
    "WarmupDecayLR": warmup_decay_lr,
    "WarmupCosineLR": warmup_cosine_lr,
    "LRRangeTest": lr_range_test,
    "OneCycle": one_cycle,
}


def build_lr_schedule(sched_type: str, params: Dict[str, Any],
                      base_lr: Optional[float] = None) -> LRSchedule:
    if sched_type not in _FACTORIES:
        raise ValueError(f"unknown scheduler '{sched_type}'; valid: {VALID_LR_SCHEDULES}")
    params = dict(params)
    if sched_type == "WarmupCosineLR" and "lr" not in params and base_lr is not None:
        params["lr"] = base_lr
    return _FACTORIES[sched_type](**params)


def constant_lr(lr: float) -> LRSchedule:
    return LRSchedule(lambda s: lr, "Constant")
