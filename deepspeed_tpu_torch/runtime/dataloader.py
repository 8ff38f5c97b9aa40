"""Data loading: a copy of ``deepspeed_tpu/runtime/dataloader.py`` (numpy).

Analog of ``runtime/dataloader.py`` (DeepSpeedDataLoader) — batches a
map-style or iterable dataset into numpy dict batches sized for
``engine.train_batch``.  Works with torch Datasets, HF datasets, lists of
dicts, or dicts of arrays.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np


def default_collate(samples) -> Dict[str, np.ndarray]:
    if isinstance(samples[0], dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in samples[0]}
    arr = np.stack([np.asarray(s) for s in samples])
    return {"input_ids": arr, "labels": arr}


class DeepSpeedDataLoader:
    def __init__(self, dataset: Any, batch_size: int,
                 collate_fn: Optional[Callable] = None,
                 drop_last: bool = False, shuffle: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                break
            yield self.collate_fn([self.dataset[int(i)] for i in idx])


class RepeatingLoader:
    """Wraps an iterator to repeat forever (ref: runtime/dataloader.py)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)
