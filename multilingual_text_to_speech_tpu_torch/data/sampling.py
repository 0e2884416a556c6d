"""Batch samplers: sequential, language-balanced, and "perfect"
language-interleaved sampling for the grouped encoders.

A copy of the JAX package's ``data/sampling.py``: index generators, each
iterating over lists of dataset indices (one list per batch), drawing from
a ``numpy.random.RandomState`` of its seed, so that the same seed gives the
same lists in both packages.

The PerfectBatchSampler contract is load-bearing for the grouped
convolutional encoders: language ``i`` occupies batch positions ``i + k*L``
so the batch reshapes to ``[B/L, T, L*C]`` with channel block ``i`` holding
language ``i`` (utils/samplers.py:50-67).  The data-parallel divisibility
rule (batch % (L * dp_shards) == 0, utils/samplers.py:72-73) holds for
data parallel over several cards.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np


class SimpleBatchSampler:
    """Plain batching with optional shuffling (torch DataLoader default path,
    train.py:233-236)."""

    def __init__(self, num_items: int, batch_size: int, shuffle: bool = True,
                 drop_last: bool = False, seed: int = 42):
        self.num_items = num_items
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)

    def __iter__(self) -> Iterator[List[int]]:
        order = np.arange(self.num_items)
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, self.num_items, self.batch_size):
            batch = order[start : start + self.batch_size].tolist()
            if len(batch) < self.batch_size and self.drop_last:
                return
            if batch:
                yield batch

    def __len__(self) -> int:
        if self.drop_last:
            return self.num_items // self.batch_size
        return (self.num_items + self.batch_size - 1) // self.batch_size


class BalancedBatchSampler:
    """Language-balanced sampling WITH replacement: each item is drawn with
    probability proportional to total/freq(language)
    (reference RandomImbalancedSampler, utils/samplers.py:6-30)."""

    def __init__(self, languages_per_item: List[int], batch_size: int,
                 drop_last: bool = True, seed: int = 42):
        langs = np.asarray(languages_per_item)
        freq = {l: int((langs == l).sum()) for l in np.unique(langs)}
        total = float(len(langs))
        weights = np.asarray([total / freq[l] for l in langs], dtype=np.float64)
        self._probs = weights / weights.sum()
        self.num_items = len(langs)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)

    def __iter__(self) -> Iterator[List[int]]:
        order = self._rng.choice(
            self.num_items, size=self.num_items, replace=True, p=self._probs
        )
        for start in range(0, self.num_items, self.batch_size):
            batch = order[start : start + self.batch_size].tolist()
            if len(batch) < self.batch_size and self.drop_last:
                return
            if batch:
                yield batch

    def __len__(self) -> int:
        if self.drop_last:
            return self.num_items // self.batch_size
        return (self.num_items + self.batch_size - 1) // self.batch_size


class PerfectBatchSampler:
    """Language-interleaved batches for grouped encoders
    (reference: utils/samplers.py:50-122).

    Emits batches where language ``i`` occupies indices ``i + k*L``.  When
    ``drop_last`` is False, the tail batch is truncated so the number of
    groups stays divisible by ``data_parallel_shards``
    (utils/samplers.py:110-118).
    """

    def __init__(self, languages_per_item: List[int], num_languages: int,
                 batch_size: int, data_parallel_shards: int = 1,
                 shuffle: bool = True, drop_last: bool = False, seed: int = 42):
        assert batch_size % (num_languages * data_parallel_shards) == 0, (
            "Batch size must be divisible by number of languages times the "
            "number of data-parallel shards."
        )
        langs = np.asarray(languages_per_item)
        self._label_indices = [
            np.flatnonzero(langs == l) for l in range(num_languages)
        ]
        self.num_languages = num_languages
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.dp_shards = data_parallel_shards
        self._rng = np.random.RandomState(seed)

    def __iter__(self) -> Iterator[List[int]]:
        streams = []
        for idx in self._label_indices:
            idx = idx.copy()
            if self.shuffle:
                self._rng.shuffle(idx)
            streams.append(idx)

        L = self.num_languages
        per_lang = self.batch_size // L
        n_rounds = min(len(s) for s in streams)

        batch: List[int] = []
        for k in range(n_rounds):
            for s in streams:
                batch.append(int(s[k]))
            if len(batch) == self.batch_size:
                yield batch
                batch = []

        if not self.drop_last and batch:
            groups = len(batch) // L
            if groups % self.dp_shards != 0:
                groups = (groups // self.dp_shards) * self.dp_shards
                batch = batch[: groups * L]
            if batch:
                yield batch

    def __len__(self) -> int:
        per_lang = self.batch_size // self.num_languages
        return min(
            (len(s) + per_lang - 1) // per_lang for s in self._label_indices
        )
