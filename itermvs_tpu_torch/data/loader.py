"""Batching over `torch.utils.data.DataLoader` in the JAX package's batch
order (counterpart of itermvs_tpu/data/loader.py).

The order of an epoch is a pure function of (seed, epoch): the indices
0..N-1, shuffled by `np.random.default_rng(seed + epoch)` when
`shuffle`, cut into `batch_size` batches, the short last one dropped
with `drop_last`. `set_epoch(epoch, skip_batches)` pins the next
iteration to `epoch` and skips its first batches, which is how a run
resumed from a step checkpoint continues on the exact next batch. Each
iteration advances the epoch by one. Collation stacks numpy arrays as
the JAX loader does. Loading across several processes of one training
run (data-parallel sharding) is not here.
"""
from __future__ import annotations

import numpy as np
import torch


def collate(samples: list):
    """Recursively stack a list of samples (dicts / arrays / scalars)."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: collate([s[k] for s in samples]) for k in first}
    if isinstance(first, np.ndarray):
        return np.stack(samples)
    if isinstance(first, (np.floating, float)):
        return np.asarray(samples, dtype=np.float32)
    if isinstance(first, (np.integer, int)):
        return np.asarray(samples, dtype=np.int64)
    if isinstance(first, str):
        return list(samples)
    raise TypeError(f"cannot collate type {type(first)}")


class BatchOrder(torch.utils.data.Sampler):
    """Batch sampler yielding the index batches of one epoch in the JAX
    loader's order. Iterating takes the current (epoch, skip), then moves
    to the next epoch with no skip."""

    def __init__(self, size: int, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        self.size = size
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.skip = 0

    def batches(self) -> list[list[int]]:
        """All index batches of the current epoch."""
        order = np.arange(self.size)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        out = []
        for start in range(0, self.size, self.batch_size):
            chunk = order[start:start + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                continue
            out.append([int(i) for i in chunk])
        return out

    def epoch_len(self) -> int:
        if self.drop_last:
            return self.size // self.batch_size
        return (self.size + self.batch_size - 1) // self.batch_size

    def __len__(self):
        return max(0, self.epoch_len() - self.skip)

    def __iter__(self):
        # Eager: the batches are fixed before the epoch moves on.
        batches = self.batches()[self.skip:]
        self.epoch += 1
        self.skip = 0
        return iter(batches)


class DataLoader:
    """Iterable over collated batches of `dataset` in `BatchOrder`, with
    `workers` decode processes (spawned; 0 = in this process). `len` is
    the number of batches of a whole epoch."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, workers: int = 0):
        self.dataset = dataset
        self.order = BatchOrder(len(dataset), batch_size, shuffle, drop_last, seed)
        self.loader = torch.utils.data.DataLoader(
            dataset, batch_sampler=self.order, num_workers=workers,
            collate_fn=collate,
            multiprocessing_context="spawn" if workers else None)

    def set_epoch(self, epoch: int, skip_batches: int = 0):
        """Pin the next iteration to `epoch`, skipping its first
        `skip_batches` batches."""
        self.order.epoch = int(epoch)
        self.order.skip = int(skip_batches)

    def __len__(self):
        return self.order.epoch_len()

    def __iter__(self):
        # The dataset's per-item randomness follows the epoch; workers copy
        # the dataset when the iterator starts them.
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.order.epoch)
        return iter(self.loader)
