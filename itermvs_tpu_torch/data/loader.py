"""Batching over `torch.utils.data.DataLoader` in the JAX package's batch
order (counterpart of itermvs_tpu/data/loader.py).

The order of an epoch is a pure function of (seed, epoch): the indices
0..N-1, shuffled by `np.random.default_rng(seed + epoch)` when
`shuffle`, cut into `batch_size` batches, the short last one dropped
with `drop_last`. `set_epoch(epoch, skip_batches)` pins the next
iteration to `epoch` and skips its first batches, which is how a run
resumed from a step checkpoint continues on the exact next batch. Each
iteration advances the epoch by one. Collation stacks numpy arrays as
the JAX loader does. `batch_size` is the global batch: in a run of
`process_count` processes (parallel/mesh.py) each process loads only its
consecutive `batch_size / process_count` slice of every global batch,
and short batches are dropped, so the slices partition each global batch
exactly. A sample is the same whichever process loads it: the datasets'
per-item randomness is keyed on (seed, epoch, index) (data/base.py).

Eval keeps the short last batch (`eval_batches`): it is padded, as the
JAX eval.py pads it for its device mesh, and the padding is not written.
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


def slice_batch(batch, start: int, n: int):
    """Rows [start, start + n) of every leaf of a collated batch: one
    process's consecutive slice of a global batch."""
    if isinstance(batch, dict):
        return {k: slice_batch(v, start, n) for k, v in batch.items()}
    return batch[start:start + n]


class BatchOrder(torch.utils.data.Sampler):
    """Batch sampler yielding the index batches of one epoch in the JAX
    loader's order. Iterating takes the current (epoch, skip), then moves
    to the next epoch with no skip."""

    def __init__(self, size: int, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, process_index: int = 0,
                 process_count: int = 1):
        if batch_size % process_count != 0:
            raise ValueError(
                f"global batch_size {batch_size} must divide evenly over "
                f"{process_count} processes")
        self.size = size
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        self.skip = 0

    def batches(self) -> list[list[int]]:
        """This process's index batches of the current epoch."""
        order = np.arange(self.size)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        local = self.batch_size // self.process_count
        lo = self.process_index * local
        out = []
        for start in range(0, self.size, self.batch_size):
            chunk = order[start:start + self.batch_size]
            if len(chunk) < self.batch_size and (self.drop_last or self.process_count > 1):
                continue
            if self.process_count > 1:
                chunk = chunk[lo:lo + local]
            out.append([int(i) for i in chunk])
        return out

    def epoch_len(self) -> int:
        if self.drop_last or self.process_count > 1:
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


def eval_batches(size: int, batch_size: int, rank: int = 0,
                 world: int = 1) -> list[tuple[list[int], int]]:
    """Data-parallel eval's batches for process `rank` of `world`:
    (indices, n_real) per global batch.

    The indices 0..size-1 are cut in order into global batches of
    `batch_size`; a short last batch is padded to `batch_size` by
    repeating its last index (the JAX eval.py's `_pad`). Process r takes
    the consecutive rows [r·b/world, (r+1)·b/world) of each, the rows
    device r holds under the JAX package's `batch_sharding`; `n_real`
    counts those of them that come before the padding (0 when the
    process's rows are all padding)."""
    if batch_size % world != 0:
        raise ValueError(f"batch_size {batch_size} must divide evenly over "
                         f"{world} processes")
    local = batch_size // world
    lo = rank * local
    out = []
    for start in range(0, size, batch_size):
        real = min(batch_size, size - start)
        rows = [start + min(i, real - 1) for i in range(lo, lo + local)]
        out.append((rows, max(0, min(local, real - lo))))
    return out


class DataLoader:
    """Iterable over collated batches of `dataset` in `BatchOrder`, with
    `workers` decode processes (spawned; 0 = in this process). `len` is
    the number of batches of a whole epoch. `batch_size` is the global
    batch; this process yields its slice (`process_index` of
    `process_count`)."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, workers: int = 0,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.order = BatchOrder(len(dataset), batch_size, shuffle, drop_last, seed,
                                process_index, process_count)
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
