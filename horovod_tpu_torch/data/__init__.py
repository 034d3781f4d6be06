"""Data utilities of the port: per-rank data sharding and sequence packing.

Port of ``horovod_tpu/data/__init__.py``'s ``DistributedSampler``,
``shard_arrays`` and ``ShardedBatchIterator``, with the reference's NumPy
arithmetic: every rank sees a disjoint, equally sized slice of a per-epoch
permutation (``np.random.default_rng((seed, epoch))``), the tail padded by
wrapping; batches have one static shape, the ragged last one dropped or
padded with a mask. Inputs and batches stay NumPy, as in the reference:
the caller moves a batch to the card (``torch.from_numpy(x).to(dev)``).
``rank`` and ``size`` default to the port's ``hvd.rank()`` and
``hvd.size()``.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from horovod_tpu_torch.data.packing import pack_documents, pack_rows

__all__ = ["DistributedSampler", "ShardedBatchIterator", "shard_arrays",
           "pack_documents", "pack_rows"]


def _world(rank: Optional[int], size: Optional[int]) -> Tuple[int, int]:
    if rank is None or size is None:
        from horovod_tpu_torch import core
        rank = core.rank() if rank is None else rank
        size = core.size() if size is None else size
    return rank, size


class DistributedSampler:
    """Index sampler that partitions ``num_samples`` across ranks
    (``torch.utils.data.DistributedSampler``'s contract): every rank sees a
    disjoint, equally sized slice of a per-epoch permutation; the tail is
    padded by wrapping so all ranks step the same number of times."""

    def __init__(self, num_samples: int, *, rank: Optional[int] = None,
                 size: Optional[int] = None, shuffle: bool = True,
                 seed: int = 0):
        rank, size = _world(rank, size)
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} out of range for size {size}")
        self.num_samples = num_samples
        self.rank, self.size = rank, size
        self.shuffle, self.seed = shuffle, seed
        self.epoch = 0
        # ceil so every sample appears at least once per epoch (wrap-pad).
        self.samples_per_rank = -(-num_samples // size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.samples_per_rank

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            order = np.random.default_rng(
                (self.seed, self.epoch)).permutation(self.num_samples)
        else:
            order = np.arange(self.num_samples)
        total = self.samples_per_rank * self.size
        if total > self.num_samples:  # wrap-pad the tail
            order = np.concatenate([order, order[:total - self.num_samples]])
        return iter(order[self.rank::self.size].tolist())


def shard_arrays(arrays: Sequence[np.ndarray], *, rank: Optional[int] = None,
                 size: Optional[int] = None) -> Tuple[np.ndarray, ...]:
    """Static split: each rank keeps rows ``[rank::size]`` of every array."""
    rank, size = _world(rank, size)
    n = len(arrays[0])
    for a in arrays:
        if len(a) != n:
            raise ValueError("arrays must share a leading dimension; got "
                             f"{[len(x) for x in arrays]}")
    return tuple(a[rank::size] for a in arrays)


class ShardedBatchIterator:
    """Batched epoch iterator over this rank's shard.

    Yields ``(batch_tuple, mask)`` where ``mask`` is a per-row bool vector:
    all True except on a padded final batch (``last="pad"``). With
    ``last="drop"`` the ragged tail is dropped. Every batch has the same
    shape."""

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int, *,
                 rank: Optional[int] = None, size: Optional[int] = None,
                 shuffle: bool = True, seed: int = 0, last: str = "drop"):
        if last not in ("drop", "pad"):
            raise ValueError(f"last must be 'drop' or 'pad', got {last!r}")
        self.arrays = [np.asarray(a) for a in arrays]
        lens = {len(a) for a in self.arrays}
        if len(lens) != 1:
            raise ValueError("arrays must share a leading dimension; got "
                             f"{[len(a) for a in self.arrays]}")
        self.batch_size = batch_size
        self.last = last
        self.sampler = DistributedSampler(
            len(self.arrays[0]), rank=rank, size=size, shuffle=shuffle,
            seed=seed)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        n = self.sampler.samples_per_rank
        return (n // self.batch_size if self.last == "drop"
                else -(-n // self.batch_size))

    def __iter__(self):
        idx = np.fromiter(iter(self.sampler), dtype=np.int64)
        bs = self.batch_size
        n_full = len(idx) // bs
        for i in range(n_full):
            rows = idx[i * bs:(i + 1) * bs]
            yield (tuple(a[rows] for a in self.arrays),
                   np.ones(bs, bool))
        tail = len(idx) - n_full * bs
        if tail and self.last == "pad":
            # np.resize cycles idx, so the pad fills even when the whole
            # shard is smaller than one batch.
            rows = np.concatenate([idx[n_full * bs:],
                                   np.resize(idx, bs - tail)])
            mask = np.zeros(bs, bool)
            mask[:tail] = True
            yield tuple(a[rows] for a in self.arrays), mask
