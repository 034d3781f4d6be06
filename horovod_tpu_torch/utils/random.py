"""Deterministic data-shuffling seeds.

Port of ``horovod_tpu/utils/random.py``'s ``data_key``: a host-side source
of randomness for data shuffling and augmentation, fixed by (seed, epoch,
process rank). The reference returns a ``jax.random`` key; here it is a
``torch.Generator`` seeded from the three numbers through numpy's
``SeedSequence``, so its draws are not JAX's. The reference's
``rank_fold_key`` folds the device index into a key inside ``shard_map``
and has no counterpart: each process seeds its own generator.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["data_key"]


def data_key(seed: int, epoch: int, rank: Optional[int] = None
             ) -> torch.Generator:
    """A CPU ``torch.Generator`` for (seed, epoch, process rank); the rank
    defaults to ``hvd.rank()``, or 0 before ``init``."""
    if rank is None:
        from horovod_tpu_torch import core
        rank = core.rank() if core.is_initialized() else 0
    state = np.random.SeedSequence(
        [int(seed), int(epoch), int(rank)]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]) & (2 ** 63 - 1))
