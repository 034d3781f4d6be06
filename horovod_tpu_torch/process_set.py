"""Process sets: the group of ranks a collective runs over.

Port of ``horovod_tpu/process_set.py``. The global set spans every rank and
owns a ``torch.distributed`` group made with ``dist.new_group`` at
``init()``. Subset sets are not ported yet.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import torch.distributed as dist

__all__ = ["ProcessSet", "global_process_set"]

_LOCK = threading.Lock()


class ProcessSet:
    """A set of ranks and the communicator group that joins them."""

    def __init__(self, ranks: Optional[Sequence[int]], group,
                 process_set_id: int):
        self.ranks: Optional[List[int]] = (None if ranks is None
                                           else list(ranks))
        self.group = group
        self.process_set_id = process_set_id

    def size(self) -> int:
        return (dist.get_world_size(self.group) if self.ranks is None
                else len(self.ranks))

    def rank(self) -> int:
        return dist.get_rank(self.group)

    def included(self) -> bool:
        return self.ranks is None or dist.get_rank() in self.ranks

    def __repr__(self) -> str:
        return (f"ProcessSet(id={self.process_set_id}, "
                f"ranks={'all' if self.ranks is None else self.ranks})")


_GLOBAL: Optional[ProcessSet] = None


def _reset_for_init() -> None:
    global _GLOBAL
    with _LOCK:
        _GLOBAL = ProcessSet(None, dist.new_group(), 0)


def _reset_for_shutdown() -> None:
    global _GLOBAL
    with _LOCK:
        _GLOBAL = None


def global_process_set() -> ProcessSet:
    if _GLOBAL is None:
        raise RuntimeError("horovod_tpu_torch is not initialized: call "
                           "hvd.init() first")
    return _GLOBAL

