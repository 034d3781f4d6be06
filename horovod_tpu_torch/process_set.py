"""Process sets: the group of ranks a collective runs over.

Port of ``horovod_tpu/process_set.py``. The global set (id 0) spans every
rank; ``add_process_set(ranks)`` registers a subset with its own
``torch.distributed`` group. ``dist.new_group`` is collective over the whole
world: every rank must call ``add_process_set`` for every set, in the same
order, whether it belongs to the set or not (upstream Horovod asks the
same). A rank outside a set may still call a collective on it and gets what
the reference gives such a rank, without communicating (``collective.py``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import torch.distributed as dist

__all__ = ["ProcessSet", "global_process_set", "add_process_set",
           "remove_process_set", "get_process_set_ids_and_ranks"]

_LOCK = threading.Lock()


class ProcessSet:
    """A sorted set of global ranks and the communicator group that joins
    them (``ranks`` None: every rank)."""

    def __init__(self, ranks: Optional[Sequence[int]], group,
                 process_set_id: int):
        self.ranks: Optional[List[int]] = (
            None if ranks is None else sorted(int(r) for r in ranks))
        self.group = group
        self.process_set_id = process_set_id
        # Set once a call of every member has made the group's NCCL
        # communicator (Adasum's subset point-to-point ops need it).
        self.p2p_ready = False

    def size(self) -> int:
        return (dist.get_world_size() if self.ranks is None
                else len(self.ranks))

    def included(self) -> bool:
        """Whether this process's rank belongs to the set."""
        return self.ranks is None or dist.get_rank() in self.ranks

    def rank(self) -> int:
        """This process's rank within the set; ValueError outside it, as
        the reference's ``ProcessSet.rank``."""
        r = dist.get_rank()
        return r if self.ranks is None else self.ranks.index(r)

    def __repr__(self) -> str:
        return (f"ProcessSet(id={self.process_set_id}, "
                f"ranks={'global' if self.ranks is None else self.ranks})")


_SETS: Dict[int, ProcessSet] = {}
_NEXT_ID = 1


def _reset_for_init() -> None:
    global _SETS, _NEXT_ID
    with _LOCK:
        _SETS = {0: ProcessSet(None, dist.new_group(), 0)}
        _NEXT_ID = 1


def _reset_for_shutdown() -> None:
    global _SETS
    with _LOCK:
        _SETS = {}


def global_process_set() -> ProcessSet:
    with _LOCK:
        if 0 not in _SETS:
            raise RuntimeError("horovod_tpu_torch is not initialized: call "
                               "hvd.init() first")
        return _SETS[0]


def add_process_set(ranks: Sequence[int]) -> ProcessSet:
    """Register a subset of ranks (``hvd.add_process_set``). Every rank
    calls it, members or not, in the same order."""
    global _NEXT_ID
    with _LOCK:
        if 0 not in _SETS:
            raise RuntimeError("horovod_tpu_torch is not initialized: call "
                               "hvd.init() first")
        world = dist.get_world_size()
        ranks = sorted(int(r) for r in ranks)
        if not ranks or ranks[0] < 0 or ranks[-1] >= world:
            raise ValueError(f"ranks out of range for world size {world}: "
                             f"{ranks}")
        if len(set(ranks)) != len(ranks):
            raise ValueError(f"duplicate ranks: {ranks}")
        ps = ProcessSet(ranks, dist.new_group(ranks), _NEXT_ID)
        _SETS[_NEXT_ID] = ps
        _NEXT_ID += 1
        return ps


def remove_process_set(ps: ProcessSet) -> bool:
    """Deregister a set (``hvd.remove_process_set``); the global set is
    permanent. Its group is released with the others at ``shutdown``."""
    with _LOCK:
        if ps.process_set_id == 0:
            return False
        return _SETS.pop(ps.process_set_id, None) is not None


def get_process_set_ids_and_ranks() -> Dict[int, Optional[List[int]]]:
    """{id: sorted ranks}, None for the global set."""
    with _LOCK:
        return {i: (None if p.ranks is None else list(p.ranks))
                for i, p in _SETS.items()}
