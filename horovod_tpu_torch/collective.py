"""Eager collectives over ``torch.distributed``: NCCL on the GPU, gloo on
the CPU.

Port of the eager half of ``horovod_tpu/collective.py`` with the torch
frontend's signatures (``horovod_tpu/torch/__init__.py``). Each rank passes
its own tensor and gets the result back (the reference simulates all ranks
in one process with ``tensor[r]`` as rank r's value; here every rank is a
process). Reductions keep the reference's semantics: ``prescale_factor`` and
``postscale_factor`` apply to Sum, Average and Adasum only, on the wire
dtype, around the reduction; Average divides the sum by the set's size
(floor division for integer tensors). Adasum (``adasum.py``) reduces each
fusion bucket as one vector, after compression, so its coefficients are
per bucket, as the reference's are.

Every collective is issued as ``torch.distributed`` work with
``async_op=True`` on the caller's thread and wrapped in a :class:`Handle`;
the ``*_async`` forms return the handle, the others synchronize it at once.
``synchronize`` waits for the work and runs the finishing step (Average's
division, postscale, decompression, unpacking of fusion buckets, slicing
of ragged parts, the copy into the target of a ``*_async_``). There is no
dispatch thread: NCCL needs every rank to issue one group's collectives in
one order, and the caller's thread already gives it. Adasum's rounds of
point-to-point ops run when its handle is issued, not when it is
synchronized.

A rank outside a subset process set gets what the reference gives it,
without communicating: its own tensor from allreduce, broadcast and
alltoall, zeros of the result's shape from allgather and reducescatter, and
zero rows with zero splits from an alltoall with splits. From
``ragged_allgather`` it gets zero rows: the reference's one-process
simulation hands such a rank the members' rows, which a rank outside the
group cannot receive.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch import core as _core
from horovod_tpu_torch import fusion as _fusion
from horovod_tpu_torch.adasum import (adasum_allreduce,
                                      hierarchical_adasum_allreduce)
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.config import get_config
from horovod_tpu_torch.process_set import ProcessSet, global_process_set

__all__ = ["ReduceOp", "Average", "Sum", "Min", "Max", "Product", "Adasum",
           "Handle", "allreduce", "allreduce_", "allreduce_async",
           "allreduce_async_", "grouped_allreduce",
           "grouped_allreduce_async", "broadcast", "broadcast_",
           "broadcast_async", "broadcast_async_", "allgather",
           "allgather_async", "grouped_allgather", "grouped_allgather_async",
           "ragged_allgather", "alltoall", "alltoall_async", "reducescatter",
           "reducescatter_async", "grouped_reducescatter",
           "grouped_reducescatter_async", "synchronize", "poll", "barrier",
           "broadcast_object", "allgather_object"]


class ReduceOp:
    """Reduction op ids, matching ``horovod.common.Average/Sum/...``."""
    Average = 0
    Sum = 1
    Min = 2
    Max = 3
    Product = 4
    Adasum = 5


Average = ReduceOp.Average
Sum = ReduceOp.Sum
Min = ReduceOp.Min
Max = ReduceOp.Max
Product = ReduceOp.Product
Adasum = ReduceOp.Adasum

_SCALING_OPS = (ReduceOp.Average, ReduceOp.Sum, ReduceOp.Adasum)

_DIST_OPS = {
    ReduceOp.Average: dist.ReduceOp.SUM,
    ReduceOp.Sum: dist.ReduceOp.SUM,
    ReduceOp.Min: dist.ReduceOp.MIN,
    ReduceOp.Max: dist.ReduceOp.MAX,
    ReduceOp.Product: dist.ReduceOp.PRODUCT,
}


class Handle:
    """An in-flight collective (upstream's handle into its op table).

    ``poll()`` is true once every piece of work has completed;
    ``synchronize()`` waits for them, runs the finishing step once and
    returns its result (again on later calls)."""

    __slots__ = ("_works", "_finish", "_result", "_done")

    def __init__(self, works: Sequence, finish: Callable[[], Any]):
        self._works = list(works)
        self._finish = finish
        self._result = None
        self._done = False

    def poll(self) -> bool:
        return self._done or all(w.is_completed() for w in self._works)

    def synchronize(self):
        if not self._done:
            for w in self._works:
                w.wait()
            self._result = self._finish()
            self._done = True
            self._works, self._finish = [], None
        return self._result

    def then(self, fn: Callable[[Any], Any]) -> "Handle":
        """A handle over the same work whose result is ``fn`` of this
        one's."""
        return Handle(self._works, lambda: fn(self.synchronize()))


def _ready(value) -> Handle:
    return Handle([], lambda: value)


def synchronize(handle: Handle):
    """Wait for an async collective and return its result
    (``hvd.synchronize``)."""
    return handle.synchronize()


def poll(handle: Handle) -> bool:
    """True once an async collective has completed (``hvd.poll``)."""
    return handle.poll()


def _resolve_ps(process_set: Optional[ProcessSet]) -> ProcessSet:
    return process_set if process_set is not None else global_process_set()


def _check_reduce(op: int, prescale: float, postscale: float,
                  compression) -> None:
    if op not in _DIST_OPS and op != ReduceOp.Adasum:
        raise ValueError(f"unknown reduce op {op}")
    if op not in _SCALING_OPS and (prescale != 1.0 or postscale != 1.0):
        raise ValueError("prescale/postscale only apply to Sum/Average/Adasum")
    if getattr(compression, "wire", None) is not None:
        raise NotImplementedError("quantized wire: not yet ported")


def _divide(buf: torch.Tensor, k: int) -> torch.Tensor:
    return buf.div_(k) if buf.is_floating_point() else buf.floor_divide_(k)


def _adasum(buf: torch.Tensor, ps: ProcessSet) -> torch.Tensor:
    """Adasum of ``buf`` over the set (``adasum.py``), by node first when
    ``HOROVOD_HIERARCHICAL_ALLREDUCE`` is set: the set's ranks are grouped
    by ``rank // local_size``."""
    ranks = (list(range(dist.get_world_size())) if ps.ranks is None
             else ps.ranks)
    if len(ranks) == 1:
        return buf
    if dist.get_backend(ps.group) == "nccl" and not ps.p2p_ready:
        # Batched point-to-point ops on a subset of a NCCL group need the
        # group's communicator, which only a call of every member makes.
        dist.all_reduce(buf.new_zeros(1), group=ps.group)
        ps.p2p_ready = True
    if get_config().hierarchical_allreduce:
        nodes: dict = {}
        for r in ranks:
            nodes.setdefault(r // _core.local_size(), []).append(r)
        return hierarchical_adasum_allreduce(buf, list(nodes.values()),
                                             ps.group)
    return adasum_allreduce(buf, ranks, ps.group)


def _issue_reduce(buf: torch.Tensor, op: int, ps: ProcessSet,
                  prescale: float) -> list:
    """Start the in-place reduction of ``buf`` (already on the wire dtype)
    across ``ps``; returns the work to wait for. Adasum runs its rounds
    here, at issue (``adasum.py``: on NCCL they are queued on the device,
    on gloo they have completed on return), so it leaves no work."""
    if op in _SCALING_OPS and prescale != 1.0:
        buf.mul_(prescale)
    if op == ReduceOp.Adasum:
        buf.copy_(_adasum(buf, ps))
        return []
    return [dist.all_reduce(buf, op=_DIST_OPS[op], group=ps.group,
                            async_op=True)]


def _finish_reduce(buf: torch.Tensor, op: int, ps: ProcessSet,
                   postscale: float) -> torch.Tensor:
    if op == ReduceOp.Average:
        _divide(buf, ps.size())
    if op in _SCALING_OPS and postscale != 1.0:
        buf.mul_(postscale)
    return buf


def allreduce_async(tensor: torch.Tensor, op: int = Average,
                    process_set: Optional[ProcessSet] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    compression=Compression.none,
                    name: Optional[str] = None) -> Handle:
    """Start :func:`allreduce`; ``synchronize`` returns the new tensor."""
    pre, post = float(prescale_factor), float(postscale_factor)
    _check_reduce(op, pre, post, compression)
    ps = _resolve_ps(process_set)
    if not ps.included():
        return _ready(tensor.clone())
    c, ctx = compression.compress(tensor)
    buf = c.clone() if c is tensor else c.contiguous()
    works = _issue_reduce(buf, op, ps, pre)
    return Handle(works, lambda: compression.decompress(
        _finish_reduce(buf, op, ps, post), ctx))


def allreduce(tensor: torch.Tensor, op: int = Average,
              process_set: Optional[ProcessSet] = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              compression=Compression.none,
              name: Optional[str] = None) -> torch.Tensor:
    """Reduce this rank's ``tensor`` with every other rank's
    (``hvd.allreduce``). Returns a new tensor; the input is left as is."""
    return allreduce_async(tensor, op, process_set, prescale_factor,
                           postscale_factor, compression).synchronize()


def allreduce_async_(tensor: torch.Tensor, **kwargs) -> Handle:
    """In-place :func:`allreduce_async`: ``synchronize`` writes the result
    into ``tensor`` and returns it (``hvd.allreduce_async_``)."""
    return allreduce_async(tensor, **kwargs).then(tensor.copy_)


def allreduce_(tensor: torch.Tensor, **kwargs) -> torch.Tensor:
    """In-place :func:`allreduce` (``hvd.allreduce_``)."""
    return allreduce_async_(tensor, **kwargs).synchronize()


def grouped_allreduce_async(tensors: Sequence[torch.Tensor],
                            op: int = Average,
                            process_set: Optional[ProcessSet] = None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            compression=Compression.none,
                            fusion_threshold_bytes: Optional[int] = None,
                            out: Optional[Sequence[torch.Tensor]] = None,
                            name: Optional[str] = None) -> Handle:
    """Start :func:`grouped_allreduce`; ``synchronize`` returns the list."""
    pre, post = float(prescale_factor), float(postscale_factor)
    _check_reduce(op, pre, post, compression)
    tensors = list(tensors)
    ps = _resolve_ps(process_set)
    if not tensors:
        return _ready([])
    if not ps.included():
        if out is None:
            return _ready([t.clone() for t in tensors])
        for dst, t in zip(out, tensors):
            dst.copy_(t)
        return _ready(list(out))
    if fusion_threshold_bytes is None:
        fusion_threshold_bytes = get_config().fusion_threshold_bytes
    buckets, unpack = _fusion.fuse(tensors, int(fusion_threshold_bytes))
    wire, works = [], []
    for buf in buckets:
        c, ctx = compression.compress(buf)
        wire.append((c, ctx))
        works.extend(_issue_reduce(c, op, ps, pre))

    def finish():
        return unpack([compression.decompress(_finish_reduce(c, op, ps, post),
                                              ctx) for c, ctx in wire],
                      out=out)
    return Handle(works, finish)


def grouped_allreduce(tensors: Sequence[torch.Tensor], op: int = Average,
                      process_set: Optional[ProcessSet] = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      compression=Compression.none,
                      fusion_threshold_bytes: Optional[int] = None,
                      out: Optional[Sequence[torch.Tensor]] = None,
                      name: Optional[str] = None) -> List[torch.Tensor]:
    """Allreduce a list of tensors as one fused operation
    (``hvd.grouped_allreduce``): the tensors are packed into fusion buckets
    (``fusion.py``), one collective runs per bucket, and the results are
    sliced back out. ``out`` receives the results in place when given."""
    return grouped_allreduce_async(
        tensors, op, process_set, prescale_factor, postscale_factor,
        compression, fusion_threshold_bytes, out).synchronize()


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     process_set: Optional[ProcessSet] = None,
                     name: Optional[str] = None) -> Handle:
    """In-place :func:`broadcast_async`: ``synchronize`` returns ``tensor``
    holding the root's value."""
    ps = _resolve_ps(process_set)
    if ps.ranks is not None and root_rank not in ps.ranks:
        raise ValueError(f"root rank {root_rank} not in process set "
                         f"{ps.ranks}")
    if not ps.included():
        return _ready(tensor)
    # NCCL moves device memory only: a host tensor (an optimizer's step
    # count) is staged through the device.
    staged = (tensor.device.type == "cpu"
              and dist.get_backend(ps.group) == "nccl")
    if tensor.is_contiguous() and not staged:
        work = dist.broadcast(tensor, src=int(root_rank), group=ps.group,
                              async_op=True)
        return Handle([work], lambda: tensor)
    tmp = (tensor.to(torch.device("cuda", torch.cuda.current_device()))
           if staged else tensor.contiguous())
    work = dist.broadcast(tmp, src=int(root_rank), group=ps.group,
                          async_op=True)

    def finish():
        tensor.copy_(tmp)
        return tensor
    return Handle([work], finish)


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    process_set: Optional[ProcessSet] = None,
                    name: Optional[str] = None) -> Handle:
    """Start :func:`broadcast`; ``synchronize`` returns a new tensor."""
    return broadcast_async_(tensor.clone(), root_rank, process_set)


def broadcast(tensor: torch.Tensor, root_rank: int,
              process_set: Optional[ProcessSet] = None,
              name: Optional[str] = None) -> torch.Tensor:
    """``root_rank``'s tensor on every rank (``hvd.broadcast``); returns a
    new tensor."""
    return broadcast_async(tensor, root_rank, process_set).synchronize()


def broadcast_(tensor: torch.Tensor, root_rank: int,
               process_set: Optional[ProcessSet] = None,
               name: Optional[str] = None) -> torch.Tensor:
    """In-place :func:`broadcast`."""
    return broadcast_async_(tensor, root_rank, process_set).synchronize()


def _rows(tensor: torch.Tensor) -> torch.Tensor:
    x = tensor.contiguous()
    return x.reshape(1) if x.dim() == 0 else x


def _issue_allgather(x: torch.Tensor, ps: ProcessSet):
    """(work, parts): every member's ``x`` into ``parts``, in set order."""
    parts = [torch.empty_like(x) for _ in range(ps.size())]
    return dist.all_gather(parts, x, group=ps.group, async_op=True), parts


def allgather_async(tensor: torch.Tensor,
                    process_set: Optional[ProcessSet] = None,
                    name: Optional[str] = None) -> Handle:
    """Start :func:`allgather`; ``synchronize`` returns the concatenation."""
    return grouped_allgather_async([tensor], process_set).then(
        lambda out: out[0])


def allgather(tensor: torch.Tensor,
              process_set: Optional[ProcessSet] = None,
              name: Optional[str] = None) -> torch.Tensor:
    """Every rank's tensor concatenated along dim 0, in rank order
    (``hvd.allgather``); all ranks pass the same shape (see
    :func:`ragged_allgather` for per-rank dim-0 sizes)."""
    return allgather_async(tensor, process_set).synchronize()


def grouped_allgather_async(tensors: Sequence[torch.Tensor],
                            process_set: Optional[ProcessSet] = None,
                            name: Optional[str] = None) -> Handle:
    """Start :func:`grouped_allgather`; ``synchronize`` returns the list."""
    ps = _resolve_ps(process_set)
    xs = [_rows(t) for t in tensors]
    if not ps.included():
        return _ready([x.new_zeros((ps.size() * x.shape[0],) + x.shape[1:])
                       for x in xs])
    issued = [_issue_allgather(x, ps) for x in xs]
    return Handle([w for w, _ in issued],
                  lambda: [torch.cat(parts, dim=0) for _, parts in issued])


def grouped_allgather(tensors: Sequence[torch.Tensor],
                      process_set: Optional[ProcessSet] = None,
                      name: Optional[str] = None) -> List[torch.Tensor]:
    """:func:`allgather` of each tensor, issued together
    (``hvd.grouped_allgather``)."""
    return grouped_allgather_async(tensors, process_set).synchronize()


def _exchange_counts(counts: Sequence[int], ps: ProcessSet,
                     device: torch.device) -> List[List[int]]:
    """Every member's ``counts`` row, in set order (one blocking
    all-gather; on the device under NCCL)."""
    if dist.get_backend(ps.group) == "nccl" and device.type != "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    row = torch.tensor(list(counts), dtype=torch.int64, device=device)
    parts = [torch.empty_like(row) for _ in range(ps.size())]
    dist.all_gather(parts, row, group=ps.group)
    return torch.stack(parts).tolist()


def ragged_allgather(tensor: torch.Tensor,
                     process_set: Optional[ProcessSet] = None,
                     name: Optional[str] = None) -> torch.Tensor:
    """Every member's rows concatenated along dim 0, where dim 0 may differ
    from rank to rank (the reference's eager ``ragged_allgather`` and
    upstream allgather's ragged mode): the sizes are exchanged first, then
    each rank's rows travel padded to the largest."""
    ps = _resolve_ps(process_set)
    x = _rows(tensor)
    if not ps.included():
        return x[:0].clone()
    sizes = [row[0] for row in _exchange_counts([x.shape[0]], ps, x.device)]
    top = max(sizes)
    if x.shape[0] < top:
        x = torch.cat([x, x.new_zeros((top - x.shape[0],) + x.shape[1:])])
    work, parts = _issue_allgather(x, ps)
    work.wait()
    return torch.cat([p[:n] for p, n in zip(parts, sizes)], dim=0)


def alltoall_async(tensor: torch.Tensor, splits=None,
                   process_set: Optional[ProcessSet] = None,
                   name: Optional[str] = None) -> Handle:
    """Start :func:`alltoall`; ``synchronize`` returns what it returns."""
    ps = _resolve_ps(process_set)
    k = ps.size()
    x = tensor.contiguous()
    if splits is None:
        if x.dim() == 0 or x.shape[0] % k:
            raise ValueError(f"alltoall requires dim0 ({tuple(x.shape)}) "
                             f"divisible by set size {k}")
        if not ps.included():
            return _ready(x.clone())
        out = torch.empty_like(x)
        work = dist.all_to_all_single(out, x, group=ps.group, async_op=True)
        return Handle([work], lambda: out)
    send = [int(s) for s in (splits.tolist() if torch.is_tensor(splits)
                             else splits)]
    if len(send) != k:
        raise ValueError(f"splits must have one entry per set member ({k}), "
                         f"got {len(send)}")
    if not ps.included():
        return _ready((x[:0].clone(), torch.zeros(k, dtype=torch.int64)))
    if sum(send) != x.shape[0] or min(send) < 0:
        raise ValueError(f"splits {send} do not cover the tensor's "
                         f"{x.shape[0]} rows")
    me = ps.rank()
    recv = [row[me] for row in _exchange_counts(send, ps, x.device)]
    out = x.new_empty((sum(recv),) + x.shape[1:])
    work = dist.all_to_all_single(out, x, output_split_sizes=recv,
                                  input_split_sizes=send, group=ps.group,
                                  async_op=True)
    return Handle([work], lambda: (out, torch.tensor(recv,
                                                     dtype=torch.int64)))


def alltoall(tensor: torch.Tensor, splits=None,
             process_set: Optional[ProcessSet] = None,
             name: Optional[str] = None):
    """Send slices of dim 0 to every member and gather theirs
    (``hvd.alltoall``).

    Without ``splits``: equal slices (dim 0 divisible by the set size);
    returns the received tensor, slices in set-rank order. With ``splits``
    (this rank's row count for each member, in set-rank order): returns
    ``(received, received_splits)``, ``received_splits[j]`` rows from member
    j, as the reference's torch frontend does."""
    return alltoall_async(tensor, splits, process_set).synchronize()


def grouped_reducescatter_async(tensors: Sequence[torch.Tensor],
                                op: int = Average,
                                process_set: Optional[ProcessSet] = None,
                                name: Optional[str] = None) -> Handle:
    """Start :func:`grouped_reducescatter`; ``synchronize`` returns the
    list."""
    if op not in (ReduceOp.Sum, ReduceOp.Average):
        raise ValueError("reducescatter supports Sum and Average")
    ps = _resolve_ps(process_set)
    k = ps.size()
    xs = [t.contiguous() for t in tensors]
    for x in xs:
        if x.dim() == 0 or x.shape[0] % k:
            raise ValueError(f"reducescatter requires dim0 "
                             f"({tuple(x.shape)}) divisible by {k}")
    if not ps.included():
        return _ready([x.new_zeros((x.shape[0] // k,) + x.shape[1:])
                       for x in xs])
    outs, works = [], []
    for x in xs:
        out = x.new_empty((x.shape[0] // k,) + x.shape[1:])
        works.append(dist.reduce_scatter(out, list(x.chunk(k)),
                                         op=dist.ReduceOp.SUM,
                                         group=ps.group, async_op=True))
        outs.append(out)

    def finish():
        return [_divide(o, k) if op == ReduceOp.Average else o
                for o in outs]
    return Handle(works, finish)


def grouped_reducescatter(tensors: Sequence[torch.Tensor],
                          op: int = Average,
                          process_set: Optional[ProcessSet] = None,
                          name: Optional[str] = None) -> List[torch.Tensor]:
    """:func:`reducescatter` of each tensor, issued together
    (``hvd.grouped_reducescatter``)."""
    return grouped_reducescatter_async(tensors, op,
                                       process_set).synchronize()


def reducescatter_async(tensor: torch.Tensor, op: int = Average,
                        process_set: Optional[ProcessSet] = None,
                        name: Optional[str] = None) -> Handle:
    """Start :func:`reducescatter`; ``synchronize`` returns this rank's
    chunk."""
    return grouped_reducescatter_async([tensor], op, process_set).then(
        lambda out: out[0])


def reducescatter(tensor: torch.Tensor, op: int = Average,
                  process_set: Optional[ProcessSet] = None,
                  name: Optional[str] = None) -> torch.Tensor:
    """Reduce every member's tensor, then keep this rank's equal chunk of
    dim 0 (``hvd.reducescatter``; Sum or Average, dim 0 divisible by the
    set size)."""
    return reducescatter_async(tensor, op, process_set).synchronize()


def barrier(process_set: Optional[ProcessSet] = None) -> None:
    """Block until every rank of the set arrives (``hvd.barrier``)."""
    ps = _resolve_ps(process_set)
    if not ps.included():
        return
    if dist.get_backend(ps.group) == "nccl":
        dist.barrier(group=ps.group,
                     device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=ps.group)


def broadcast_object(obj: Any, root_rank: int = 0,
                     process_set: Optional[ProcessSet] = None) -> Any:
    """A picklable object from ``root_rank`` on every rank
    (``hvd.broadcast_object``)."""
    ps = _resolve_ps(process_set)
    if not ps.included():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=int(root_rank), group=ps.group)
    return box[0]


def allgather_object(obj: Any, process_set: Optional[ProcessSet] = None,
                     name: Optional[str] = None) -> list:
    """Every member's picklable object, in set order
    (``hvd.allgather_object``); a rank outside the set gets []."""
    ps = _resolve_ps(process_set)
    if not ps.included():
        return []
    out = [None] * ps.size()
    dist.all_gather_object(out, obj, group=ps.group)
    return out
