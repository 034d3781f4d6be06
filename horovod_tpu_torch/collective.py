"""Eager collectives over ``torch.distributed``: NCCL on the GPU, gloo on
the CPU.

Port of the eager half of ``horovod_tpu/collective.py``. Each rank passes
its own tensor and gets the result back (the reference simulates all ranks
in one process with ``tensor[r]`` as rank r's value; here every rank is a
process). Reductions keep the reference's semantics: ``prescale_factor`` and
``postscale_factor`` apply to Sum and Average only, on the wire dtype, around
the reduction; Average divides the sum by the set's size (floor division for
integer tensors).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch import fusion as _fusion
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.config import get_config
from horovod_tpu_torch.process_set import ProcessSet, global_process_set

__all__ = ["ReduceOp", "Average", "Sum", "Min", "Max", "Product", "Adasum",
           "allreduce", "grouped_allreduce", "broadcast",
           "broadcast_", "allgather", "barrier", "broadcast_object"]


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

_SCALING_OPS = (ReduceOp.Average, ReduceOp.Sum)

_DIST_OPS = {
    ReduceOp.Average: dist.ReduceOp.SUM,
    ReduceOp.Sum: dist.ReduceOp.SUM,
    ReduceOp.Min: dist.ReduceOp.MIN,
    ReduceOp.Max: dist.ReduceOp.MAX,
    ReduceOp.Product: dist.ReduceOp.PRODUCT,
}


def _resolve_ps(process_set: Optional[ProcessSet]) -> ProcessSet:
    return process_set if process_set is not None else global_process_set()


def _check_reduce(op: int, prescale: float, postscale: float,
                  compression) -> None:
    if op == ReduceOp.Adasum:
        raise NotImplementedError("Adasum: not yet ported")
    if op not in _DIST_OPS:
        raise ValueError(f"unknown reduce op {op}")
    if op not in _SCALING_OPS and (prescale != 1.0 or postscale != 1.0):
        raise ValueError("prescale/postscale only apply to Sum/Average/Adasum")
    if getattr(compression, "wire", None) is not None:
        raise NotImplementedError("quantized wire: not yet ported")


def _reduce_inplace(buf: torch.Tensor, op: int, ps: ProcessSet,
                    prescale: float, postscale: float) -> torch.Tensor:
    """Reduce ``buf`` (already on the wire dtype) in place across ``ps``."""
    if op in _SCALING_OPS and prescale != 1.0:
        buf.mul_(prescale)
    dist.all_reduce(buf, op=_DIST_OPS[op], group=ps.group)
    if op == ReduceOp.Average:
        k = ps.size()
        if buf.is_floating_point():
            buf.div_(k)
        else:
            buf.floor_divide_(k)
    if op in _SCALING_OPS and postscale != 1.0:
        buf.mul_(postscale)
    return buf


def allreduce(tensor: torch.Tensor, op: int = Average,
              process_set: Optional[ProcessSet] = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              compression=Compression.none,
              name: Optional[str] = None) -> torch.Tensor:
    """Reduce this rank's ``tensor`` with every other rank's
    (``hvd.allreduce``). Returns a new tensor; the input is left as is."""
    _check_reduce(op, float(prescale_factor), float(postscale_factor),
                  compression)
    ps = _resolve_ps(process_set)
    c, ctx = compression.compress(tensor)
    buf = c.clone() if c is tensor else c.contiguous()
    _reduce_inplace(buf, op, ps, float(prescale_factor),
                    float(postscale_factor))
    return compression.decompress(buf, ctx)


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
    _check_reduce(op, float(prescale_factor), float(postscale_factor),
                  compression)
    tensors = list(tensors)
    if not tensors:
        return []
    ps = _resolve_ps(process_set)
    if fusion_threshold_bytes is None:
        fusion_threshold_bytes = get_config().fusion_threshold_bytes
    buckets, unpack = _fusion.fuse(tensors, int(fusion_threshold_bytes))
    reduced = []
    for buf in buckets:
        c, ctx = compression.compress(buf)
        _reduce_inplace(c, op, ps, float(prescale_factor),
                        float(postscale_factor))
        reduced.append(compression.decompress(c, ctx))
    return unpack(reduced, out=out)


def broadcast(tensor: torch.Tensor, root_rank: int,
              process_set: Optional[ProcessSet] = None,
              name: Optional[str] = None) -> torch.Tensor:
    """``root_rank``'s tensor on every rank (``hvd.broadcast``); returns a
    new tensor."""
    out = tensor.clone()
    return broadcast_(out, root_rank, process_set=process_set)


def broadcast_(tensor: torch.Tensor, root_rank: int,
               process_set: Optional[ProcessSet] = None,
               name: Optional[str] = None) -> torch.Tensor:
    """In-place :func:`broadcast`."""
    ps = _resolve_ps(process_set)
    if ps.ranks is not None and root_rank not in ps.ranks:
        raise ValueError(f"root rank {root_rank} not in process set "
                         f"{ps.ranks}")
    # NCCL moves device memory only: a host tensor (an optimizer's step
    # count) is staged through the device.
    staged = (tensor.device.type == "cpu"
              and dist.get_backend(ps.group) == "nccl")
    if tensor.is_contiguous() and not staged:
        dist.broadcast(tensor, src=int(root_rank), group=ps.group)
    else:
        tmp = (tensor.to(torch.device("cuda", torch.cuda.current_device()))
               if staged else tensor.contiguous())
        dist.broadcast(tmp, src=int(root_rank), group=ps.group)
        tensor.copy_(tmp)
    return tensor


def allgather(tensor: torch.Tensor,
              process_set: Optional[ProcessSet] = None,
              name: Optional[str] = None) -> torch.Tensor:
    """Every rank's tensor concatenated along dim 0, in rank order
    (``hvd.allgather``); all ranks pass the same shape."""
    ps = _resolve_ps(process_set)
    x = tensor.contiguous()
    if x.dim() == 0:
        x = x.reshape(1)
    parts = [torch.empty_like(x) for _ in range(ps.size())]
    dist.all_gather(parts, x, group=ps.group)
    return torch.cat(parts, dim=0)


def barrier(process_set: Optional[ProcessSet] = None) -> None:
    """Block until every rank of the set arrives (``hvd.barrier``)."""
    ps = _resolve_ps(process_set)
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
    box = [obj]
    dist.broadcast_object_list(box, src=int(root_rank), group=ps.group)
    return box[0]
