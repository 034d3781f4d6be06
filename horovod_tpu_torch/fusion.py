"""Tensor fusion: pack many small tensors into a few flat buffers.

Port of ``horovod_tpu/fusion.py``. Tensors are grouped by dtype in their
given order; each group is cut greedily into buckets of at most
``threshold_bytes`` (every tensor's capacity padded to
``FUSION_ALIGN_BYTES``, the planner of ``cpp/hvdtpu_core.cpp``
``hvd_fusion_plan``); a tensor larger than the threshold is first split into
aligned chunks of at most the threshold, each riding its own bucket.
``pad_elems > 1`` zero-pads every packed segment to a multiple of that many
elements (the quantized wire pads each tensor to whole quantization blocks,
so one tensor's magnitude never sets another's scale). The plan is the
reference's, bucket for bucket, so the same tensors give the same buffers.

The buckets go out first to last, or last first under ``reverse`` (the
reference's ``fused_apply(reverse=True)``: the backward produces the last
parameters' gradients first). :class:`BucketFiller` is the gradient-overlap
form of a plan: buckets fill as the backward produces their tensors, and a
full bucket is held back until every bucket before it in issue order has
gone, so every rank issues one order whatever order its gradient hooks
fire in (the reference's ``pin_order=True``; NCCL needs every rank to
issue its collectives in one order).

A bucket is one flat buffer on the tensors' device, filled by one
``torch.cat``; ``unpack`` slices the reduced buffers back, either into new
tensors or in place into given ones (the optimizer writes into ``p.grad``).

Every ``fuse`` records the reference's fusion metrics (``metrics.py``):
``fusion_tensors_total``, ``fusion_buckets_total``,
``fusion_flush_total{cause}`` and the fill-ratio and bucket-bytes
histograms, and a ``fusion_flush`` timeline marker per bucket under the
collective's span. Here they count per call: the reference's fusion runs at
trace time, so its counters count per compilation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from horovod_tpu_torch import metrics as _metrics
from horovod_tpu_torch import tracing as _tracing

__all__ = ["DEFAULT_FUSION_THRESHOLD_BYTES", "FUSION_ALIGN_BYTES",
           "plan_buckets", "split_oversize", "FusionPlan", "make_plan",
           "fuse", "issue_order", "BucketFiller"]

DEFAULT_FUSION_THRESHOLD_BYTES = 64 * 1024 * 1024

# Capacity of each tensor in a bucket is counted in multiples of this.
FUSION_ALIGN_BYTES = 512


def plan_buckets(sizes: Sequence[int], threshold_bytes: int,
                 align_bytes: int = FUSION_ALIGN_BYTES) -> List[int]:
    """Bucket index for each size in bytes: greedy and stable; a bucket
    closes when the next aligned size would overflow the threshold, and a
    size above the threshold gets a bucket to itself."""
    align = max(1, int(align_bytes))
    out: List[int] = []
    used, bucket = 0, -1
    for sz in sizes:
        sz = -(-int(sz) // align) * align
        if bucket < 0 or used + sz > threshold_bytes:
            bucket += 1
            used = 0
        out.append(bucket)
        used += sz
    return out


def split_oversize(numels: Sequence[int], itemsizes: Sequence[int],
                   threshold_bytes: int):
    """Segments ``[(tensor_idx, start_elem, n_elem), ...]`` and the set of
    tensors that were split: a tensor within the threshold is one segment,
    a larger one is cut into aligned chunks of at most the threshold."""
    segments = []
    split = set()
    for i, (n, isz) in enumerate(zip(numels, itemsizes)):
        if n * isz <= threshold_bytes or n <= 1:
            segments.append((i, 0, n))
            continue
        split.add(i)
        align_elems = max(1, FUSION_ALIGN_BYTES // isz)
        chunk = max(align_elems,
                    (threshold_bytes // isz) // align_elems * align_elems)
        off = 0
        while off < n:
            c = min(chunk, n - off)
            segments.append((i, off, c))
            off += c
    return segments, split


@dataclass(frozen=True)
class FusionPlan:
    segments: List[Tuple[int, int, int]]   # (tensor, start, n) elements
    buckets: List[List[int]]               # bucket -> segment indices
    pad_elems: int
    # Why each bucket closed: "oversize_leaf" (only chunks of split
    # tensors), "capacity" (the next segment would overflow) or
    # "end_of_group" (last bucket of its dtype).
    causes: List[str]

    def padded_len(self, s: int) -> int:
        n = self.segments[s][2]
        return -(-n // self.pad_elems) * self.pad_elems


def make_plan(numels: Sequence[int], dtypes: Sequence[torch.dtype],
              threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES,
              pad_elems: int = 1) -> FusionPlan:
    """The bucket layout for tensors of these sizes and dtypes."""
    itemsizes = [torch.empty((), dtype=dt).element_size() for dt in dtypes]
    segments, split = split_oversize(numels, itemsizes, threshold_bytes)
    pad_elems = max(1, int(pad_elems))
    by_dtype: dict = {}            # dtype -> segment indices, first-seen order
    for s, (i, _, _) in enumerate(segments):
        by_dtype.setdefault(dtypes[i], []).append(s)
    buckets: List[List[int]] = []
    causes: List[str] = []
    for segs in by_dtype.values():
        sizes = [-(-segments[s][2] // pad_elems) * pad_elems
                 * itemsizes[segments[s][0]] for s in segs]
        groups: dict = {}
        for s, b in zip(segs, plan_buckets(sizes, threshold_bytes)):
            groups.setdefault(b, []).append(s)
        ordered = [groups[b] for b in sorted(groups)]
        buckets.extend(ordered)
        for j, g in enumerate(ordered):
            if all(segments[s][0] in split for s in g):
                causes.append("oversize_leaf")
            elif j < len(ordered) - 1:
                causes.append("capacity")
            else:
                causes.append("end_of_group")
    return FusionPlan(segments, buckets, pad_elems, causes)


def _record(plan: FusionPlan, itemsizes: Sequence[int],
            threshold_bytes: int) -> None:
    """The reference's fusion metrics and markers for one plan."""
    _metrics.counter("fusion_tensors_total").inc(len(itemsizes))
    _metrics.counter("fusion_buckets_total").inc(len(plan.buckets))
    span = _tracing.current_span()
    for b, (segs, cause) in enumerate(zip(plan.buckets, plan.causes)):
        nbytes = sum(plan.segments[s][2] * itemsizes[plan.segments[s][0]]
                     for s in segs)
        _metrics.counter("fusion_flush_total", cause=cause).inc()
        _metrics.histogram("fusion_fill_ratio",
                           buckets=_metrics.RATIO_BUCKETS).observe(
            nbytes / max(threshold_bytes, 1))
        _metrics.histogram("fusion_bucket_bytes",
                           buckets=_metrics.SIZE_BUCKETS).observe(nbytes)
        if span is not None:
            _metrics._timeline_marker(
                "fusion_flush", category="fusion", op_id=span.op_id,
                tensor=span.tensor, bucket=b,
                member_leaves=sorted({plan.segments[s][0] for s in segs}),
                bytes=nbytes, cause=cause)


def fuse(tensors: Sequence[torch.Tensor],
         threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES,
         pad_elems: int = 1
         ) -> Tuple[List[torch.Tensor], Callable[..., List[torch.Tensor]]]:
    """Pack ``tensors`` into flat buckets.

    Returns ``(buckets, unpack)``. ``unpack(new_buckets)`` returns new
    tensors shaped like the inputs; ``unpack(new_buckets, out=tensors)``
    copies into the given tensors in place and returns them.
    """
    tensors = list(tensors)
    plan = make_plan([t.numel() for t in tensors],
                     [t.dtype for t in tensors], threshold_bytes, pad_elems)
    _record(plan, [t.element_size() for t in tensors], threshold_bytes)
    flats = [t.reshape(-1) for t in tensors]

    def piece(s: int) -> List[torch.Tensor]:
        i, start, n = plan.segments[s]
        out = [flats[i][start:start + n]]
        pad = plan.padded_len(s) - n
        if pad:
            out.append(flats[i].new_zeros(pad))
        return out

    buckets = []
    for segs in plan.buckets:
        parts = [p for s in segs for p in piece(s)]
        buckets.append(parts[0].clone() if len(parts) == 1
                       else torch.cat(parts))

    def unpack(new_buckets: Sequence[torch.Tensor],
               out: Optional[Sequence[torch.Tensor]] = None
               ) -> List[torch.Tensor]:
        dst = ([torch.empty_like(t) for t in tensors] if out is None
               else list(out))
        # Buckets hold each tensor in its logical (row-major) order; a
        # destination in another memory format (a channels_last conv's
        # gradient) is filled through a row-major staging copy.
        dst_flat = [d.view(-1) if d.is_contiguous()
                    else d.new_empty(d.numel()) for d in dst]
        for b, segs in enumerate(plan.buckets):
            buf = new_buckets[b]
            off = 0
            for s in segs:
                i, start, n = plan.segments[s]
                dst_flat[i][start:start + n].copy_(buf[off:off + n])
                off += plan.padded_len(s)
        for d, flat in zip(dst, dst_flat):
            if not d.is_contiguous():
                d.copy_(flat.view(d.shape))
        return dst

    return buckets, unpack


def issue_order(n_buckets: int, reverse: bool = False) -> range:
    """The order buckets are issued in: first to last, or last first."""
    return range(n_buckets - 1, -1, -1) if reverse else range(n_buckets)


class BucketFiller:
    """Which buckets of ``plan`` may go out as their tensors become ready.

    :meth:`mark` takes the index of a tensor whose value is final and
    returns the buckets to issue now, in issue order (``reverse``: last
    bucket first): a full bucket waits for every bucket before it in issue
    order. :meth:`rest` returns the buckets not issued yet, in issue order
    (a tensor that got no value leaves its bucket to the end of the step).
    :meth:`reset` starts the next step."""

    def __init__(self, plan: FusionPlan, reverse: bool = True):
        self.plan = plan
        self.order = list(issue_order(len(plan.buckets), reverse))
        bucket_of = {s: b for b, segs in enumerate(plan.buckets)
                     for s in segs}
        self._buckets_of: dict = {}
        for s, (i, _, _) in enumerate(plan.segments):
            self._buckets_of.setdefault(i, []).append(bucket_of[s])
        self.reset()

    def reset(self) -> None:
        self._left = [len(segs) for segs in self.plan.buckets]
        self._next = 0

    def mark(self, tensor: int) -> List[int]:
        for b in self._buckets_of.get(tensor, ()):
            self._left[b] -= 1
        return self._take(lambda b: self._left[b] == 0)

    def rest(self) -> List[int]:
        return self._take(lambda b: True)

    def _take(self, full) -> List[int]:
        out = []
        while self._next < len(self.order) and full(self.order[self._next]):
            out.append(self.order[self._next])
            self._next += 1
        return out
