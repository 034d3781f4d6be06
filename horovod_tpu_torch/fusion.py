"""Tensor fusion: pack many small tensors into a few flat buffers.

Port of ``horovod_tpu/fusion.py``. Tensors are grouped by dtype in their
given order; each group is cut greedily into buckets of at most
``threshold_bytes`` (every tensor's capacity padded to
``FUSION_ALIGN_BYTES``, the planner of ``cpp/hvdtpu_core.cpp``
``hvd_fusion_plan``); a tensor larger than the threshold is first split into
aligned chunks of at most the threshold, each riding its own bucket.
``pad_elems > 1`` zero-pads every packed segment to a multiple of that many
elements. The plan is the reference's, bucket for bucket, so the same
tensors give the same buffers.

A bucket is one flat buffer on the tensors' device, filled by one
``torch.cat``; ``unpack`` slices the reduced buffers back, either into new
tensors or in place into given ones (the optimizer writes into ``p.grad``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch

__all__ = ["DEFAULT_FUSION_THRESHOLD_BYTES", "FUSION_ALIGN_BYTES",
           "plan_buckets", "split_oversize", "FusionPlan", "make_plan",
           "fuse"]

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

    def padded_len(self, s: int) -> int:
        n = self.segments[s][2]
        return -(-n // self.pad_elems) * self.pad_elems


def make_plan(numels: Sequence[int], dtypes: Sequence[torch.dtype],
              threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES,
              pad_elems: int = 1) -> FusionPlan:
    """The bucket layout for tensors of these sizes and dtypes."""
    itemsizes = [torch.empty((), dtype=dt).element_size() for dt in dtypes]
    segments, _ = split_oversize(numels, itemsizes, threshold_bytes)
    pad_elems = max(1, int(pad_elems))
    by_dtype: dict = {}            # dtype -> segment indices, first-seen order
    for s, (i, _, _) in enumerate(segments):
        by_dtype.setdefault(dtypes[i], []).append(s)
    buckets: List[List[int]] = []
    for segs in by_dtype.values():
        sizes = [-(-segments[s][2] // pad_elems) * pad_elems
                 * itemsizes[segments[s][0]] for s in segs]
        groups: dict = {}
        for s, b in zip(segs, plan_buckets(sizes, threshold_bytes)):
            groups.setdefault(b, []).append(s)
        buckets.extend(groups[b] for b in sorted(groups))
    return FusionPlan(segments, buckets, pad_elems)


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
