"""Quantized allreduce: 1-byte wire formats with per-block scales.

Port of ``horovod_tpu/ops/quantized.py`` (EQuARX-style, PAPERS.md
"Efficient Quantized AllReduce in XLA"). A plain cast to one byte would be
wrong -- the sum would overflow and mix scales -- so the reduction is
restructured into two phases, with dequantization at every reduction point:

1. **reduce-scatter phase**: each rank splits its buffer into one chunk
   per peer, quantizes it with one fp32 scale per ``BLOCK`` elements,
   exchanges payload and scales with ``all_to_all_single`` and reduces its
   own chunk exactly in fp32 (Average divides by the member count here,
   *before* re-quantization);
2. **all-gather phase**: the reduced chunk is re-quantized with fresh
   scales and ``all_gather_into_tensor`` reassembles the result on every
   rank, so every rank dequantizes the same bytes.

``"int8"`` rounds half to even onto 127 uniform steps of the block's
max-abs (``torch.round`` and ``jnp.round`` share the rule); ``"fp8"`` is
``torch.float8_e4m3fn`` with the block's max-abs at 448. Both keep the
reference's derived-scale floors, so a block whose max-abs is tiny keeps
scale 1 and its zeros stay zeros. The payload travels as ``uint8`` views,
so NCCL and gloo take it alike. The codes and scales are the reference's
bit for bit; the fp32 sum of the received contributions runs in rank
order, where the reference's ``jnp.sum`` picks its own order.

The quantize and dequantize passes are plain torch ops: the reference
computes them outside any Pallas kernel too.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["quantized_allreduce", "quantize_blocks", "dequantize_blocks",
           "wire_overhead_bytes", "BLOCK", "WIRE_FORMATS", "SCALE_BYTES"]

# Elements sharing one quantization scale.
BLOCK = 256

WIRE_FORMATS = ("int8", "fp8")

#: bytes of the fp32 scale shipped per quantization block
SCALE_BYTES = 4

_F8 = torch.float8_e4m3fn
_F8_MAX = 448.0
_TINY = float(np.finfo(np.float32).tiny)
# The reference's floors, as the fp32 constants it compares against:
# absmax / step must be a normal fp32 number, else a flushed scale turns
# zeros into 0/0.
_FLOOR = {"int8": float(np.float32(127.0 * _TINY)),
          "fp8": float(np.float32(_F8_MAX * _TINY))}

# ``all_gather_into_tensor`` under its newer name where torch has it.
ALL_GATHER_SINGLE = getattr(dist, "all_gather_single",
                            dist.all_gather_into_tensor)


def wire_overhead_bytes(nelems: int, block: int = BLOCK) -> int:
    """Scale bytes riding beside a quantized payload of ``nelems`` 1-byte
    values (one fp32 scale per started block)."""
    return SCALE_BYTES * (-(-nelems // block))


def _pad_tail(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    """Zero-pad the last dim up to a block multiple (zeros never raise a
    block's max-abs)."""
    L = x.shape[-1]
    pad = (-L) % block
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x, L


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded, as the reference's XLA divides. CUDA
    divides a tensor by a Python number as a product with the number's
    reciprocal, which can differ in the last bit; by a tensor it divides."""
    return x / x.new_full((), d)


def quantize_blocks(x: torch.Tensor, wire: str = "int8",
                    block: int = BLOCK):
    """(..., L) -> (codes (..., L), fp32 scales (..., ceil(L / block))),
    symmetric per-block max-abs scales; codes are ``int8`` or
    ``float8_e4m3fn``. A ragged tail is zero-padded inside and sliced
    back. Any float input is quantized in fp32."""
    if wire not in WIRE_FORMATS:
        raise ValueError(f"unknown wire format {wire!r}; expected one of "
                         f"{WIRE_FORMATS}")
    x, L = _pad_tail(x.to(torch.float32), block)
    shape = x.shape
    blocks = x.reshape(shape[:-1] + (shape[-1] // block, block))
    absmax = blocks.abs().amax(dim=-1)
    if wire == "int8":
        scale = torch.where(absmax > _FLOOR["int8"], true_div(absmax, 127.0),
                            torch.ones_like(absmax))
        q = torch.round(blocks / scale[..., None]).clamp_(-127, 127) \
            .to(torch.int8)
    else:
        scale = torch.where(absmax > _FLOOR["fp8"],
                            true_div(absmax, _F8_MAX),
                            torch.ones_like(absmax))
        q = (blocks / scale[..., None]).clamp_(-_F8_MAX, _F8_MAX).to(_F8)
    q = q.reshape(shape)
    if shape[-1] != L:
        q = q[..., :L]
    return q, scale


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor,
                      block: int = BLOCK) -> torch.Tensor:
    """Inverse of :func:`quantize_blocks` (fp32 out), ragged tails
    included."""
    x, L = _pad_tail(q.to(torch.float32), block)
    shape = x.shape
    out = (x.reshape(shape[:-1] + (shape[-1] // block, block))
           * scale[..., None]).reshape(shape)
    return out[..., :L] if shape[-1] != L else out


def _as_bytes(q: torch.Tensor) -> torch.Tensor:
    return q.contiguous().view(torch.uint8).reshape(-1)


def alltoall_codes(q: torch.Tensor, scale: torch.Tensor, group):
    """Phase 1's exchange: row j of ``q`` and ``scale`` goes to member j;
    returns ``(works, q_recv, scale_recv)``, row j from member j."""
    q_recv = torch.empty_like(q)
    s_recv = torch.empty_like(scale)
    works = [dist.all_to_all_single(q_recv.view(torch.uint8).view(-1),
                                    _as_bytes(q), group=group,
                                    async_op=True),
             dist.all_to_all_single(s_recv.view(-1),
                                    scale.contiguous().view(-1),
                                    group=group, async_op=True)]
    return works, q_recv, s_recv


def allgather_codes(q: torch.Tensor, scale: torch.Tensor, n: int, group):
    """Phase 2's exchange: every member's ``q`` and ``scale`` (1-D),
    concatenated in member order; returns ``(works, q_all, scale_all)``."""
    q_all = torch.empty(n * q.numel(), dtype=q.dtype, device=q.device)
    s_all = torch.empty(n * scale.numel(), dtype=scale.dtype,
                        device=scale.device)
    works = [ALL_GATHER_SINGLE(q_all.view(torch.uint8), _as_bytes(q),
                                group=group, async_op=True),
             ALL_GATHER_SINGLE(s_all, scale.contiguous().view(-1),
                                group=group, async_op=True)]
    return works, q_all, s_all


def reduce_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The exact fp32 sum of the dequantized rows, in row (rank) order."""
    rows = dequantize_blocks(q, scale)
    part = rows[0].clone()
    for j in range(1, rows.shape[0]):
        part += rows[j]
    return part


def issue_quantized_allreduce(flat: torch.Tensor, group, n: int,
                              wire: str, mean_k: Optional[float] = None,
                              per: Optional[int] = None, chunks: int = 1
                              ) -> Tuple[List, Callable[[], torch.Tensor]]:
    """Start the two-phase quantized allreduce of a 1-D fp32 buffer over
    the ``n`` members of ``group``, in ``chunks`` pieces of ``per``
    elements (a multiple of ``n * BLOCK``; by default one piece that holds
    the buffer); returns ``(works, finish)``, where ``finish()`` (after
    the works) returns the fp32 result. Every piece's phase 1 is issued
    before any phase 2; each phase 1 is waited for before its reduction
    (on NCCL that orders the device stream, it does not block the host).
    ``mean_k`` divides each reduced chunk before it is re-quantized
    (Average over ``mean_k`` contributors). A one-member group still
    quantizes."""
    L = flat.numel()
    if per is None:
        per = -(-L // (n * BLOCK)) * n * BLOCK
    c = per // n                           # a member's row, BLOCK-aligned
    buf = torch.nn.functional.pad(flat, (0, per * chunks - L))
    phase1 = [alltoall_codes(*quantize_blocks(
        buf[i * per:(i + 1) * per].view(n, c), wire), group)
        for i in range(chunks)]
    gathered, works = [], []
    for ws, q_recv, s_recv in phase1:
        for w in ws:
            w.wait()
        part = reduce_rows(q_recv, s_recv)
        if mean_k is not None:
            part = true_div(part, mean_k)
        ws2, q_all, s_all = allgather_codes(*quantize_blocks(part, wire), n,
                                            group)
        works.extend(ws2)
        gathered.append((q_all, s_all))

    def finish() -> torch.Tensor:
        outs = [dequantize_blocks(q.view(n, c),
                                  s.view(n, c // BLOCK)).reshape(-1)
                for q, s in gathered]
        return (outs[0] if chunks == 1 else torch.cat(outs))[:L]
    return works, finish


def quantized_allreduce(x: torch.Tensor, average: bool = True,
                        wire: str = "int8", process_set=None
                        ) -> torch.Tensor:
    """Allreduce ``x`` (any shape) over a process set (the global set by
    default) with a 1-byte wire format (``"int8"`` or ``"fp8"``); returns
    a new tensor of ``x``'s shape and dtype. ``average`` divides by the
    set's size before the re-quantization. A rank outside the set gets
    ``x`` back, as in the reference. Issued directly, without the
    controller's negotiation: every member must call it in the same
    order."""
    from horovod_tpu_torch.process_set import global_process_set
    ps = process_set if process_set is not None else global_process_set()
    if wire not in WIRE_FORMATS:
        raise ValueError(f"unknown wire format {wire!r}; expected one of "
                         f"{WIRE_FORMATS}")
    if not ps.included() or x.numel() == 0:
        return x.clone()
    n = ps.size()
    works, finish = issue_quantized_allreduce(
        x.reshape(-1).to(torch.float32), ps.group, n, wire,
        mean_k=float(n) if average else None)
    for w in works:
        w.wait()
    return finish().reshape(x.shape).to(x.dtype)
