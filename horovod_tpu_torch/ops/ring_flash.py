"""Ring flash attention: exact attention over rank-sharded sequences with
the port's flash kernels as the per-hop compute.

Port of ``horovod_tpu/ops/ring_flash.py``. Every hop runs the forward
kernel (``ops/flash_attention.py``) on the resident K/V block; the backward
is a second ring that runs the dQ and dK/dV kernels with the global lse and
a delta computed once, while the fp32 dK/dV partial sums (and the key-bias
cotangent, when it is wanted) travel with their block and arrive home after
n hops. Causality across shards becomes one of four modes a hop (see
:func:`mode_of`); the partial results merge in log space.

The hop's work is in module-level functions that take the resident block
and its source rank (:func:`fwd_hop`, :func:`bwd_hop`, :func:`safe_merge`);
the transport (``ops/ring_attention.Ring``) stays apart. Each hop's
exchange is posted before the hop's kernels and waited on after them, into
two alternating buffers, so the transfer can run under the kernels.
"""

from __future__ import annotations

import importlib
from typing import Optional

import torch

from horovod_tpu_torch.ops.flash_attention import _pack, _unpack
from horovod_tpu_torch.ops.ring_attention import (Ring, check_layout,
                                                  check_shard_input)

# The kernels' module (``ops.flash_attention`` is the function, as in the
# reference's package); its wrappers are looked up at each call.
fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")

__all__ = ["ring_flash_attention", "mode_of", "fwd_hop", "bwd_hop",
           "safe_merge"]

_NEG_INF = -1e30

# mode -> (causal, causal_offset) of the hop's kernels; "skip" runs none.
_KERNEL_MODES = {"full": (False, 0), "causal": (True, 0),
                 "strict": (True, -1)}


def mode_of(striped: bool, causal: bool, src: int, rank: int) -> str:
    """The kernel mode of the hop where ``rank``'s queries meet ``src``'s
    keys. Contiguous: "full" (src < rank), "causal" (src == rank), "skip"
    (src > rank). Striped: "causal" for src <= rank, "strict" (diagonal
    excluded, causal_offset -1) for src > rank, so every hop does about half
    a block."""
    if not causal:
        return "full"
    if striped:
        return "causal" if src <= rank else "strict"
    return "full" if src < rank else ("causal" if src == rank else "skip")


def safe_merge(o_acc, lse_acc, o_b, lse_b):
    """Log-space merge of two normalised partial attentions."""
    lse_new = torch.logaddexp(lse_acc, lse_b)
    # exp(-1e30 - -1e30) would be 1: gate on each side being live.
    zero = torch.zeros((), device=lse_new.device)
    w_acc = torch.where(lse_acc > _NEG_INF / 2,
                        torch.exp(lse_acc - lse_new), zero)
    w_b = torch.where(lse_b > _NEG_INF / 2, torch.exp(lse_b - lse_new),
                      zero)
    return o_acc * w_acc[..., None] + o_b * w_b[..., None], lse_new


def fwd_hop(q, block, seg_q, src, rank, h, scale, causal, striped,
            blocks=(None, None)):
    """One forward hop on packed tensors: ``rank``'s queries ``q`` (BH,
    Tq, D) against the resident ``block`` = (k, v, key bias (B, Tk) or
    None, key segment ids (B, Tk) or None) that came from ``src``.
    Returns (O fp32, lse (BH, Tq)), or None for a skipped hop."""
    mode = mode_of(striped, causal, src, rank)
    if mode == "skip":
        return None
    k, v, bias, seg_k = block
    c, offset = _KERNEL_MODES[mode]
    o, lse = fa.flash_fwd(q, k, v, bias, seg_q, seg_k, h, scale, c, offset,
                          *blocks)
    return o.float(), lse


def bwd_hop(q, block, seg_q, do, lse, delta, src, rank, h, scale, causal,
            striped, want_db=False, blocks=(None, None)):
    """One backward hop with the global ``lse`` and ``delta`` (BH, Tq):
    (dQ, dK, dV fp32, the key-bias cotangent (B, Tk) fp32 or None), or
    None for a skipped hop."""
    mode = mode_of(striped, causal, src, rank)
    if mode == "skip":
        return None
    k, v, bias, seg_k = block
    c, offset = _KERNEL_MODES[mode]
    dq = fa.flash_bwd_dq(q, k, v, bias, seg_q, seg_k, do, lse, delta, h,
                         scale, c, offset, *blocks)
    dk, dv, db = fa.flash_bwd_dkv(q, k, v, bias, seg_q, seg_k, do, lse,
                                  delta, h, scale, c, offset, want_db,
                                  *blocks)
    if db is not None:
        # the heads share one key bias
        db = db.view(-1, h, db.shape[1]).sum(dim=1)
    return dq.float(), dk.float(), dv.float(), db


def _block(parts, has_bias, has_seg):
    """(k, v, bias or None, seg or None) from the list a hop ships."""
    it = iter(parts)
    k, v = next(it), next(it)
    return (k, v, next(it) if has_bias else None,
            next(it) if has_seg else None)


def _buffers(ship, n):
    """Two sets of receive buffers for the blocks a hop ships (none on one
    rank, where a hop sends nothing)."""
    return [[torch.empty_like(x) for x in ship] for _ in range(2)] \
        if n > 1 else None


class _RingFlash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, bias, seg, ring, causal, scale, blocks,
                striped, h, want_dbias):
        n, rank = ring.n, ring.rank
        has_bias, has_seg = bias is not None, seg is not None
        ship = [x for x in (k, v, bias, seg) if x is not None]
        bufs = _buffers(ship, n)
        o_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse_acc = torch.full(q.shape[:2], _NEG_INF, device=q.device)
        for i in range(n):
            posted = (ring.post(ship, into=bufs[i % 2]) if i < n - 1
                      else None)
            hop = fwd_hop(q, _block(ship, has_bias, has_seg), seg,
                          (rank - i) % n, rank, h, scale, causal, striped,
                          blocks)
            if hop is not None:
                o_acc, lse_acc = safe_merge(o_acc, lse_acc, *hop)
            if posted is not None:
                ship = ring.wait(posted)
        o = o_acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, bias, seg, o, lse_acc)
        ctx.cfg = (ring, causal, scale, blocks, striped, h, want_dbias)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, seg, o, lse = ctx.saved_tensors
        ring, causal, scale, blocks, striped, h, want_dbias = ctx.cfg
        n, rank = ring.n, ring.rank
        has_bias, has_seg = bias is not None, seg is not None
        track_db = has_bias and want_dbias and ctx.needs_input_grad[3]
        do = do.to(q.dtype).contiguous()
        # delta = rowsum(dO * O) is the same on every hop: computed once.
        delta = (do.float() * o.float()).sum(dim=-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        ship = [x for x in (k, v, bias, seg) if x is not None]
        bufs = _buffers(ship, n)
        acc_posted = None
        for i in range(n):
            posted = (ring.post(ship, into=bufs[i % 2]) if i < n - 1
                      else None)
            hop = bwd_hop(q, _block(ship, has_bias, has_seg), seg, do, lse,
                          delta, (rank - i) % n, rank, h, scale, causal,
                          striped, track_db, blocks)
            # The resident block's dK/dV (and dbias) partial sums: zero at
            # home, else what the previous rank sent on.
            if acc_posted is None:
                acc = [torch.zeros(k.shape, dtype=torch.float32,
                                   device=k.device),
                       torch.zeros(v.shape, dtype=torch.float32,
                                   device=v.device)]
                if track_db:
                    acc.append(torch.zeros(bias.shape, dtype=torch.float32,
                                           device=bias.device))
            else:
                acc = ring.wait(acc_posted)
            if hop is not None:
                dq = dq + hop[0]
                acc = [a + g for a, g in zip(acc, hop[1:])]
            # After n hops every block's sums are back home.
            acc_posted = ring.post(acc)
            if posted is not None:
                ship = ring.wait(posted)
        acc = ring.wait(acc_posted)
        dbias = acc[2] if track_db else None
        return (dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype),
                dbias) + (None,) * 8


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         process_set=None, causal: bool = True,
                         scale: Optional[float] = None,
                         block_q: Optional[int] = None,
                         block_k: Optional[int] = None,
                         layout: str = "contiguous",
                         key_mask: Optional[torch.Tensor] = None,
                         segment_ids: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Exact attention with q/k/v sequence-sharded across the ranks of
    ``process_set`` (default: the global set), on the flash kernels.

    Same contract as :func:`~horovod_tpu_torch.ops.ring_attention.
    ring_attention`. With ``causal`` and the contiguous layout rank r skips
    n - r - 1 of its n hops; ``layout="striped"`` gives every hop about half
    a block on every rank.

    Args:
      q, k, v: (batch, t_local, heads, head_dim), this rank's shard.
      causal: the global causal mask.
      scale: logit scale; defaults to head_dim ** -0.5.
      block_q, block_k: tiles of the plain versions, for CPU tensors only
        (as :func:`~horovod_tpu_torch.ops.flash_attention.flash_attention`;
        the CUDA kernels' tiles are compiled in and naming one raises).
      key_mask: optional (batch, t_local) bool; it becomes the kernels'
        additive key bias and travels with its K/V block.
      segment_ids: optional (batch, t_local) int packing ids; the key-side
        copy travels with its block, each hop's kernels mask home queries
        against the resident keys.

    Returns (batch, t_local, heads, head_dim) in q's dtype.
    """
    b, t, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    check_layout(layout)
    if q.is_cuda:
        fa._refuse_blocks(block_q, block_k)
    check_shard_input("key_mask", key_mask, b, t)
    check_shard_input("segment_ids", segment_ids, b, t)
    bias = None
    if key_mask is not None:
        # (B, Tk): the kernels broadcast it over the heads of a batch row,
        # so the ring ships one bias a batch row, not h copies.
        bias = torch.where(key_mask.bool(), 0.0, _NEG_INF).to(
            torch.float32).contiguous()
    seg = None
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32).contiguous()
    ring = Ring.of(process_set)
    o = _RingFlash.apply(_pack(q), _pack(k), _pack(v), bias, seg, ring,
                         bool(causal), float(scale), (block_q, block_k),
                         layout == "striped", h, False)
    return _unpack(o, b, h)
