"""Ulysses-style sequence parallelism: an all-to-all swaps sequence shards
for head shards, attention runs over the whole sequence on a subset of the
heads, and a second all-to-all swaps back.

Port of ``horovod_tpu/ops/sequence.py``. The swaps are
``torch.distributed.nn.functional.all_to_all_single`` over the process
set's group, which is differentiable (its backward is the reverse swap),
in place of the reference's ``lax.all_to_all`` over ``axis_name``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops.ring_attention import Ring, check_shard_input

__all__ = ["ulysses_attention"]

_NEG_INF = -1e30


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of ``x``'s leading dim goes to member j; the result's chunk
    j came from member j. With one member it is the identity and nothing
    is sent."""
    from torch.distributed.nn.functional import all_to_all_single
    if x.shape[0] == 1:
        return x
    x = x.contiguous()
    return all_to_all_single(torch.empty_like(x), x, group=group)


def _seq2head(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """(B, t_local, H, D) -> (B, n * t_local, H / n, D)."""
    b, t, h, d = x.shape
    y = x.reshape(b, t, n, h // n, d).permute(2, 0, 1, 3, 4)
    y = _all_to_all(y, group)                      # (n, B, t, H/n, D)
    return y.permute(1, 0, 2, 3, 4).reshape(b, n * t, h // n, d)


def _head2seq(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """(B, n * t_local, H / n, D) -> (B, t_local, H, D)."""
    b, tt, hn, d = x.shape
    t = tt // n
    y = x.reshape(b, n, t, hn, d).permute(1, 0, 2, 3, 4)
    y = _all_to_all(y, group)                      # (n, B, t, H/n, D)
    return y.permute(1, 2, 0, 3, 4).reshape(b, t, n * hn, d)


def _all_gather_seq(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """(B, t_local) of every member -> (B, n * t_local), in member order."""
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      process_set=None, causal: bool = True,
                      scale: Optional[float] = None,
                      impl: str = "dense", block_q: Optional[int] = None,
                      block_k: Optional[int] = None,
                      key_mask: Optional[torch.Tensor] = None,
                      segment_ids: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Attention with q/k/v (B, t_local, H, D) sequence-sharded over the
    ranks of ``process_set`` (default: the global set), contiguous layout.

    When the set's size n does not divide H, the heads are zero-padded up
    to the next multiple of n; the padded heads ride the all-to-alls and are
    sliced off the output. ``key_mask`` (B, t_local) bool (False keys
    masked) and ``segment_ids`` (B, t_local) int are all-gathered to the
    whole sequence. ``impl="flash"`` runs the local attention through
    :func:`~horovod_tpu_torch.ops.flash_attention.flash_attention` with
    ``block_q``/``block_k`` (plain versions' tiles, CPU only); ``"dense"``
    through fp32 scores.
    """
    if impl not in ("dense", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}; expected "
                         "'dense' or 'flash'")
    ring = Ring.of(process_set)
    n, group = ring.n, ring.group
    b, tq, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    check_shard_input("key_mask", key_mask, b, tq)
    check_shard_input("segment_ids", segment_ids, b, tq)
    pad_h = (-h) % n
    if pad_h:
        zpad = q.new_zeros((b, tq, pad_h, d))
        q, k, v = (torch.cat([x, zpad.to(x.dtype)], dim=2)
                   for x in (q, k, v))
    qh, kh, vh = (_seq2head(x, n, group) for x in (q, k, v))
    km = seg = None
    if key_mask is not None:
        # gloo gathers no bool: the mask travels as int32.
        km = _all_gather_seq(key_mask.to(torch.int32), n, group).bool()
    if segment_ids is not None:
        seg = _all_gather_seq(segment_ids, n, group)
    if impl == "flash":
        from horovod_tpu_torch.ops.flash_attention import flash_attention
        key_bias = None
        if km is not None:
            key_bias = torch.where(km, 0.0, _NEG_INF).to(torch.float32)
        out = flash_attention(qh, kh, vh, causal=causal, scale=scale,
                              block_q=block_q, block_k=block_k,
                              key_bias=key_bias, segment_ids=seg)
        return _head2seq(out, n, group)[:, :, :h]
    from horovod_tpu_torch.ops.attention import segment_mask
    t = qh.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(),
                          kh.float()) * scale
    if km is not None:
        logits = torch.where(km[:, None, None, :], logits, _NEG_INF)
    if seg is not None:
        logits = torch.where(segment_mask(seg, seg)[:, None], logits,
                             _NEG_INF)
    if causal:
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask[None, None], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if km is not None or seg is not None:
        # A row with every key masked softmaxes to uniform garbage: zero it
        # (visibility from the combined scores).
        any_visible = (logits.amax(dim=-1) > _NEG_INF / 2)[..., None]
        probs = torch.where(any_visible, probs,
                            torch.zeros((), device=q.device))
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vh.float())
    return _head2seq(out.to(q.dtype), n, group)[:, :, :h]
