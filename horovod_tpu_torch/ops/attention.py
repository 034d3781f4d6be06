"""Multi-head attention dispatch shared by the models: dense or flash.

Port of ``horovod_tpu/ops/attention.py`` (``multihead_attention``,
``segment_mask``, ``packed_positions`` and the single-device branch of
``sp_attention``). Layout (B, T, H, D) at every public function, masking
constant -1e30, and a row whose keys are all masked gives 0 on both paths.
Sequence-parallel attention (ring, Ulysses) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["multihead_attention", "ATTENTION_IMPLS", "segment_mask",
           "packed_positions", "sp_attention"]

ATTENTION_IMPLS = ("dense", "flash")

_NEG_INF = -1e30


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, impl: str, causal: bool,
                        key_mask: Optional[torch.Tensor] = None,
                        segment_ids: Optional[torch.Tensor] = None,
                        out_dtype: Optional[torch.dtype] = None,
                        flash_blocks: Optional[tuple] = None,
                        bias: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale [+ bias + masks]) v over (B, T, H, D).

    ``impl`` "dense" materialises the fp32 scores; "flash" runs the fused
    kernels (``ops/flash_attention.py``); anything else raises.
    ``key_mask`` (B, T_kv) bool masks False keys. ``segment_ids`` (B, T)
    blocks attention across packing segments. ``bias`` (H, Tq, Tk) or
    (B, H, Tq, Tk) is dense-only: the flash kernels' bias is per key.
    """
    if impl not in ATTENTION_IMPLS:
        raise ValueError(
            f"unknown attention impl {impl!r}; expected one of "
            f"{ATTENTION_IMPLS}")
    out_dtype = q.dtype if out_dtype is None else out_dtype
    d = q.shape[-1]

    if impl == "flash":
        if bias is not None:
            raise ValueError(
                "per-head 2-D attention bias requires impl='dense' (the "
                "flash kernel's fused bias is per-key only)")
        from horovod_tpu_torch.ops.flash_attention import flash_attention
        key_bias = None
        if key_mask is not None:
            key_bias = torch.where(key_mask, 0.0, _NEG_INF).to(torch.float32)
        blocks = {}
        if flash_blocks is not None:
            blocks = {"block_q": int(flash_blocks[0]),
                      "block_k": int(flash_blocks[1])}
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               key_bias=key_bias, segment_ids=segment_ids,
                               **blocks).to(out_dtype)

    scale = d ** -0.5 if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if bias is not None:
        s = s + (bias if bias.dim() == 4 else bias[None]).float()
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :], s, _NEG_INF)
    if segment_ids is not None:
        s = torch.where(segment_mask(segment_ids, segment_ids)[:, None], s,
                        _NEG_INF)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(out_dtype)
    if key_mask is not None or segment_ids is not None:
        # A fully masked row softmaxes to uniform garbage; zero it, as the
        # flash kernels do.
        any_visible = (s.amax(dim=-1) > _NEG_INF / 2)[..., None]
        p = torch.where(any_visible, p, torch.zeros((), dtype=p.dtype,
                                                    device=p.device))
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(p.dtype))


def segment_mask(seg_q: torch.Tensor, seg_k: torch.Tensor) -> torch.Tensor:
    """(B, Tq, Tk) bool: True where q and k share a packing segment."""
    return seg_q[:, :, None] == seg_k[:, None, :]


def packed_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """(B, T) positions restarting at 0 at every segment boundary."""
    t = segment_ids.shape[1]
    ar = torch.arange(t, device=segment_ids.device).expand_as(segment_ids)
    prev = torch.cat([segment_ids[:, :1] - 1, segment_ids[:, :-1]], dim=1)
    starts = torch.where(segment_ids != prev, ar, torch.zeros_like(ar))
    return ar - torch.cummax(starts, dim=1).values


def sp_attention(q, k, v, cfg, causal: bool = True, key_mask=None,
                 segment_ids=None) -> torch.Tensor:
    """The models' self-attention dispatch. Without sequence parallelism
    this is :func:`multihead_attention` with the config's impl, dtype and
    flash tiles."""
    if cfg.use_ring_attention:
        raise NotImplementedError(
            "sequence-parallel attention (ring / ulysses): not yet ported")
    return multihead_attention(q, k, v, impl=cfg.attention, causal=causal,
                               key_mask=key_mask, segment_ids=segment_ids,
                               out_dtype=cfg.dtype,
                               flash_blocks=cfg.flash_blocks)
