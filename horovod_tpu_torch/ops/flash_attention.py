"""Fused flash attention: CUDA kernels for Hopper with plain PyTorch twins.

Port of ``horovod_tpu/ops/flash_attention.py``. The FlashAttention-2 scheme
(online softmax forward, recomputing backward split into a dQ pass and a
dK/dV pass) keeps its definition exactly: fp32 scores and accumulators, the
masking of ``_mask_scores`` (key bias, then segment ids, then the ragged-edge
and causal position mask, every masked score set to ``-1e30``), masked P and
dS entries exactly 0, and a row with no visible key giving O = 0 and
lse = -1e30. Residuals are O and the per-row logsumexp only.

Three kernels, each with a plain PyTorch version of the same blockwise
function beside it:

* ``flash_fwd``     -> ``csrc/flash_fwd.cu``  (TPU ``_fwd_kernel``)
* ``flash_bwd_dq``  -> ``csrc/flash_bwd.cu``  (TPU ``_bwd_dq_kernel``)
* ``flash_bwd_dkv`` -> ``csrc/flash_bwd.cu``  (TPU ``_bwd_dkv_kernel``)

A wrapper takes its plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel on the current stream of the inputs' own
device, or raises; there is no fallback. Each wrapper counts its kernel
launches in :data:`launches`; while a profiler cost capture is open
(:data:`flop_tally` set) it also reports the launch's FLOPs, 4·d, 6·d and
8·d a visible (q, k) pair (:func:`visible_pairs`), from whatever thread
launches it. For bf16 inputs all three kernels run their
products on the tensor cores; fp32 inputs take FMA kernels that keep full
fp32 products (see the sources).

``block_q``/``block_k`` (and ``_bwd``) tile the plain versions only. The
CUDA kernels' tiles are compiled in and follow from the head dim (see the
sources), so naming a block for CUDA tensors raises. ``delta = rowsum(dO *
O)`` and the head-sum of the bias gradient stay plain torch outside the
kernels, as in the reference.

Every kernel and plain version takes the query's segment ids ``seg_q``
(B, Tq) and the keys' ``seg_k`` (B, Tk) as two tensors, both or neither, as
the reference's kernels do: a ring hop masks the home queries against the
resident key block's ids. :func:`flash_attention` passes one tensor as both.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = ["flash_attention", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_fwd_plain", "flash_bwd_dq_plain", "flash_bwd_dkv_plain",
           "launches", "reset_launches", "DEFAULT_BLOCKS", "KERNELS",
           "FLOPS_PER_PAIR", "visible_pairs"]

_NEG_INF = -1e30

# Tiles of the plain versions when the caller names none.
DEFAULT_BLOCKS = (128, 128)

KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

# Kernel launches per wrapper since the last reset_launches().
launches: Dict[str, int] = {k: 0 for k in KERNELS}


def reset_launches() -> None:
    for k in KERNELS:
        launches[k] = 0


# FLOPs of each kernel per visible (q, k) pair and head dim: QK^T and PV
# (forward); QK^T, dP and dS K (dQ); QK^T, dP, P^T dO and dS^T Q (dK/dV).
FLOPS_PER_PAIR = {"flash_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}

# ``flop_tally(kernel, flops)`` while a profiler cost capture is open
# (``profiler.CostCapture``), else None: one branch a launch. Process-wide,
# not thread-local: a CUDA backward launches from autograd's own thread.
flop_tally = None


def visible_pairs(tq, tk, bh, h, causal, offset=0, bias=None, seg_q=None,
                  seg_k=None) -> int:
    """Visible (q, k) pairs of one launch, summed over its ``bh`` rows:
    the causal diagonal shifted by ``offset``, then keys whose ``bias`` is
    above -1e29 and keys of the query's segment. A ``bias`` or segment ids
    make the count data-dependent: their (B, T) rows are copied to the host
    and counted there, so the count allocates nothing on the card."""
    if bias is None and seg_q is None:
        rows = (sum(min(max(i + offset + 1, 0), tk) for i in range(tq))
                if causal else tq * tk)
        return rows * bh
    b = bh // h
    keep = (torch.ones(b, tk, dtype=torch.bool) if bias is None
            else bias.detach().cpu() > -1e29)
    # the last key each query sees; below 0: none
    last = (torch.arange(tq) + offset).clamp(max=tk - 1) if causal else \
        torch.full((tq,), tk - 1)
    if seg_q is None:
        kept = torch.cat([torch.zeros(b, 1, dtype=torch.long),
                          keep.cumsum(1)], 1)       # kept keys before j
        return int(kept[:, (last + 1).clamp(min=0)].sum()) * h
    sq, sk = seg_q.detach().cpu(), seg_k.detach().cpu()
    pos = torch.arange(tk)
    n = 0
    for r in range(b):
        # Each kept key coded (its segment, its position) on one sorted
        # line: a query's visible keys are the codes from (its segment, 0)
        # to (its segment, last).
        _, ids = torch.unique(torch.cat([sq[r], sk[r]]), return_inverse=True)
        code = (ids[tq:] * (tk + 1) + pos)[keep[r]].sort().values
        lo = ids[:tq] * (tk + 1)
        seen = (torch.searchsorted(code, lo + last, right=True)
                - torch.searchsorted(code, lo))
        n += int(seen[last >= 0].sum())
    return n * h


def _tally(kernel, q, k, bias, seg_q, seg_k, h, causal, offset) -> None:
    bh, tq, d = q.shape
    flop_tally(kernel, FLOPS_PER_PAIR[kernel] * d * visible_pairs(
        tq, k.shape[1], bh, h, causal, offset, bias, seg_q, seg_k))


# ---------------------------------------------------------------------------
# Plain versions (blockwise, same order of operations as the TPU kernels)
# ---------------------------------------------------------------------------

def _per_row(x: Optional[torch.Tensor], h: int) -> Optional[torch.Tensor]:
    """(B, T) per-batch input -> (B*H, T), one row per packed head."""
    return None if x is None else x.repeat_interleave(h, dim=0)


def _mask_scores(s, q0, k0, tq, tk, causal, offset, bias, seg_q, seg_k):
    """``_mask_scores`` of the reference on an (bh, nq, nk) fp32 block."""
    nq, nk = s.shape[1], s.shape[2]
    if bias is not None:
        s = s + bias[:, None, :]
    if seg_q is not None:
        s = torch.where(seg_q[:, :, None] == seg_k[:, None, :], s,
                        torch.full_like(s, _NEG_INF))
    q_pos = torch.arange(q0, q0 + nq, device=s.device)[:, None]
    k_pos = torch.arange(k0, k0 + nk, device=s.device)[None, :]
    ok = (q_pos < tq) & (k_pos < tk)
    if causal:
        ok = ok & (q_pos + offset >= k_pos)
    return torch.where(ok[None], s, torch.full_like(s, _NEG_INF))


def _visible_block(causal, q0, bq, k0, offset) -> bool:
    """``_causal_skip``: False when the (q, k) block pair has no visible
    entry."""
    return (not causal) or k0 < q0 + bq + offset


def flash_fwd_plain(q, k, v, bias, seg_q, seg_k, h, scale, causal, offset=0,
                    block_q=DEFAULT_BLOCKS[0], block_k=DEFAULT_BLOCKS[1]):
    """Plain version of the forward kernel on packed (BH, T, d) inputs.
    ``bias`` (B, Tk) fp32, ``seg_q`` (B, Tq) and ``seg_k`` (B, Tk) int.
    Returns (O, lse (BH, Tq))."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    bias_r = _per_row(bias, h)
    segq_r, segk_r = _per_row(seg_q, h), _per_row(seg_k, h)
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    for q0 in range(0, tq, block_q):
        qb = q[:, q0:q0 + block_q].float() * scale
        nq = qb.shape[1]
        m = torch.full((bh, nq), _NEG_INF, device=q.device)
        l = torch.zeros((bh, nq), device=q.device)
        acc = torch.zeros((bh, nq, d), device=q.device)
        for k0 in range(0, tk, block_k):
            if not _visible_block(causal, q0, block_q, k0, offset):
                continue
            kb = k[:, k0:k0 + block_k].float()
            vb = v[:, k0:k0 + block_k].float()
            nk = kb.shape[1]
            s = _mask_scores(
                qb @ kb.transpose(1, 2), q0, k0, tq, tk, causal, offset,
                None if bias_r is None else bias_r[:, k0:k0 + nk],
                None if segq_r is None else segq_r[:, q0:q0 + nq],
                None if segk_r is None else segk_r[:, k0:k0 + nk])
            m_new = torch.maximum(m, s.amax(dim=2))
            p = torch.exp(s - m_new[:, :, None])
            p = torch.where(s > _NEG_INF / 2, p, torch.zeros_like(p))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=2)
            acc = acc * corr[:, :, None] + p @ vb
            m = m_new
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
        o[:, q0:q0 + nq] = (acc / l_safe[:, :, None]).to(q.dtype)
        lse[:, q0:q0 + nq] = m + torch.log(l_safe)
    return o, lse


def _probs_and_ds(q, k, v, do, lse, delta, q0, k0, nq, nk, tq, tk, scale,
                  causal, offset, bias_r, segq_r, segk_r):
    """P and dS of one (q, k) block, recomputed from lse (fp32)."""
    qb = q[:, q0:q0 + nq].float() * scale
    kb = k[:, k0:k0 + nk].float()
    s = _mask_scores(
        qb @ kb.transpose(1, 2), q0, k0, tq, tk, causal, offset,
        None if bias_r is None else bias_r[:, k0:k0 + nk],
        None if segq_r is None else segq_r[:, q0:q0 + nq],
        None if segk_r is None else segk_r[:, k0:k0 + nk])
    p = torch.exp(s - lse[:, q0:q0 + nq, None])
    p = torch.where(s > _NEG_INF / 2, p, torch.zeros_like(p))
    dob = do[:, q0:q0 + nq].float()
    dp = dob @ v[:, k0:k0 + nk].float().transpose(1, 2)
    ds = torch.where(p > 0.0, p * (dp - delta[:, q0:q0 + nq, None]),
                     torch.zeros_like(p))
    return qb, kb, dob, p, ds


def flash_bwd_dq_plain(q, k, v, bias, seg_q, seg_k, do, lse, delta, h, scale,
                       causal, offset=0, block_q=DEFAULT_BLOCKS[0],
                       block_k=DEFAULT_BLOCKS[1]):
    """Plain version of the dQ kernel. ``lse``/``delta`` are (BH, Tq) fp32.
    Returns dQ in q's dtype."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    bias_r = _per_row(bias, h)
    segq_r, segk_r = _per_row(seg_q, h), _per_row(seg_k, h)
    dq = torch.empty_like(q)
    for q0 in range(0, tq, block_q):
        nq = min(block_q, tq - q0)
        acc = torch.zeros((bh, nq, d), device=q.device)
        for k0 in range(0, tk, block_k):
            if not _visible_block(causal, q0, block_q, k0, offset):
                continue
            nk = min(block_k, tk - k0)
            _, kb, _, _, ds = _probs_and_ds(
                q, k, v, do, lse, delta, q0, k0, nq, nk, tq, tk, scale,
                causal, offset, bias_r, segq_r, segk_r)
            acc = acc + ds @ kb
        dq[:, q0:q0 + nq] = (acc * scale).to(q.dtype)
    return dq


def flash_bwd_dkv_plain(q, k, v, bias, seg_q, seg_k, do, lse, delta, h,
                        scale, causal, offset=0, want_db=True,
                        block_q=DEFAULT_BLOCKS[0],
                        block_k=DEFAULT_BLOCKS[1]):
    """Plain version of the dK/dV kernel. Returns (dK, dV, dbias) with
    dbias (BH, Tk) fp32 per packed head, or None without a bias or when
    ``want_db`` is False."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    bias_r = _per_row(bias, h)
    segq_r, segk_r = _per_row(seg_q, h), _per_row(seg_k, h)
    track_db = bias is not None and want_db
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    db = (torch.empty((bh, tk), dtype=torch.float32, device=q.device)
          if track_db else None)
    for k0 in range(0, tk, block_k):
        nk = min(block_k, tk - k0)
        dk_acc = torch.zeros((bh, nk, d), device=q.device)
        dv_acc = torch.zeros((bh, nk, d), device=q.device)
        db_acc = torch.zeros((bh, nk), device=q.device)
        for q0 in range(0, tq, block_q):
            if not _visible_block(causal, q0, block_q, k0, offset):
                continue
            nq = min(block_q, tq - q0)
            qb, _, dob, p, ds = _probs_and_ds(
                q, k, v, do, lse, delta, q0, k0, nq, nk, tq, tk, scale,
                causal, offset, bias_r, segq_r, segk_r)
            dv_acc = dv_acc + p.transpose(1, 2) @ dob
            # dk = dS^T (q * scale); qb already carries the scale.
            dk_acc = dk_acc + ds.transpose(1, 2) @ qb
            if track_db:
                db_acc = db_acc + ds.sum(dim=1)
        dk[:, k0:k0 + nk] = dk_acc.to(k.dtype)
        dv[:, k0:k0 + nk] = dv_acc.to(v.dtype)
        if track_db:
            db[:, k0:k0 + nk] = db_acc
    return dk, dv, db


# ---------------------------------------------------------------------------
# Kernel wrappers: CPU tensors -> plain version, CUDA tensors -> kernel
# ---------------------------------------------------------------------------

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _on_cuda(q, *others) -> bool:
    """Route by q's device; every other tensor must lie on the same one."""
    for t in others:
        if t is not None and t.device != q.device:
            raise ValueError(f"flash attention inputs on mixed devices: "
                             f"{q.device} and {t.device}")
    return q.is_cuda


def _check_segs(q, k, seg_q, seg_k) -> None:
    """Both segment-id tensors or neither, (B, Tq) and (B, Tk)."""
    if (seg_q is None) != (seg_k is None):
        raise ValueError("seg_q and seg_k are given together or not at all")
    if seg_q is None:
        return
    b = seg_q.shape[0]
    if (tuple(seg_q.shape) != (b, q.shape[1])
            or tuple(seg_k.shape) != (b, k.shape[1])):
        raise ValueError(f"seg_q must be (B, Tq) and seg_k (B, Tk), got "
                         f"{tuple(seg_q.shape)} and {tuple(seg_k.shape)}")


def _check_kernel_inputs(q, k, v, bias, seg_q, seg_k, *extra):
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash kernels take float32 or bfloat16, got "
                        f"{q.dtype}")
    for t in (k, v) + extra[:1]:
        if t.dtype != q.dtype:
            raise TypeError(f"q is {q.dtype} but another input is {t.dtype}")
    for t in extra[1:]:
        if t.dtype != torch.float32:
            raise TypeError(f"lse and delta must be float32, got {t.dtype}")
    d = q.shape[-1]
    if d % 8 or d > 128:
        raise ValueError(f"flash kernels take head dims that are multiples "
                         f"of 8 up to 128, got {d}")
    for t in (q, k, v, bias, seg_q, seg_k) + extra:
        if t is not None and not t.is_contiguous():
            raise ValueError("flash kernels need contiguous inputs")
    if q.dtype == torch.bfloat16:
        # The tensor-core kernels copy q/k/v/dO rows in 16-byte chunks.
        for t in (q, k, v) + extra[:1]:
            if t.data_ptr() % 16:
                raise ValueError("bf16 flash kernels need 16-byte aligned "
                                 "q, k, v and dO")
    if bias is not None and bias.dtype != torch.float32:
        raise TypeError("key_bias must be float32 at the kernel")
    for t in (seg_q, seg_k):
        if t is not None and t.dtype != torch.int32:
            raise TypeError("segment ids must be int32 at the kernel")


def _plain_blocks(block_q, block_k) -> Tuple[int, int]:
    return (DEFAULT_BLOCKS[0] if block_q is None else int(block_q),
            DEFAULT_BLOCKS[1] if block_k is None else int(block_k))


def _refuse_blocks(*blocks) -> None:
    if any(b is not None for b in blocks):
        raise ValueError(
            "block_q/block_k (and _bwd) tile only the plain versions of CPU "
            "tensors; the CUDA kernels' tiles are compiled in")


def _raise_on_error(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def launch_fwd(lib, q, k, v, bias, seg_q, seg_k, o, lse, h, scale, causal,
               offset, stream) -> None:
    """Call ``hvd_flash_fwd`` of ``lib`` on already-checked tensors."""
    bh, tq, d = q.shape
    rc = lib.hvd_flash_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(seg_q), _ptr(seg_k),
        _ptr(o), _ptr(lse), bh, tq, k.shape[1], d, h, float(scale),
        int(causal), int(offset), _KERNEL_DTYPES[q.dtype], stream)
    _raise_on_error(rc, "flash_fwd")


def launch_bwd_dq(lib, q, k, v, bias, seg_q, seg_k, do, lse, delta, dq, h,
                  scale, causal, offset, stream) -> None:
    bh, tq, d = q.shape
    rc = lib.hvd_flash_bwd_dq(
        _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(seg_q), _ptr(seg_k),
        _ptr(do), _ptr(lse), _ptr(delta), _ptr(dq), bh, tq, k.shape[1], d, h,
        float(scale), int(causal), int(offset), _KERNEL_DTYPES[q.dtype],
        stream)
    _raise_on_error(rc, "flash_bwd_dq")


def launch_bwd_dkv(lib, q, k, v, bias, seg_q, seg_k, do, lse, delta, dk, dv,
                   db, h, scale, causal, offset, stream) -> None:
    bh, tq, d = q.shape
    rc = lib.hvd_flash_bwd_dkv(
        _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(seg_q), _ptr(seg_k),
        _ptr(do), _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv), _ptr(db), bh,
        tq, k.shape[1], d, h, float(scale), int(causal), int(offset),
        _KERNEL_DTYPES[q.dtype], stream)
    _raise_on_error(rc, "flash_bwd_dkv")


def _launch(device: torch.device, launch, lib_name: str, *args) -> None:
    """``launch(lib, *args, stream)`` on ``device`` and its current stream."""
    from horovod_tpu_torch.ops import _build
    with torch.cuda.device(device):
        launch(_build.load(lib_name), *args,
               torch.cuda.current_stream(device).cuda_stream)


def flash_fwd(q, k, v, bias, seg_q, seg_k, h, scale, causal, offset=0,
              block_q=None, block_k=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward on packed (BH, T, d) inputs -> (O, lse (BH, Tq) fp32)."""
    _check_segs(q, k, seg_q, seg_k)
    if not _on_cuda(q, k, v, bias, seg_q, seg_k):
        return flash_fwd_plain(q, k, v, bias, seg_q, seg_k, h, scale, causal,
                               offset, *_plain_blocks(block_q, block_k))
    _refuse_blocks(block_q, block_k)
    _check_kernel_inputs(q, k, v, bias, seg_q, seg_k)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch(q.device, launch_fwd, "flash_fwd", q, k, v, bias, seg_q, seg_k, o,
            lse, h, scale, causal, offset)
    launches["flash_fwd"] += 1
    if flop_tally is not None:
        _tally("flash_fwd", q, k, bias, seg_q, seg_k, h, causal, offset)
    return o, lse


def flash_bwd_dq(q, k, v, bias, seg_q, seg_k, do, lse, delta, h, scale,
                 causal, offset=0, block_q=None, block_k=None) -> torch.Tensor:
    """dQ on packed inputs; ``lse``/``delta`` (BH, Tq) fp32."""
    _check_segs(q, k, seg_q, seg_k)
    if not _on_cuda(q, k, v, bias, seg_q, seg_k, do, lse, delta):
        return flash_bwd_dq_plain(q, k, v, bias, seg_q, seg_k, do, lse, delta,
                                  h, scale, causal, offset,
                                  *_plain_blocks(block_q, block_k))
    _refuse_blocks(block_q, block_k)
    _check_kernel_inputs(q, k, v, bias, seg_q, seg_k, do, lse, delta)
    dq = torch.empty_like(q)
    _launch(q.device, launch_bwd_dq, "flash_bwd", q, k, v, bias, seg_q, seg_k,
            do, lse, delta, dq, h, scale, causal, offset)
    launches["flash_bwd_dq"] += 1
    if flop_tally is not None:
        _tally("flash_bwd_dq", q, k, bias, seg_q, seg_k, h, causal, offset)
    return dq


def flash_bwd_dkv(q, k, v, bias, seg_q, seg_k, do, lse, delta, h, scale,
                  causal, offset=0, want_db=True, block_q=None, block_k=None):
    """(dK, dV, dbias (BH, Tk) fp32 or None) on packed inputs."""
    _check_segs(q, k, seg_q, seg_k)
    if not _on_cuda(q, k, v, bias, seg_q, seg_k, do, lse, delta):
        return flash_bwd_dkv_plain(q, k, v, bias, seg_q, seg_k, do, lse,
                                   delta, h, scale, causal, offset, want_db,
                                   *_plain_blocks(block_q, block_k))
    _refuse_blocks(block_q, block_k)
    _check_kernel_inputs(q, k, v, bias, seg_q, seg_k, do, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    db = (torch.empty(k.shape[:2], dtype=torch.float32, device=k.device)
          if bias is not None and want_db else None)
    _launch(q.device, launch_bwd_dkv, "flash_bwd", q, k, v, bias, seg_q,
            seg_k, do, lse, delta, dk, dv, db, h, scale, causal, offset)
    launches["flash_bwd_dkv"] += 1
    if flop_tally is not None:
        _tally("flash_bwd_dkv", q, k, bias, seg_q, seg_k, h, causal, offset)
    return dk, dv, db


# ---------------------------------------------------------------------------
# Autograd and the public function
# ---------------------------------------------------------------------------

def _pack(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, D) -> (B*H, T, D), contiguous: each row owns one head's
    sequence. (With B 1 the reshape alone is a strided view.)"""
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()


def _unpack(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """(B*H, T, D) -> (B, T, H, D)."""
    return x.reshape(b, h, x.shape[1], x.shape[2]).permute(0, 2, 1, 3)


class _FlashFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, bias, seg_q, seg_k, h, scale, causal, offset,
                blocks, blocks_bwd):
        o, lse = flash_fwd(q, k, v, bias, seg_q, seg_k, h, scale, causal,
                           offset, *blocks)
        ctx.save_for_backward(q, k, v, bias, seg_q, seg_k, o, lse)
        ctx.cfg = (h, scale, causal, offset, blocks_bwd)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, seg_q, seg_k, o, lse = ctx.saved_tensors
        h, scale, causal, offset, blocks_bwd = ctx.cfg
        do = do.contiguous()
        # delta_i = sum_d dO_i . O_i, the softmax-normalisation term of dS.
        delta = (do.float() * o.float()).sum(dim=-1)
        want_db = bias is not None and ctx.needs_input_grad[3]
        dq = flash_bwd_dq(q, k, v, bias, seg_q, seg_k, do, lse, delta, h,
                          scale, causal, offset, *blocks_bwd)
        dk, dv, db = flash_bwd_dkv(q, k, v, bias, seg_q, seg_k, do, lse,
                                   delta, h, scale, causal, offset, want_db,
                                   *blocks_bwd)
        dbias = None
        if db is not None:
            # per-(batch*head) bias gradient; the heads share one bias.
            dbias = db.view(-1, h, db.shape[1]).sum(dim=1)
        return (dq, dk, dv, dbias) + (None,) * 8


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    key_bias: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    block_q_bwd: Optional[int] = None,
                    block_k_bwd: Optional[int] = None,
                    causal_offset: int = 0) -> torch.Tensor:
    """Fused attention ``softmax(q k^T * scale + key_bias [+ mask]) v``.

    Args:
      q: (batch, t_q, heads, head_dim).
      k, v: (batch, t_kv, heads, head_dim).
      causal: q position i attends to k positions <= i + causal_offset;
        requires t_q == t_kv.
      scale: logit scale; defaults to ``head_dim ** -0.5``.
      key_bias: optional (batch, t_kv) additive logit bias, broadcast over
        heads and queries (key padding is ``where(pad, -1e30, 0)``).
        Differentiated: the dK/dV kernel accumulates ``sum_q dS``.
      segment_ids: optional (batch, t) int sequence-packing ids
        (t_q == t_kv required); q and k see each other only within one id.
      causal_offset: shifts the causal diagonal (-1 = strict causal).
      block_q, block_k, block_q_bwd, block_k_bwd: tiles of the plain
        versions, for CPU tensors only (default :data:`DEFAULT_BLOCKS`; the
        backward ones default to the forward ones). The CUDA kernels' tiles
        are compiled in, so naming one for CUDA tensors raises.

    Returns (batch, t_q, heads, head_dim), same dtype as ``q``.
    """
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if causal and tq != tk:
        raise ValueError(f"causal flash attention needs t_q == t_kv, "
                         f"got {tq} != {tk}")
    scale = d ** -0.5 if scale is None else scale
    block_q_bwd = block_q if block_q_bwd is None else block_q_bwd
    block_k_bwd = block_k if block_k_bwd is None else block_k_bwd
    blocks = (block_q, block_k, block_q_bwd, block_k_bwd)
    if q.is_cuda:
        _refuse_blocks(*blocks)
    if any(b is not None and int(b) < 1 for b in blocks):
        raise ValueError("flash attention block sizes must be >= 1")

    if key_bias is not None:
        if tuple(key_bias.shape) != (b, tk):
            raise ValueError(f"key_bias must be (batch, t_kv) = ({b}, {tk}), "
                             f"got {tuple(key_bias.shape)}")
        key_bias = key_bias.float().contiguous()
    seg = None
    if segment_ids is not None:
        if tq != tk:
            raise ValueError("segment_ids require self-attention shapes "
                             f"(t_q == t_kv), got {tq} != {tk}")
        if tuple(segment_ids.shape) != (b, tq):
            raise ValueError(f"segment_ids must be (batch, t) = "
                             f"({b}, {tq}), got {tuple(segment_ids.shape)}")
        seg = segment_ids.to(torch.int32).contiguous()

    o = _FlashFn.apply(_pack(q), _pack(k), _pack(v), key_bias, seg, seg, h,
                       float(scale), bool(causal), int(causal_offset),
                       blocks[:2], blocks[2:])
    return _unpack(o, b, h)
