"""Ring attention: exact attention over sequences sharded across ranks.

Port of ``horovod_tpu/ops/ring_attention.py``. Each rank of a process set
holds a sequence shard of q/k/v; the k/v blocks rotate around the ring, one
hop to rank ``(r + 1) % n`` a step, while an online softmax accumulates the
partial results in fp32. The reference rotates with ``lax.ppermute`` inside
``shard_map`` and differentiates through it; here a hop is one
``dist.batch_isend_irecv`` over the set's group (a send to the next rank and
a receive from the previous one, grouped, so NCCL does not deadlock at
n = 2 where both peers are the same rank), and :class:`_RingShift` carries
the cotangent one hop back in the backward (``torch.distributed.nn`` has no
differentiable send or receive).

The ring runs over ``process_set`` (default: the global set; a
:class:`Ring` is taken as it is), which takes the place of the reference's
``axis_name``. This module also holds the
transport that ``ops/ring_flash.py`` posts around its kernels.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["ring_attention"]

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Transport: one hop around the ring of a process set
# ---------------------------------------------------------------------------

class Ring:
    """A process set seen as a ring: this rank's place ``rank`` of ``n``,
    and the global ranks of its next and previous members."""

    def __init__(self, process_set=None):
        from horovod_tpu_torch import collective
        from horovod_tpu_torch.process_set import global_process_set
        ps = global_process_set() if process_set is None else process_set
        if not ps.included():
            raise ValueError(f"this rank is not a member of {ps}")
        ranks = collective._set_ranks(ps)
        self.ps, self.group = ps, ps.group
        self.n, self.rank = len(ranks), ps.rank()
        self.next = ranks[(self.rank + 1) % self.n]
        self.prev = ranks[(self.rank - 1) % self.n]
        self._collective = collective

    @classmethod
    def of(cls, process_set=None) -> "Ring":
        """``process_set`` when it is a ring already, else the ring of
        that set (default: the global set)."""
        return process_set if isinstance(process_set, cls) \
            else cls(process_set)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the set, differentiable (its backward sums
        the cotangents over the set), as ``lax.psum`` under ``shard_map``."""
        if self.n == 1:
            return x
        from torch.distributed.nn.functional import all_reduce
        return all_reduce(x, group=self.group)

    def post(self, send: Sequence[torch.Tensor], forward: bool = True,
             into: Optional[Sequence[torch.Tensor]] = None) -> tuple:
        """Start one hop of ``send`` (to the next rank when ``forward``,
        else to the previous one), received into ``into`` (default: new
        buffers); returns what :meth:`wait` takes. With one member the hop
        is the identity and nothing is sent."""
        if self.n == 1 or not send:
            return list(send), [], ()
        to, frm = (self.next, self.prev) if forward else (self.prev,
                                                           self.next)
        send = [t.contiguous() for t in send]
        recv = (list(into) if into is not None
                else [torch.empty_like(t) for t in send])
        self._collective._ensure_p2p(self.ps, send[0])
        ops = ([dist.P2POp(dist.isend, t, to, self.group) for t in send]
               + [dist.P2POp(dist.irecv, t, frm, self.group) for t in recv])
        # The sent tensors stay referenced until the wait.
        return recv, dist.batch_isend_irecv(ops), send

    @staticmethod
    def wait(posted) -> List[torch.Tensor]:
        """The received buffers of :meth:`post`, once its works are done
        (on NCCL the current stream waits, the host does not)."""
        recv, works, _ = posted
        for w in works:
            w.wait()
        return recv

    def shift(self, send: Sequence[torch.Tensor], forward: bool = True
              ) -> List[torch.Tensor]:
        return self.wait(self.post(send, forward))


class _RingShift(torch.autograd.Function):
    """One hop forward of the floating tensors ``xs``; the backward sends
    their cotangents one hop back."""

    @staticmethod
    def forward(ctx, ring, *xs):
        ctx.ring = ring
        return tuple(ring.shift(xs))

    @staticmethod
    def backward(ctx, *gs):
        # Autograd hands zeros, not None, for an output that got no grad.
        return (None,) + tuple(ctx.ring.shift(gs, forward=False))


def _positions(layout: str, src, n: int, t: int, device) -> torch.Tensor:
    """Global positions of shard ``src``'s rows."""
    ar = torch.arange(t, device=device)
    return src + n * ar if layout == "striped" else src * t + ar


def check_layout(layout: str) -> None:
    if layout not in ("contiguous", "striped"):
        raise ValueError(f"unknown layout {layout!r}; expected "
                         "'contiguous' or 'striped'")


def check_shard_input(name: str, x, b: int, t: int) -> None:
    if x is not None and tuple(x.shape) != (b, t):
        raise ValueError(f"{name} must be (batch, t_local) = ({b}, {t}), "
                         f"got {tuple(x.shape)}")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   process_set=None, causal: bool = True,
                   scale: Optional[float] = None,
                   layout: str = "contiguous",
                   key_mask: Optional[torch.Tensor] = None,
                   segment_ids: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Exact attention with q/k/v sharded on sequence across the ranks of
    ``process_set`` (default: the global set).

    Args:
      q, k, v: (batch, t_local, heads, head_dim), this rank's shard.
      causal: the global causal mask (correct across shards).
      scale: logit scale; defaults to head_dim ** -0.5.
      layout: ``"contiguous"`` (rank r holds ``[r*t_local, (r+1)*t_local)``)
        or ``"striped"`` (rank r holds ``r, r+n, r+2n, ...``).
      key_mask: optional (batch, t_local) bool; False keys are masked. It
        rotates with its k/v block; fully masked query rows return zeros.
      segment_ids: optional (batch, t_local) int packing ids; the key-side
        copy rotates with its block and each hop masks home queries against
        the resident keys.

    Returns (batch, t_local, heads, head_dim) in q's dtype.
    """
    check_layout(layout)
    ring = Ring.of(process_set)
    n, rank = ring.n, ring.rank
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    check_shard_input("key_mask", key_mask, b, tk)
    check_shard_input("segment_ids", segment_ids, b, tk)

    qf = (q * scale).float()
    q_pos = _positions(layout, rank, n, tq, q.device)
    o = q.new_zeros((b, tq, h, d), dtype=torch.float32)
    m = torch.full((b, h, tq), _NEG_INF, device=q.device)
    l = torch.zeros((b, h, tq), device=q.device)
    # The key mask travels as int32 (gloo sends no bool).
    km = None if key_mask is None else key_mask.to(torch.int32)
    seg_k = segment_ids
    for i in range(n):
        src = (rank - i) % n
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
        if causal:
            k_pos = _positions(layout, src, n, tk, q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(mask[None, None], logits, _NEG_INF)
        if km is not None:
            logits = torch.where(km.bool()[:, None, None, :], logits,
                                 _NEG_INF)
        if seg_k is not None:
            from horovod_tpu_torch.ops.attention import segment_mask
            logits = torch.where(segment_mask(segment_ids, seg_k)[:, None],
                                 logits, _NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # A fully masked block keeps m at -1e30: p is 1 there until a
        # visible block's correction (exp(-1e30 - m)) wipes it.
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p, v.float())
        m = m_new
        if i < n - 1:
            k, v = _RingShift.apply(ring, k, v)
            rest = ring.shift([x for x in (km, seg_k) if x is not None])
            if km is not None:
                km = rest.pop(0)
            if seg_k is not None:
                seg_k = rest.pop(0)
    out = o / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    if key_mask is not None:
        # A row that never saw a visible key keeps m at exactly -1e30:
        # zeros, as multihead_attention gives.
        visible = (m > _NEG_INF / 2).transpose(1, 2)[..., None]
        out = torch.where(visible, out, torch.zeros((), device=q.device))
    return out.to(q.dtype)
