"""Adasum: adaptive summation of gradients across ranks.

Port of ``horovod_tpu/adasum.py`` (itself a rebuild of upstream
``horovod/common/ops/adasum/adasum.h``) onto ``torch.distributed``
point-to-point ops (``batch_isend_irecv``, which NCCL and gloo both give).
Adasum combines two gradients so that the result is no larger than either
projection allows:

    adasum(a, b) = (1 - a.b / (2 |a|^2)) a  +  (1 - a.b / (2 |b|^2)) b

with the zero-norm guards of upstream (a side whose norm is 0 keeps
coefficient 1, so a zero vector adds plainly). The arithmetic is fp32
whatever the input dtype, and the result is cast back to it.

:func:`adasum_allreduce` keeps the reference's four phases and their data
movement. With ``k`` ranks in the set, ``p`` the largest power of two
``<= k`` and ``r = k - p``:

1. **Pre-pairing**: set rank ``p + i`` sends its vector to set rank ``i``
   (``i < r``), which absorbs it with one combine; the senders go passive.
2. **VHDD** among the ``p`` active ranks, ``log2 p`` rounds. In round ``t``
   the partners at XOR distance ``d = 2^t`` swap the half of their live
   piece that the other keeps (so the bytes sent sum to about ``|x|``, not
   ``|x| log p``). Each computes the partial dot and squared norms of its
   half, and the three scalars are summed by butterfly over the whole
   ``2d``-rank group the round combines, not over the pair alone: the two
   vectors being combined are spread over those ``2d`` ranks. The rank
   whose ``d`` bit is set keeps the high half and swaps the coefficients'
   roles.
3. **Reconstruction**: after the rounds, active set rank ``j`` holds the
   piece at offset ``bitreverse(j) * Lp / p`` of the result. The pieces are
   all-gathered among the active ranks in that bit-reversed order, by
   recursive doubling: the reverse rounds swap pieces with the same
   partners and join them low half first.
4. **Post-broadcast**: set rank ``i`` sends the result to passive rank
   ``p + i``.

The vector is padded with zeros to ``Lp``, a multiple of ``p``, so every
halving is even. A set of one rank returns its input unchanged, and a rank
outside the set gets its input back. :func:`hierarchical_adasum_allreduce`
averages within each node first (``HOROVOD_HIERARCHICAL_ALLREDUCE``).

Everything runs on the caller's thread. Under NCCL the ops and the
arithmetic between them are queued on the device with no host
synchronisation (the coefficients stay device tensors); under gloo each
exchange blocks until it has completed.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["adasum_combine", "dot_and_norms", "coefficients", "scaled_add",
           "adasum_allreduce", "hierarchical_adasum_allreduce"]


# ------------------------------------------------------------ arithmetic

def dot_and_norms(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(3,) fp32 tensor ``[a.b, a.a, b.b]`` of two same-sized fp32 vectors
    (upstream's ``ComputeDotAndNormSqrds``)."""
    a, b = a.reshape(-1), b.reshape(-1)
    return torch.stack([torch.dot(a, b), torch.dot(a, a), torch.dot(b, b)])


def coefficients(dot: torch.Tensor, asq: torch.Tensor, bsq: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adasum's coefficients of ``a`` and ``b`` from ``a.b``, ``|a|^2`` and
    ``|b|^2``; a zero norm gives that side coefficient 1."""
    one = torch.ones_like(dot)
    ca = torch.where(asq > 0, 1.0 - dot / (2.0 * torch.where(asq > 0, asq,
                                                              one)), one)
    cb = torch.where(bsq > 0, 1.0 - dot / (2.0 * torch.where(bsq > 0, bsq,
                                                              one)), one)
    return ca, cb


def scaled_add(ca: torch.Tensor, a: torch.Tensor, cb: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """``ca * a + cb * b`` (upstream's ``ScaledAdd``)."""
    return ca * a + cb * b


def adasum_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Adasum of two same-shaped tensors, computed in fp32 and returned in
    ``a``'s dtype."""
    af, bf = a.float(), b.float()
    dot, asq, bsq = dot_and_norms(af, bf).unbind()
    ca, cb = coefficients(dot, asq, bsq)
    return scaled_add(ca, af, cb, bf).to(a.dtype)


# --------------------------------------------------------- data movement

def _exchange(sends: Sequence[Tuple[torch.Tensor, int]],
              recvs: Sequence[Tuple[torch.Tensor, int]], group) -> None:
    """One batch of point-to-point ops with global peer ranks; waits for
    it (on NCCL: the current stream waits, the host does not)."""
    ops = ([dist.P2POp(dist.isend, t, peer, group) for t, peer in sends]
           + [dist.P2POp(dist.irecv, t, peer, group) for t, peer in recvs])
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def _swap(t: torch.Tensor, peer: int, group) -> torch.Tensor:
    """Send ``t`` to ``peer`` and receive its tensor of the same shape."""
    got = torch.empty_like(t)
    _exchange([(t, peer)], [(got, peer)], group)
    return got


def _recv(like: torch.Tensor, peer: int, group) -> torch.Tensor:
    """A tensor shaped like ``like``, received from ``peer``."""
    got = torch.empty_like(like)
    _exchange([], [(got, peer)], group)
    return got


def adasum_allreduce(x: torch.Tensor, ranks: Optional[Sequence[int]] = None,
                     group=None) -> torch.Tensor:
    """Adasum of every member's ``x`` (same shape on all of them).

    ``ranks`` are the members' global ranks in set order (None: every
    rank); ``group`` is a ``torch.distributed`` group that holds them
    (None: the default group), over which the point-to-point ops run.
    Returns a new tensor of ``x``'s shape and dtype; a rank outside
    ``ranks``, or the only member, gets ``x`` itself back.
    """
    members = (list(range(dist.get_world_size())) if ranks is None
               else [int(r) for r in ranks])
    me = dist.get_rank()
    k = len(members)
    if me not in members or k == 1:
        return x
    setrank = members.index(me)
    p = 1 << (k.bit_length() - 1)
    r = k - p
    rounds = p.bit_length() - 1

    flat = x.reshape(-1).float()
    n = flat.numel()
    lp = -(-n // p) * p
    if lp > n:
        flat = torch.cat([flat, flat.new_zeros(lp - n)])

    # Phase 1: pre-pairing of the r extra ranks.
    if setrank >= p:
        _exchange([(flat, members[setrank - p])], [], group)
    elif setrank < r:
        flat = adasum_combine(flat, _recv(flat, members[p + setrank],
                                          group))

    if setrank < p:
        # Phase 2: VHDD rounds; cur is this rank's live piece.
        cur = flat
        for t in range(rounds):
            d = 1 << t
            half = cur.numel() // 2
            high = bool(setrank & d)
            # Keep one half, send the partner the half it keeps.
            mine, give = (cur[half:], cur[:half]) if high \
                else (cur[:half], cur[half:])
            other = _swap(give, members[setrank ^ d], group)
            # Partials in the roles (L.R, L.L, R.R), L being the vector of
            # the rank whose d bit is unset, summed over the 2d ranks.
            q = dot_and_norms(mine, other)
            if high:
                q = q[[0, 2, 1]]
            for s in range(t + 1):
                q = q + _swap(q, members[setrank ^ (1 << s)], group)
            cl, cr = coefficients(q[0], q[1], q[2])
            ca, cb = (cr, cl) if high else (cl, cr)
            cur = scaled_add(ca, mine, cb, other)
        # Phase 3: the pieces gathered in bit-reversed order.
        for t in reversed(range(rounds)):
            d = 1 << t
            other = _swap(cur, members[setrank ^ d], group)
            cur = torch.cat([other, cur] if setrank & d else [cur, other])
        result = cur
        # Phase 4: post-broadcast to the passive partner.
        if setrank < r:
            _exchange([(result, members[p + setrank])], [], group)
    else:
        result = _recv(flat, members[setrank - p], group)
    return result[:n].reshape(x.shape).to(x.dtype)


def hierarchical_adasum_allreduce(x: torch.Tensor,
                                  groups: Sequence[Sequence[int]],
                                  group=None) -> torch.Tensor:
    """Hierarchical Adasum (upstream ``HOROVOD_HIERARCHICAL_ALLREDUCE`` with
    Adasum): the mean within each of ``groups`` (the set's ranks on one
    node, in set order) on the group's leader (its first rank), Adasum
    across the leaders, then each leader's result sent to its group.

    The mean is taken in fp32 and cast back to ``x``'s dtype. One group
    gives its mean (Adasum of one leader is the identity); groups of one
    rank give plain Adasum of the leaders. A rank in no group gets ``x``
    back. ``group`` is as for :func:`adasum_allreduce`.
    """
    groups = [[int(r) for r in g] for g in groups]
    me = dist.get_rank()
    mine = next((g for g in groups if me in g), None)
    if mine is None:
        return x
    leader, rest = mine[0], mine[1:]
    x = x.contiguous()
    if me != leader:
        _exchange([(x, leader)], [], group)
        return _recv(x, leader, group)
    local = x
    if rest:
        parts = [torch.empty_like(x) for _ in rest]
        _exchange([], list(zip(parts, rest)), group)
        acc = x.float()
        for part in parts:
            acc = acc + part.float()
        local = (acc / len(mine)).to(x.dtype)
    out = adasum_allreduce(local, [g[0] for g in groups], group)
    _exchange([(out, peer) for peer in rest], [], group)
    return out
