"""Mixture-of-experts MLP: Switch top-1 and GShard/Mixtral top-2 routing.

Port of ``horovod_tpu/ops/moe.py`` with the reference's function:

* the router's logits and softmax are fp32 (``router`` is (d, E) fp32);
* capacity is ``int(cf * n / E)`` slots an expert for top-1 and
  ``int(cf * 2n / E)`` for top-2 (at least 1); a token's slot is its place
  in its expert's queue in token order (the first-max ``argmax`` picks the
  expert), top-2 choices queue after every top-1 choice, and a token past
  capacity is dropped: its combine weight is 0, so it comes back as zeros;
* dispatch and combine are the one-hot (N, E, C) tensors; the gates are
  cast to the compute dtype before the combine product;
* experts are ``gelu`` (``w_in`` (E, d, F), ``b_in`` (E, F), ``w_out``
  (E, F, d), ``b_out`` (E, d); tanh GELU) or ``swiglu`` (bias-free ``w_gate``
  and ``w_in`` (E, d, F), ``w_out`` (E, F, d)), computing in ``dtype``.

The dispatch and combine products contract over tokens with no batch
dimension, as the reference's einsums do, and are written as 2-D matrix
products (``aten.mm``), so that the ``"dots"`` remat policy saves them as
``dots_with_no_batch_dims_saveable`` does; the experts' products carry the
expert dimension as a batch (``aten.bmm``) and are recomputed.

Expert parallelism over the reference's ``ep`` mesh axis
(:class:`ExpertParallel`, hung on a layer as ``ep`` by
``mp.tensor_parallel(model, ep=...)``): a rank keeps the experts
``[e*E/ep, (e+1)*E/ep)`` of its place e on the ep line, and the router
stays whole. Tokens are replicated over ep (the reference's dryrun lays
them out ``P("dp")``), so every rank routes the same tokens to the same
slots. Then f over ep at the experts' input (identity forward, sum
backward: each rank's dispatch reaches only its own experts), the dispatch
product against this rank's (N, E/ep, C) slice of the dispatch tensor,
its experts, and one all-gather of the (E/ep, C, d) outputs, whose
backward keeps this rank's slice (every rank holds the same cotangent);
the combine product is whole. Every slot holds at most one token, so the
dispatch product is exact; the experts' batched products are each
expert's own, and the forward came out the dense layer's bit for bit on
the CPU and on the H100 (``chip_smoke.py`` phase 14 (c)). Without ``ep``
every rank holds every expert.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["switch_load_balance_loss", "Top1Router", "Top2Router",
           "MoEMLP", "ExpertParallel", "ROUTERS", "ACTIVATIONS"]

ROUTERS = ("top1", "top2")
ACTIVATIONS = ("gelu", "swiglu")


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot over ``n`` classes; an index outside [0, n) gives a row
    of zeros (``jax.nn.one_hot``'s rule, where ``F.one_hot`` raises)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def switch_load_balance_loss(router_probs: torch.Tensor,
                             expert_index: torch.Tensor) -> torch.Tensor:
    """Switch Transformer aux loss ``E * sum_e f_e * P_e`` of (N, E) fp32
    router probabilities and (N,) chosen experts; 1 at uniform routing."""
    e = router_probs.shape[-1]
    f = _one_hot(expert_index, e).mean(dim=0)
    p = router_probs.mean(dim=0)
    return e * (f * p).sum()


def _positions(onehot: torch.Tensor, offset=0.0) -> torch.Tensor:
    """Each token's 0-based place in its expert's queue (plus ``offset``),
    kept only in the chosen expert's column. The counts run along the
    rows of the (E, N) transpose: on the card a scan down N rows of only E
    columns was the MoE step's costliest kernel (``PERF.md`` §6)."""
    counts = torch.cumsum(onehot.t().contiguous(), dim=1).t()
    return (counts - 1.0 + offset) * onehot


def _slots(onehot: torch.Tensor, pos: torch.Tensor, c: int) -> torch.Tensor:
    """(N, E, C) one-hot dispatch of kept tokens to their slots."""
    slot = _one_hot(pos.sum(dim=-1).long(), c)
    return onehot[..., None] * slot[:, None, :]


class _Router(nn.Module):
    """The router's parameter: ``router`` (d, E) fp32, normal(0.02)."""

    def __init__(self, d: int, num_experts: int, capacity_factor: float):
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.router = nn.Parameter(torch.empty(d, num_experts))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.router.normal_(0.0, 0.02, generator=generator)

    def _probs(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(x.float() @ self.router, dim=-1)


class Top1Router(_Router):
    """Switch-style top-1 router with static capacity: ``forward(x (N, d))``
    -> (dispatch (N, E, C), combine (N, E, C), aux loss)."""

    def capacity(self, n: int) -> int:
        return max(1, int(self.capacity_factor * n / self.num_experts))

    def forward(self, x: torch.Tensor):
        e, c = self.num_experts, self.capacity(x.shape[0])
        probs = self._probs(x)
        idx = torch.argmax(probs, dim=-1)
        gate = probs.gather(-1, idx[:, None])[:, 0]
        onehot = _one_hot(idx, e)
        pos = _positions(onehot)
        onehot = onehot * (pos < c)
        dispatch = _slots(onehot, pos, c)
        combine = gate[:, None, None] * dispatch
        return dispatch, combine, switch_load_balance_loss(probs, idx)


class Top2Router(_Router):
    """GShard-style top-2 router: gates renormalised over the pair, top-1
    choices take their slots first and top-2 choices fill what is left
    (so second choices are the ones dropped). Same contract as
    :class:`Top1Router`."""

    def capacity(self, n: int) -> int:
        return max(1, int(self.capacity_factor * 2 * n / self.num_experts))

    def forward(self, x: torch.Tensor):
        e, c = self.num_experts, self.capacity(x.shape[0])
        probs = self._probs(x)
        idx1 = torch.argmax(probs, dim=-1)
        gate1 = probs.gather(-1, idx1[:, None])[:, 0]
        probs2 = probs * (1.0 - _one_hot(idx1, e))
        idx2 = torch.argmax(probs2, dim=-1)
        gate2 = probs2.gather(-1, idx2[:, None])[:, 0]
        denom = (gate1 + gate2).clamp_min(1e-9)
        gate1, gate2 = gate1 / denom, gate2 / denom
        one1, one2 = _one_hot(idx1, e), _one_hot(idx2, e)
        pos1 = _positions(one1)
        pos2 = _positions(one2, one1.sum(dim=0)[None])
        one1, one2 = one1 * (pos1 < c), one2 * (pos2 < c)
        d1, d2 = _slots(one1, pos1, c), _slots(one2, pos2, c)
        dispatch = d1 + d2
        combine = gate1[:, None, None] * d1 + gate2[:, None, None] * d2
        return dispatch, combine, switch_load_balance_loss(probs, idx1)


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``lecun_normal`` of an (E, in, out) kernel: truncated normal of
    variance 1 / fan_in, where flax counts fan_in as in x E."""
    fan_in = w.shape[0] * w.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class _GatherExperts(torch.autograd.Function):
    """(E/ep, C, d) -> (E, C, d) over the ep line, in rank order; the
    backward keeps this rank's slice of the cotangent."""

    @staticmethod
    def forward(ctx, x, ep):
        ctx.ep = ep
        return ep.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        el = g.shape[0] // ctx.ep.size
        return g[ctx.ep.rank * el:(ctx.ep.rank + 1) * el], None


class ExpertParallel:
    """This rank's place on an ep line (``process_set``): f over it, and
    the gather of the experts' outputs (see the module docstring)."""

    def __init__(self, process_set):
        from horovod_tpu_torch.parallel.conjugate import \
            identity_fwd_psum_bwd
        self.process_set = process_set
        self.size, self.rank = process_set.size(), process_set.rank()
        self.f = identity_fwd_psum_bwd(process_set)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's (E/ep, ...) ``x`` stacked in rank order, no
        gradient (the exchange; :meth:`gather` differentiates it)."""
        from horovod_tpu_torch import collective as C
        flat = C._in_step_allgather(x.contiguous().reshape(-1),
                                    self.process_set, name="ep/experts")
        return flat.reshape((-1,) + tuple(x.shape[1:]))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherExperts.apply(x, self)

    def __repr__(self) -> str:
        return f"ExpertParallel(rank {self.rank} of {self.process_set})"


class MoEMLP(nn.Module):
    """Drop-in for a transformer's dense MLP: ``forward(x (B, T, d))`` ->
    (out (B, T, d) in ``dtype``, fp32 aux loss). Under expert parallelism
    (``ep``, an :class:`ExpertParallel`) its expert weights hold this
    rank's E/ep experts."""

    ep = None

    def __init__(self, d: int, num_experts: int, d_ff: int,
                 capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16,
                 router_type: str = "top1", activation: str = "gelu"):
        super().__init__()
        if router_type not in ROUTERS:
            raise ValueError(f"unknown router_type {router_type!r}; "
                             "expected 'top1' or 'top2'")
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; "
                             "expected 'gelu' or 'swiglu'")
        e, f = num_experts, d_ff
        self.dtype, self.activation = dtype, activation
        self.router = (Top1Router if router_type == "top1" else Top2Router)(
            d, e, capacity_factor)
        self.w_in = nn.Parameter(torch.empty(e, d, f))
        self.w_out = nn.Parameter(torch.empty(e, f, d))
        if activation == "swiglu":
            self.w_gate = nn.Parameter(torch.empty(e, d, f))
        else:
            self.b_in = nn.Parameter(torch.zeros(e, f))
            self.b_out = nn.Parameter(torch.zeros(e, d))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.router.reset_parameters(generator)
        with torch.no_grad():
            for name in ("w_in", "w_out", "w_gate"):
                if hasattr(self, name):
                    _lecun_normal_(getattr(self, name), generator)
            if self.activation == "gelu":
                self.b_in.zero_()
                self.b_out.zero_()

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t, d = x.shape
        dt = self.dtype
        tokens = x.reshape(b * t, d)
        dispatch, combine, aux = self.router(tokens)
        n, e, c = dispatch.shape
        el, x_in, local = self.w_in.shape[0], tokens, dispatch
        if self.ep is not None:
            # This rank's experts: their slice of the dispatch tensor, and
            # f, so that the tokens' gradient sums every rank's experts.
            lo = self.ep.rank * el
            x_in, local = self.ep.f(tokens), dispatch[:, lo:lo + el]
        # (N, E·C)ᵀ (N, d) -> (E, C, d): the reference's "nec,nd->ecd".
        expert_in = (local.to(dt).reshape(n, el * c).t()
                     @ x_in.to(dt)).reshape(el, c, d)
        if self.activation == "swiglu":
            g = torch.bmm(expert_in, self.w_gate.to(dt))
            u = torch.bmm(expert_in, self.w_in.to(dt))
            expert_out = torch.bmm(F.silu(g) * u, self.w_out.to(dt))
        else:
            h = torch.bmm(expert_in, self.w_in.to(dt)) \
                + self.b_in[:, None].to(dt)
            h = F.gelu(h, approximate="tanh")
            expert_out = torch.bmm(h, self.w_out.to(dt)) \
                + self.b_out[:, None].to(dt)
        if self.ep is not None:
            expert_out = self.ep.gather(expert_out)
        # (N, E·C) (E·C, d) -> (N, d): "nec,ecd->nd"; dropped tokens get 0.
        out = combine.to(dt).reshape(n, e * c) @ expert_out.reshape(e * c, d)
        return out.reshape(b, t, d), aux

    def macs(self, n: int) -> int:
        """Multiply-adds of one forward over ``n`` tokens: the router, the
        dispatch and combine products and the experts (this rank's under
        ``ep``)."""
        el, d, f = self.w_in.shape
        e, c = self.router.num_experts, self.router.capacity(n)
        mats = 3 if self.activation == "swiglu" else 2
        return n * d * e + n * (el + e) * c * d + mats * el * c * d * f

