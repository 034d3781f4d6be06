"""GPT-2 as a PyTorch ``nn.Module``.

Port of ``horovod_tpu/models/gpt2.py`` with the reference's numerics:

* parameters are fp32; every dense layer computes in ``cfg.dtype`` (bf16 on
  the card), casting its input, weight and bias as flax ``nn.Dense(dtype=)``
  does;
* LayerNorm computes in fp32 with flax's fast variance
  (``var = max(E[x^2] - E[x]^2, 0)``), ``eps = cfg.ln_eps`` (1e-6) and
  returns fp32;
* GELU is the tanh form (flax ``nn.gelu`` default);
* ``wte``/``wpe`` rows are cast to ``cfg.dtype`` after the lookup, and the
  tied LM head runs in fp32 (``x.float() @ wte.T``).

Dense weights are stored as ``nn.Linear`` stores them, (out, in);
``models/convert.py`` transposes flax's (in, out) kernels.

``num_experts > 0`` replaces every block's MLP with a Switch top-1 (or
``moe_router="top2"``) mixture of GELU experts of width 4d
(``ops/moe.py``); each block's aux load-balance loss leaves the forward
with ``return_aux=True`` and :func:`loss_fn_moe` adds their mean.
``remat=True`` checkpoints each block under ``remat_policy`` ``"full"`` or
``"dots"`` (``utils/remat.py``). ``use_ring_attention=True`` shards the
sequence over the model's sp set (``ops/attention.sp_attention``; ``sp``,
bound by ``mp.tensor_parallel(model, sp=...)``, default the global process
set): each rank feeds its shard of the tokens, wpe follows the shard's
global positions, and :func:`striped_lm_loss` is the exact loss of the
striped layout (``mp.vocab_parallel_loss(..., sp=...)`` that of either
layout, over vocab slices too).

Tensor parallelism (``parallel/mp.py``): :func:`partition_rules` is the
reference's Megatron rule set over the port's parameter names, and
``mp.tensor_parallel(model)`` turns a built model into this rank's 1/mp
part. The layers then read their local head count from their weights;
``tp`` (a ``mp.TensorParallel``, None when the model is whole) places
Megatron's f at each column-parallel input, g at each row-parallel output
(``Dense.reduce``, the bias added once after the sum), the vocab-parallel
embedding and the head's f, and the model returns this rank's
(B, T, vocab/mp) logits for ``mp.vocab_parallel_loss``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.ops.attention import (ATTENTION_IMPLS,
                                             model_positions, sp_attention,
                                             validate_sp_config)
from horovod_tpu_torch.ops.moe import ROUTERS, MoEMLP
from horovod_tpu_torch.parallel.sharding import P, PartitionRules
from horovod_tpu_torch.utils.remat import maybe_remat, remat_context

__all__ = ["GPT2Config", "GPT2", "loss_fn", "loss_fn_moe",
           "striped_lm_loss", "sharded_lm_loss", "partition_rules"]


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304          # 50257 padded up to a 128 multiple
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    dropout: float = 0.0
    ln_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    remat_policy: str = "full"
    use_ring_attention: bool = False
    ring_layout: str = "contiguous"
    sp_impl: str = "ring"
    attention: str = "dense"         # "dense" | "flash"
    flash_blocks: Optional[tuple] = None
    num_experts: int = 0
    expert_capacity_factor: float = 1.25
    moe_router: str = "top1"

    @staticmethod
    def medium(**kw) -> "GPT2Config":
        return GPT2Config(num_layers=24, num_heads=16, d_model=1024, **kw)

    @staticmethod
    def tiny(**kw) -> "GPT2Config":
        return GPT2Config(vocab_size=256, max_seq_len=128, num_layers=2,
                          num_heads=4, d_model=64, **kw)


def _validate(cfg: GPT2Config) -> None:
    if cfg.attention not in ATTENTION_IMPLS:
        raise ValueError(f"unknown attention impl {cfg.attention!r}; "
                         f"expected one of {ATTENTION_IMPLS}")
    validate_sp_config(cfg)
    validate_moe_and_remat(cfg)
    if cfg.d_model % cfg.num_heads:
        raise ValueError(f"d_model {cfg.d_model} is not a multiple of "
                         f"num_heads {cfg.num_heads}")


def validate_moe_and_remat(cfg) -> None:
    """The reference's errors for an unknown router or remat policy,
    raised when the model is built."""
    if cfg.num_experts > 0 and cfg.moe_router not in ROUTERS:
        raise ValueError(f"unknown router_type {cfg.moe_router!r}; "
                         "expected 'top1' or 'top2'")
    if cfg.remat:
        remat_context(cfg)


class Dense(nn.Module):
    """flax ``nn.Dense(features, dtype=dtype, use_bias=bias)``: fp32
    parameters, the product in ``dtype``. ``weight`` is (out, in).
    ``reduce`` (set by ``mp.tensor_parallel`` on a row-parallel layer) sums
    the partial product over the tensor-parallel ranks before the bias."""

    reduce = None

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax lecun_normal: truncated normal, variance 1/fan_in.
        std = math.sqrt(1.0 / self.weight.shape[1]) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        if self.reduce is None:
            return F.linear(x.to(dt), self.weight.to(dt), b)
        y = self.reduce(F.linear(x.to(dt), self.weight.to(dt)))
        return y if b is None else y + b


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=eps, dtype=float32)``: fp32 statistics
    with the fast variance, the scale folded into the rsqrt multiplier."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mu) * mul + self.bias


class Attention(nn.Module):
    """Causal self-attention over the heads its ``qkv`` weight holds: all
    of them, or this rank's whole heads under tensor parallelism; under
    sequence parallelism over ``sp`` (None: the global set)."""

    tp = sp = None

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        self.qkv = Dense(cfg.d_model, 3 * cfg.d_model, cfg.dtype)
        self.out = Dense(cfg.d_model, cfg.d_model, cfg.dtype)

    def forward(self, x, segment_ids=None):
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.d_model // cfg.num_heads
        h = self.qkv.weight.shape[0] // (3 * hd)
        if self.tp is not None:
            x = self.tp.f(x)
        q, k, v = self.qkv(x).split(h * hd, dim=-1)
        q = q.reshape(b, t, h, hd)
        k = k.reshape(b, t, h, hd)
        v = v.reshape(b, t, h, hd)
        o = sp_attention(q, k, v, cfg, segment_ids=segment_ids,
                         process_set=self.sp)
        return self.out(o.reshape(b, t, h * hd))


class MLP(nn.Module):
    """``forward(x)`` -> (out, the MoE aux loss or None)."""

    tp = None

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        if cfg.num_experts > 0:
            self.moe = MoEMLP(cfg.d_model, cfg.num_experts, 4 * cfg.d_model,
                              cfg.expert_capacity_factor, cfg.dtype,
                              router_type=cfg.moe_router)
        else:
            self.fc = Dense(cfg.d_model, 4 * cfg.d_model, cfg.dtype)
            self.proj = Dense(4 * cfg.d_model, cfg.d_model, cfg.dtype)

    def forward(self, x):
        if hasattr(self, "moe"):
            return self.moe(x)
        if self.tp is not None:
            x = self.tp.f(x)
        return self.proj(F.gelu(self.fc(x), approximate="tanh")), None


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, cfg.ln_eps)
        self.attn = Attention(cfg)
        self.ln2 = LayerNorm(cfg.d_model, cfg.ln_eps)
        self.mlp = MLP(cfg)

    def forward(self, x, segment_ids=None):
        """-> (x, the MoE aux loss or None): the aux loss leaves as a
        return value, so a recomputed block adds it only once."""
        x = x + self.attn(self.ln1(x), segment_ids)
        y, aux = self.mlp(self.ln2(x))
        return x + y, aux


class GPT2(nn.Module):
    """Decoder-only LM. ``forward(tokens)`` -> fp32 logits (B, T, vocab).

    ``generator`` (default: a CPU generator seeded with 0) draws the
    initial weights as the reference's initializers shape them; the bits
    differ from JAX's, so parity runs load a JAX checkpoint with
    ``models.convert.gpt2_params_from_jax``.
    """

    tp = sp = None

    def __init__(self, cfg: GPT2Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _validate(cfg)
        self.cfg = cfg
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model))
        self.wpe = nn.Parameter(torch.empty(cfg.max_seq_len, cfg.d_model))
        self.h = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.d_model, cfg.ln_eps)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.wte.normal_(0.0, 0.02, generator=generator)
            self.wpe.normal_(0.0, 0.01, generator=generator)
        for m in self.modules():
            if isinstance(m, (Dense, MoEMLP)):
                m.reset_parameters(generator)

    def forward(self, tokens: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                return_aux: bool = False):
        """fp32 logits (B, T, vocab); with ``return_aux`` also the (L,)
        fp32 aux losses of the MoE blocks (empty for a dense model), the
        reference's sown ``losses`` collection."""
        cfg = self.cfg
        b, t = tokens.shape
        pos = model_positions(cfg, t, tokens.device, segment_ids, positions,
                              self.sp)
        emb = self.wte[tokens] if self.tp is None else \
            self.tp.embed(self.wte, tokens)
        x = emb.to(cfg.dtype) + self.wpe[pos].to(cfg.dtype)
        aux = []
        for block in self.h:
            x, a = maybe_remat(cfg, block)(x, segment_ids)
            if a is not None:
                aux.append(a)
        x = self.ln_f(x)
        if self.tp is not None:
            x = self.tp.f(x)
        # Tied LM head in fp32 (logits precision matters for the loss).
        logits = torch.einsum("btd,vd->btv", x.float(), self.wte.float())
        if not return_aux:
            return logits
        return logits, stack_aux(aux, logits)


def partition_rules() -> PartitionRules:
    """The reference's Megatron tp rule set (``horovod_tpu/models/gpt2.py``
    ``partition_rules``) over the port's parameter names: flax paths mapped
    as ``models/convert.py`` maps them (``h0/attn/qkv/kernel`` ->
    ``h.0.attn.qkv.weight``), each (in, out) kernel's spec transposed for
    the (out, in) weight. Column-parallel qkv / fc split their output rows,
    row-parallel out / proj their input columns, the embedding its vocab
    rows; the row-parallel biases stay whole. The ``ep`` rules of the MoE
    experts are kept as rules. The packed qkv weight splits by whole heads
    (``mp.split_params``), not in the contiguous row blocks that its spec
    alone would give."""
    return PartitionRules([
        (r"wte$", P("tp", None)),
        (r"wpe$", P()),
        (r"attn\.qkv\.weight", P("tp", None)),
        (r"attn\.out\.weight", P(None, "tp")),
        (r"mlp\.fc\.weight", P("tp", None)),
        (r"mlp\.proj\.weight", P(None, "tp")),
        (r"attn\.qkv\.bias", P("tp")),
        (r"mlp\.fc\.bias", P("tp")),
        (r"moe\.(w_in|w_out)$", P("ep", None, None)),
        (r"moe\.(b_in|b_out)$", P("ep", None)),
        (r"moe\.router\.router$", P()),
        (r"(ln1|ln2|ln_f)\.(weight|bias)", P()),
    ])


def stack_aux(aux, like: torch.Tensor) -> torch.Tensor:
    """The blocks' aux losses as one (L,) tensor (empty without MoE)."""
    return torch.stack(aux) if aux else like.new_zeros((0,))


def loss_fn(logits: torch.Tensor, tokens: torch.Tensor,
            segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy; with ``segment_ids`` the targets that
    cross a packed document boundary are excluded."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    ll = logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
    if segment_ids is None:
        return -ll.mean()
    w = (segment_ids[:, 1:] == segment_ids[:, :-1]).to(ll.dtype)
    return -(ll * w).sum() / w.sum().clamp_min(1)


def striped_lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    process_set=None) -> torch.Tensor:
    """Next-token cross entropy of the striped sequence-parallel layout,
    exact over the whole sequence: local position j of rank r is global
    position r + n*j, whose target is local j of rank r + 1 (the last rank
    takes rank 0's tokens shifted one step). One hop fetches every target;
    the sums go through a differentiable allreduce over ``process_set``
    (default: the global set), so every rank returns the global mean, and
    each rank's gradient is n times its share of it, as the reference's
    ``psum`` gives under ``shard_map``: the optimizer's average cancels n."""
    return sharded_lm_loss(logits, tokens, process_set, "striped")


def sharded_lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    process_set=None, layout: str = "contiguous",
                    token_ll=None) -> torch.Tensor:
    """``loss_fn`` over the whole sequence of a ``layout`` sequence shard
    (:func:`striped_lm_loss` for ``"striped"``; ``"contiguous"``: rank r
    holds positions [r*t, (r+1)*t) and its last target is rank r + 1's
    first token, fetched by one hop). ``process_set``: the sp set, or a
    ``Ring`` over it. ``token_ll(logits, targets)`` gives the (B, t)
    log-likelihoods (default: ``log_softmax`` over the whole vocab;
    ``mp.vocab_parallel_loss`` passes its vocab-parallel one). One rank
    holds the sequence in order: ``loss_fn``'s pairs and sums."""
    from horovod_tpu_torch.ops.ring_attention import Ring, check_layout
    check_layout(layout)
    ring = Ring.of(process_set)
    n, r = ring.n, ring.rank
    if token_ll is None:
        if n == 1:
            return loss_fn(logits, tokens)
        token_ll = _token_ll
    elif n == 1:
        return -token_ll(logits[:, :-1], tokens[:, 1:]).mean()
    t = tokens.shape[1]
    if layout == "striped":
        recv = ring.shift([tokens], forward=False)[0]
        targets = torch.cat([recv[:, 1:], recv[:, :1]], 1) if r == n - 1 \
            else recv
    else:
        first = ring.shift([tokens[:, :1]], forward=False)[0]
        targets = torch.cat([tokens[:, 1:], first], 1)
    # The last global position (last rank, last slot) predicts nothing.
    valid = torch.ones(t, dtype=torch.bool, device=tokens.device)
    if r == n - 1:
        valid[-1] = False
    ll = token_ll(logits, targets)
    s = torch.where(valid, ll, torch.zeros((), device=ll.device)).sum()
    c = valid.to(ll.dtype).sum() * tokens.shape[0]
    return -ring.psum(s) / ring.psum(c)


def _token_ll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(-1, targets[..., None].long())[..., 0]


def loss_fn_moe(model: nn.Module, tokens: torch.Tensor,
                aux_weight: float = 1e-2) -> torch.Tensor:
    """Cross entropy plus ``aux_weight`` times the mean of the MoE blocks'
    aux load-balance losses (GPT-2 or Llama with ``num_experts > 0``)."""
    if model.cfg.num_experts <= 0:
        raise ValueError("loss_fn_moe needs an MoE config "
                         f"(num_experts={model.cfg.num_experts}); use "
                         "loss_fn for dense models")
    logits, aux = model(tokens, return_aux=True)
    return loss_fn(logits, tokens) + aux_weight * aux.mean()
