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
``models/convert.py`` transposes flax's (in, out) kernels. Sequence
parallelism, mixture-of-experts MLPs and rematerialization are not ported
yet and raise when asked for.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.ops.attention import (ATTENTION_IMPLS,
                                             packed_positions, sp_attention)

__all__ = ["GPT2Config", "GPT2", "loss_fn"]


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
    if cfg.use_ring_attention:
        raise NotImplementedError(
            "sequence-parallel GPT-2: not yet ported")
    if cfg.num_experts > 0:
        raise NotImplementedError("mixture-of-experts GPT-2: not yet ported")
    if cfg.remat:
        raise NotImplementedError("rematerialization: not yet ported")
    if cfg.d_model % cfg.num_heads:
        raise ValueError(f"d_model {cfg.d_model} is not a multiple of "
                         f"num_heads {cfg.num_heads}")


class Dense(nn.Module):
    """flax ``nn.Dense(features, dtype=dtype, use_bias=bias)``: fp32
    parameters, the product in ``dtype``. ``weight`` is (out, in)."""

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
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


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
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        self.qkv = Dense(cfg.d_model, 3 * cfg.d_model, cfg.dtype)
        self.out = Dense(cfg.d_model, cfg.d_model, cfg.dtype)

    def forward(self, x, segment_ids=None):
        cfg = self.cfg
        b, t, d = x.shape
        h = cfg.num_heads
        q, k, v = self.qkv(x).split(d, dim=-1)
        q = q.reshape(b, t, h, d // h)
        k = k.reshape(b, t, h, d // h)
        v = v.reshape(b, t, h, d // h)
        o = sp_attention(q, k, v, cfg, segment_ids=segment_ids)
        return self.out(o.reshape(b, t, d))


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.fc = Dense(cfg.d_model, 4 * cfg.d_model, cfg.dtype)
        self.proj = Dense(4 * cfg.d_model, cfg.d_model, cfg.dtype)

    def forward(self, x):
        return self.proj(F.gelu(self.fc(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, cfg.ln_eps)
        self.attn = Attention(cfg)
        self.ln2 = LayerNorm(cfg.d_model, cfg.ln_eps)
        self.mlp = MLP(cfg)

    def forward(self, x, segment_ids=None):
        x = x + self.attn(self.ln1(x), segment_ids)
        return x + self.mlp(self.ln2(x))


class GPT2(nn.Module):
    """Decoder-only LM. ``forward(tokens)`` -> fp32 logits (B, T, vocab).

    ``generator`` (default: a CPU generator seeded with 0) draws the
    initial weights as the reference's initializers shape them; the bits
    differ from JAX's, so parity runs load a JAX checkpoint with
    ``models.convert.gpt2_params_from_jax``.
    """

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
            if isinstance(m, Dense):
                m.reset_parameters(generator)

    def forward(self, tokens: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        b, t = tokens.shape
        if positions is not None:
            pos = positions
        elif segment_ids is not None:
            pos = packed_positions(segment_ids)
        else:
            pos = torch.arange(t, device=tokens.device)
        x = self.wte[tokens].to(cfg.dtype) + self.wpe[pos].to(cfg.dtype)
        for block in self.h:
            x = block(x, segment_ids)
        x = self.ln_f(x)
        # Tied LM head in fp32 (logits precision matters for the loss).
        return torch.einsum("btd,vd->btv", x.float(), self.wte)


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
