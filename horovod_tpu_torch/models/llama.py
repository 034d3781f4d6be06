"""Llama-family decoder as a PyTorch ``nn.Module``: RoPE, RMSNorm, SwiGLU
and grouped-query attention.

Port of ``horovod_tpu/models/llama.py`` with the reference's numerics, in
the layers of ``gpt2.py``:

* parameters are fp32; every projection is bias-free and computes in
  ``cfg.dtype`` (bf16 on the card);
* :class:`RMSNorm` computes in fp32 with ``cfg.rms_eps`` and returns its
  input's dtype; :func:`apply_rope` rotates in fp32 in the "rotate half"
  form, with (T,) or (B, T) positions;
* grouped-query attention expands K and V from ``num_kv_heads`` to
  ``num_heads`` after the projections, each KV head repeated for its
  ``num_heads / num_kv_heads`` query heads in a row (``jnp.repeat`` on the
  head axis, which is ``repeat_interleave``, not ``repeat``), so the flash
  kernels see plain multi-head shapes;
* the MLP is SwiGLU, ``down(silu(gate(x)) * up(x))``;
* the LM head is untied from ``wte`` and runs in fp32; the loss is GPT-2's
  next-token cross entropy (:func:`loss_fn`).

``models/convert.py`` carries the reference's parameters over
(``llama_params_from_jax``). ``num_experts > 0`` swaps every SwiGLU for a
Mixtral-style layer: bias-free SwiGLU experts behind a top-2 router
(``ops/moe.py``), trained with :func:`loss_fn_moe`. ``remat=True``
checkpoints each block (``utils/remat.py``). ``use_ring_attention=True``
shards the sequence over the model's sp set, as GPT-2's
(``ops/attention.sp_attention``; default the global process set). Tensor parallelism as GPT-2's
(``parallel/mp.py``): :func:`partition_rules` is the reference's Megatron
rule set over the port's names, with the (in, out) specs transposed; under
``mp.tensor_parallel`` each rank holds whole q and kv heads (local q heads
over local kv heads keep the GQA grouping), f at the column-parallel
wq / wk / wv and gate / up inputs, g at the row-parallel wo and down
outputs, and the vocab-parallel embedding and untied head.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.models.gpt2 import (Dense, loss_fn, loss_fn_moe,
                                           stack_aux, validate_moe_and_remat)
from horovod_tpu_torch.ops.attention import (ATTENTION_IMPLS,
                                             model_positions, sp_attention,
                                             validate_sp_config)
from horovod_tpu_torch.ops.moe import MoEMLP
from horovod_tpu_torch.parallel.sharding import P, PartitionRules
from horovod_tpu_torch.utils.remat import maybe_remat

__all__ = ["LlamaConfig", "Llama", "RMSNorm", "apply_rope", "loss_fn",
           "loss_fn_moe", "partition_rules"]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq_len: int = 2048
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32           # < num_heads = grouped-query attention
    d_model: int = 4096
    d_ff: int = 11008                # SwiGLU hidden width
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
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
    moe_router: str = "top2"

    @staticmethod
    def llama7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)     # the defaults are 7B

    @staticmethod
    def small(**kw) -> "LlamaConfig":
        base = dict(num_layers=12, num_heads=12, num_kv_heads=4,
                    d_model=768, d_ff=2048, max_seq_len=1024)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        base = dict(vocab_size=256, max_seq_len=128, num_layers=2,
                    num_heads=4, num_kv_heads=2, d_model=64, d_ff=128)
        base.update(kw)
        return LlamaConfig(**base)


def _validate(cfg: LlamaConfig) -> None:
    if cfg.attention not in ATTENTION_IMPLS:
        raise ValueError(f"unknown attention impl {cfg.attention!r}; "
                         f"expected one of {ATTENTION_IMPLS}")
    validate_sp_config(cfg)
    validate_moe_and_remat(cfg)
    if cfg.d_model % cfg.num_heads:
        raise ValueError(f"d_model {cfg.d_model} is not a multiple of "
                         f"num_heads {cfg.num_heads}")
    if cfg.num_heads % cfg.num_kv_heads:
        raise ValueError(f"num_kv_heads={cfg.num_kv_heads} must divide "
                         f"num_heads={cfg.num_heads}")


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary position embedding of (B, T, H, D) ``x`` at (T,) or (B, T)
    ``positions``: the halves (x1, x2) become (x1 cos - x2 sin,
    x2 cos + x1 sin), in fp32, cast back to ``x``'s dtype."""
    d2 = x.shape[-1] // 2
    freq = theta ** (-torch.arange(d2, dtype=torch.float32,
                                   device=x.device) / d2)
    ang = positions.float()[..., None] * freq            # (..., T, d2)
    if ang.dim() == 2:
        ang = ang[None]
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    xf = x.float()
    x1, x2 = xf[..., :d2], xf[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


class RMSNorm(nn.Module):
    """fp32 root-mean-square norm with a learned scale; returns the input's
    dtype."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight).to(x.dtype)


class Attention(nn.Module):
    """Grouped-query attention over the q and kv heads its weights hold:
    all of them, or this rank's whole heads under tensor parallelism;
    under sequence parallelism over ``sp`` (None: the global set)."""

    tp = sp = None

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        hd = cfg.d_model // cfg.num_heads
        self.cfg = cfg
        self.wq = Dense(cfg.d_model, cfg.num_heads * hd, cfg.dtype, False)
        self.wk = Dense(cfg.d_model, cfg.num_kv_heads * hd, cfg.dtype, False)
        self.wv = Dense(cfg.d_model, cfg.num_kv_heads * hd, cfg.dtype, False)
        self.wo = Dense(cfg.d_model, cfg.d_model, cfg.dtype, False)

    def forward(self, x, positions, segment_ids=None):
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.d_model // cfg.num_heads
        h, hkv = self.wq.weight.shape[0] // hd, self.wk.weight.shape[0] // hd
        if self.tp is not None:
            x = self.tp.f(x)
        q = apply_rope(self.wq(x).reshape(b, t, h, hd), positions,
                       cfg.rope_theta)
        k = apply_rope(self.wk(x).reshape(b, t, hkv, hd), positions,
                       cfg.rope_theta)
        v = self.wv(x).reshape(b, t, hkv, hd)
        if hkv != h:
            k = k.repeat_interleave(h // hkv, dim=2)
            v = v.repeat_interleave(h // hkv, dim=2)
        o = sp_attention(q, k, v, cfg, segment_ids=segment_ids,
                         process_set=self.sp)
        return self.wo(o.reshape(b, t, h * hd))


class SwiGLU(nn.Module):
    """``forward(x)`` -> (out, the MoE aux loss or None)."""

    tp = None

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        if cfg.num_experts > 0:
            self.moe = MoEMLP(cfg.d_model, cfg.num_experts, cfg.d_ff,
                              cfg.expert_capacity_factor, cfg.dtype,
                              router_type=cfg.moe_router,
                              activation="swiglu")
        else:
            self.gate = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, False)
            self.up = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, False)
            self.down = Dense(cfg.d_ff, cfg.d_model, cfg.dtype, False)

    def forward(self, x):
        if hasattr(self, "moe"):
            return self.moe(x)
        if self.tp is not None:
            x = self.tp.f(x)
        return self.down(F.silu(self.gate(x)) * self.up(x)), None


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.norm_attn = RMSNorm(cfg.d_model, cfg.rms_eps)
        self.attn = Attention(cfg)
        self.norm_mlp = RMSNorm(cfg.d_model, cfg.rms_eps)
        self.mlp = SwiGLU(cfg)

    def forward(self, x, positions, segment_ids=None):
        """-> (x, the MoE aux loss or None)."""
        x = x + self.attn(self.norm_attn(x), positions, segment_ids)
        y, aux = self.mlp(self.norm_mlp(x))
        return x + y, aux


class Llama(nn.Module):
    """Decoder-only LM. ``forward(tokens, segment_ids=None,
    positions=None)`` -> fp32 logits (B, T, vocab). ``segment_ids`` packs
    documents (attention blocked across them, RoPE positions restarting at
    each); ``positions`` overrides the RoPE positions; ``return_aux`` also
    returns the MoE blocks' (L,) aux losses.

    ``generator`` (default: a CPU generator seeded with 0) draws the
    initial weights as the reference's initializers shape them.
    """

    tp = sp = None

    def __init__(self, cfg: LlamaConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _validate(cfg)
        self.cfg = cfg
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model))
        self.h = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.norm_f = RMSNorm(cfg.d_model, cfg.rms_eps)
        self.lm_head = nn.Parameter(torch.empty(cfg.vocab_size,
                                                cfg.d_model))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.wte.normal_(0.0, 0.02, generator=generator)
            self.lm_head.normal_(0.0, 0.02, generator=generator)
        for m in self.modules():
            if isinstance(m, (Dense, MoEMLP)):
                m.reset_parameters(generator)

    def forward(self, tokens: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                return_aux: bool = False):
        cfg = self.cfg
        # Under sequence parallelism RoPE turns by the shard's global
        # positions.
        pos = model_positions(cfg, tokens.shape[1], tokens.device,
                              segment_ids, positions, self.sp)
        emb = self.wte[tokens] if self.tp is None else \
            self.tp.embed(self.wte, tokens)
        x = emb.to(cfg.dtype)
        aux = []
        for block in self.h:
            x, a = maybe_remat(cfg, block)(x, pos, segment_ids)
            if a is not None:
                aux.append(a)
        x = self.norm_f(x)
        if self.tp is not None:
            x = self.tp.f(x)
        logits = torch.einsum("btd,vd->btv", x.float(), self.lm_head.float())
        return (logits, stack_aux(aux, logits)) if return_aux else logits


def partition_rules() -> PartitionRules:
    """The reference's Megatron tp rule set (``horovod_tpu/models/llama.py``
    ``partition_rules``) over the port's parameter names, each (in, out)
    kernel's spec transposed for the (out, in) weight: column-parallel
    wq / wk / wv / gate / up split their output rows, row-parallel wo /
    down their input columns, the embedding and the head their vocab rows;
    the norms are replicated and the MoE experts keep their ``ep`` rule."""
    return PartitionRules([
        (r"wte$", P("tp", None)),
        (r"lm_head$", P("tp", None)),
        (r"(wq|wk|wv|gate|up)\.weight$", P("tp", None)),
        (r"(wo|down)\.weight$", P(None, "tp")),
        (r"moe\.(w_gate|w_in|w_out)$", P("ep", None, None)),
        (r"(norm_attn|norm_mlp|norm_f)\.weight$", P()),
    ])
