"""BERT as a PyTorch ``nn.Module``: the encoder with its MLM and NSP heads.

Port of ``horovod_tpu/models/bert.py`` (the reference's "BERT-large
pretraining" configuration) with the reference's numerics, in the layers of
``gpt2.py``:

* parameters are fp32; every dense layer computes in ``cfg.dtype`` (bf16 on
  the card) with one fused ``qkv`` projection;
* the layers are post-LN: ``x = LN(x + attention(x))``, then
  ``x = LN(x + mlp(x))``, each LayerNorm in fp32 (flax's, eps 1e-6), so the
  residual stream leaves every layer in fp32; GELU is the tanh form;
* attention is non-causal under a key-padding mask. The reference always
  passes one (all ones when the caller gives none), so the flash kernels
  always take a key bias (0 or -1e30 per key);
* the embedding is ``wte[tokens] + wpe[positions] + wtt[token_types]``
  summed in fp32 and cast to ``cfg.dtype``; ``segment_ids`` packs several
  documents in a row (attention blocked across them, positions restarting
  at each);
* the MLM head is tied to ``wte`` and runs in fp32; the pooler (tanh) and
  the NSP head read the first token in fp32.

``models/convert.py`` carries the reference's parameters over
(``bert_params_from_jax``). ``remat=True`` checkpoints each layer
(``utils/remat.py``). ``use_ring_attention=True`` shards the sequence over
the global process set (``ops/attention.sp_attention``). The reference
gives BERT no tensor-parallel rule set (its ``validate_tp`` takes the GPT-2
and Llama families only), and neither does the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.models.gpt2 import Dense, LayerNorm
from horovod_tpu_torch.ops.attention import (ATTENTION_IMPLS,
                                             model_positions, sp_attention,
                                             validate_sp_config)
from horovod_tpu_torch.utils.remat import maybe_remat, remat_context

__all__ = ["BertConfig", "EncoderLayer", "Bert", "mlm_loss"]

# flax nn.LayerNorm's default epsilon.
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30592          # 30522 padded up to a 128 multiple
    max_seq_len: int = 512
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    type_vocab_size: int = 2
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    remat_policy: str = "full"
    attention: str = "dense"         # "dense" | "flash"
    flash_blocks: Optional[tuple] = None
    use_ring_attention: bool = False
    sp_impl: str = "ring"
    ring_layout: str = "contiguous"

    @staticmethod
    def large(**kw) -> "BertConfig":
        return BertConfig(num_layers=24, num_heads=16, d_model=1024, **kw)

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        return BertConfig(vocab_size=256, max_seq_len=64, num_layers=2,
                          num_heads=4, d_model=64, **kw)


def _validate(cfg: BertConfig) -> None:
    if cfg.attention not in ATTENTION_IMPLS:
        raise ValueError(f"unknown attention impl {cfg.attention!r}; "
                         f"expected one of {ATTENTION_IMPLS}")
    validate_sp_config(cfg)
    if cfg.remat:
        remat_context(cfg)
    if cfg.d_model % cfg.num_heads:
        raise ValueError(f"d_model {cfg.d_model} is not a multiple of "
                         f"num_heads {cfg.num_heads}")


class EncoderLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.qkv = Dense(d, 3 * d, cfg.dtype)
        self.out = Dense(d, d, cfg.dtype)
        self.ln_att = LayerNorm(d, LN_EPS)
        self.fc = Dense(d, 4 * d, cfg.dtype)
        self.proj = Dense(4 * d, d, cfg.dtype)
        self.ln_mlp = LayerNorm(d, LN_EPS)

    def forward(self, x, mask, segment_ids=None):
        cfg = self.cfg
        b, t, d = x.shape
        h = cfg.num_heads
        q, k, v = self.qkv(x).split(d, dim=-1)
        att = sp_attention(q.reshape(b, t, h, d // h),
                           k.reshape(b, t, h, d // h),
                           v.reshape(b, t, h, d // h), cfg, causal=False,
                           key_mask=mask, segment_ids=segment_ids)
        x = self.ln_att(x + self.out(att.reshape(b, t, d)))
        y = self.proj(F.gelu(self.fc(x), approximate="tanh"))
        return self.ln_mlp(x + y)


class Bert(nn.Module):
    """``forward(tokens, token_types=None, attention_mask=None,
    segment_ids=None, positions=None)`` -> (MLM logits (B, T, vocab) fp32,
    NSP logits (B, 2) fp32). ``attention_mask`` (B, T) bool marks the real
    keys; ``segment_ids`` (B, T) packs documents (not BERT's segment A/B,
    which are ``token_types``).

    ``generator`` (default: a CPU generator seeded with 0) draws the
    initial weights as the reference's initializers shape them.
    """

    def __init__(self, cfg: BertConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _validate(cfg)
        self.cfg = cfg
        d = cfg.d_model
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, d))
        self.wpe = nn.Parameter(torch.empty(cfg.max_seq_len, d))
        self.wtt = nn.Parameter(torch.empty(cfg.type_vocab_size, d))
        self.ln_emb = LayerNorm(d, LN_EPS)
        self.layer = nn.ModuleList(EncoderLayer(cfg)
                                   for _ in range(cfg.num_layers))
        self.pooler = Dense(d, d, torch.float32)
        self.nsp = Dense(d, 2, torch.float32)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for w in (self.wte, self.wpe, self.wtt):
                w.normal_(0.0, 0.02, generator=generator)
        for m in self.modules():
            if isinstance(m, Dense):
                m.reset_parameters(generator)

    def forward(self, tokens: torch.Tensor,
                token_types: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        b, t = tokens.shape
        if token_types is None:
            token_types = torch.zeros_like(tokens)
        if attention_mask is None and not cfg.use_ring_attention:
            attention_mask = torch.ones((b, t), dtype=torch.bool,
                                        device=tokens.device)
        mask = None if attention_mask is None else attention_mask.bool()
        pos = model_positions(cfg, t, tokens.device, segment_ids, positions)
        x = (self.wte[tokens] + self.wpe[pos] + self.wtt[token_types]).to(
            cfg.dtype)
        x = self.ln_emb(x)
        for layer in self.layer:
            x = maybe_remat(cfg, layer)(x, mask, segment_ids)
        mlm = torch.einsum("btd,vd->btv", x.float(), self.wte)
        cls = x[:, 0]
        if cfg.use_ring_attention:
            # Global position 0 lives on rank 0 in both layouts: every
            # rank's NSP head takes rank 0's [CLS], through a
            # differentiable allreduce (the reference's psum).
            cls = _cls_of_rank0(cls)
        pooled = torch.tanh(self.pooler(cls.float()))
        return mlm, self.nsp(pooled)


def _cls_of_rank0(cls: torch.Tensor) -> torch.Tensor:
    from torch.distributed.nn.functional import all_reduce
    from horovod_tpu_torch.process_set import global_process_set
    ps = global_process_set()
    if ps.size() == 1:
        return cls
    mine = cls if ps.rank() == 0 else torch.zeros_like(cls)
    return all_reduce(mine, group=ps.group)


def mlm_loss(mlm_logits: torch.Tensor, tokens: torch.Tensor,
             mask_positions: torch.Tensor) -> torch.Tensor:
    """Masked-LM cross entropy over the masked positions (a 0/1 mask)."""
    logp = torch.log_softmax(mlm_logits, dim=-1)
    ll = logp.gather(-1, tokens[..., None].long())[..., 0]
    m = mask_positions.to(ll.dtype)
    return -(ll * m).sum() / m.sum().clamp_min(1)
