"""T5 encoder-decoder as a PyTorch ``nn.Module``: relative position buckets,
RMSNorm and the gated-GELU FFN.

Port of ``horovod_tpu/models/t5.py`` with the reference's numerics, in the
layers of ``gpt2.py`` and ``llama.py``:

* parameters are fp32; every projection is bias-free and computes in
  ``cfg.dtype`` (bf16 on the card); norms are the fp32 :class:`RMSNorm`
  that returns its input's dtype; the untied LM head runs in fp32;
* attention is the shared dense ``multihead_attention`` with the T5
  specifics: ``scale=1.0`` and a per-head (H, Tq, Tk) relative position
  bias, which the flash kernels cannot take (their bias is per key), so no
  kernel of the port runs on this model;
* one learned bias table per stack (``enc_rel``, ``dec_rel``), shared by
  its layers; cross-attention carries no position bias; a source row that
  is all padding attends to nothing and gives zeros.

``models/convert.py`` carries the reference's parameters over
(``t5_params_from_jax``); ``remat=True`` checkpoints each layer
(``utils/remat.py``). Decoding with a KV cache is ``models/generate.py``'s
``t5_generate`` (on a whole model only).

Tensor parallelism (``parallel/mp.py``): :func:`partition_rules` is the
reference's Megatron rule set over the port's names, and
``mp.tensor_parallel(model, tp_set)`` turns a built T5 into this rank's
1/mp part. ``tp`` (a ``mp.TensorParallel``, None when the model is whole)
places f at each column-parallel input (the query input of every
attention, separately the encoder's states that the cross attention
reads, the gated-GELU input and the head's input), g at the row-parallel
``o`` and ``wo`` outputs (``Dense.reduce``), and the vocab-parallel lookup
of the shared embedding for both stacks. The attention runs at the local
head count H/mp. Each rank adds its own heads' columns of the replicated
bias tables, taken after an f on the table, so each table's gradient is
the whole one on every rank. The model then returns this rank's
(B, T_dec, V/mp) logits, and :func:`seq2seq_loss` is the exact loss over
the vocab slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.models.gpt2 import Dense
from horovod_tpu_torch.models.llama import RMSNorm
from horovod_tpu_torch.ops.attention import multihead_attention
from horovod_tpu_torch.parallel.sharding import P, PartitionRules
from horovod_tpu_torch.utils.remat import maybe_remat, remat_context

__all__ = ["T5", "T5Config", "relative_position_bucket", "shift_right",
           "seq2seq_loss", "partition_rules"]


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_ff: int = 1024                 # gated-GELU hidden width
    num_heads: int = 8
    head_dim: int = 64               # decoupled from d_model (T5 trait)
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    rel_buckets: int = 32
    rel_max_distance: int = 128
    ln_eps: float = 1e-6             # RMSNorm epsilon
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    remat_policy: str = "full"       # "full" | "dots"
    pad_id: int = 0                  # also the decoder start token (T5)

    @staticmethod
    def small(**kw) -> "T5Config":
        return T5Config(**kw)        # the defaults are t5-small class

    @staticmethod
    def tiny(**kw) -> "T5Config":
        base = dict(vocab_size=256, d_model=64, d_ff=128, num_heads=4,
                    head_dim=16, num_encoder_layers=2,
                    num_decoder_layers=2, rel_buckets=8,
                    rel_max_distance=32)
        base.update(kw)
        return T5Config(**base)


def relative_position_bucket(rel_pos: torch.Tensor, *, bidirectional: bool,
                             num_buckets: int, max_distance: int
                             ) -> torch.Tensor:
    """T5's bucket of each signed relative position (key - query): half the
    buckets are exact small distances, the rest grow logarithmically out
    to ``max_distance`` (everything beyond shares the last). Bidirectional
    splits the buckets between positive and negative offsets; causal maps
    the future to bucket 0. The log ratio is taken in fp32 and truncated,
    as the reference does."""
    ret = torch.zeros_like(rel_pos)
    n = num_buckets
    if bidirectional:
        n //= 2
        ret = ret + (rel_pos > 0).to(rel_pos.dtype) * n
        rel = rel_pos.abs()
    else:
        rel = (-rel_pos).clamp_min(0)
    max_exact = n // 2
    is_small = rel < max_exact
    relf = rel.float().clamp_min(1.0)
    log_range = torch.log(torch.tensor(max_distance / max_exact,
                                       dtype=torch.float32,
                                       device=rel_pos.device))
    large = max_exact + (torch.log(relf / max_exact) / log_range
                         * (n - max_exact)).to(rel_pos.dtype)
    large = large.clamp_max(n - 1)
    return ret + torch.where(is_small, rel, large)


class RelativeBias(nn.Module):
    """The learned (buckets, H) bias table of one stack; ``forward(t_q,
    t_kv)`` -> the (H, t_q, t_kv) fp32 bias, under tensor parallelism this
    rank's H/mp heads of it."""

    tp = None

    def __init__(self, cfg: T5Config, bidirectional: bool):
        super().__init__()
        self.cfg, self.bidirectional = cfg, bidirectional
        self.rel_bias = nn.Parameter(torch.empty(cfg.rel_buckets,
                                                 cfg.num_heads))

    def buckets(self, t_q: int, t_kv: int) -> torch.Tensor:
        dev = self.rel_bias.device
        rel = (torch.arange(t_kv, device=dev)[None, :]
               - torch.arange(t_q, device=dev)[:, None])
        return relative_position_bucket(
            rel, bidirectional=self.bidirectional,
            num_buckets=self.cfg.rel_buckets,
            max_distance=self.cfg.rel_max_distance)

    def forward(self, t_q: int, t_kv: int) -> torch.Tensor:
        table = self.rel_bias
        if self.tp is not None:
            # The table is whole on every rank and each adds its own heads'
            # columns: f sums the column gradients over the line.
            h = table.shape[1] // self.tp.size
            table = self.tp.f(table)[:, self.tp.rank * h:
                                     (self.tp.rank + 1) * h]
        return table[self.buckets(t_q, t_kv)].permute(2, 0, 1)


class T5Attention(nn.Module):
    """Projections around the shared dense attention over the heads its
    weights hold (all, or this rank's H/mp): ``kv`` defaults to ``x``
    (self-attention); ``key_mask`` (B, Tkv) masks padding keys."""

    tp = None

    def __init__(self, cfg: T5Config):
        super().__init__()
        inner = cfg.num_heads * cfg.head_dim
        self.cfg = cfg
        self.q = Dense(cfg.d_model, inner, cfg.dtype, False)
        self.k = Dense(cfg.d_model, inner, cfg.dtype, False)
        self.v = Dense(cfg.d_model, inner, cfg.dtype, False)
        self.o = Dense(inner, cfg.d_model, cfg.dtype, False)

    def forward(self, x, kv=None, bias=None, key_mask=None,
                causal: bool = False):
        cfg = self.cfg
        if self.tp is not None:
            # f at the column-parallel inputs: the cross attention's kv (the
            # encoder's states) takes its own.
            x = self.tp.f(x)
            kv = None if kv is None else self.tp.f(kv)
        kv = x if kv is None else kv
        b, tq, _ = x.shape
        tk = kv.shape[1]
        hd = cfg.head_dim
        h = self.q.weight.shape[0] // hd
        o = multihead_attention(
            self.q(x).reshape(b, tq, h, hd), self.k(kv).reshape(b, tk, h, hd),
            self.v(kv).reshape(b, tk, h, hd), impl="dense", causal=causal,
            key_mask=key_mask, bias=bias, scale=1.0, out_dtype=cfg.dtype)
        return self.o(o.reshape(b, tq, h * hd))


class GatedGelu(nn.Module):
    """t5.1.1 FFN: ``wo(gelu(wi_0(x)) * wi_1(x))``, bias-free."""

    tp = None

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, False)
        self.wi_1 = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, False)
        self.wo = Dense(cfg.d_ff, cfg.d_model, cfg.dtype, False)

    def forward(self, x):
        if self.tp is not None:
            x = self.tp.f(x)
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh")
                       * self.wi_1(x))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.ln_eps)
        self.attn = T5Attention(cfg)
        self.ln2 = RMSNorm(cfg.d_model, cfg.ln_eps)
        self.mlp = GatedGelu(cfg)

    def forward(self, x, bias, key_mask):
        x = x + self.attn(self.ln1(x), bias=bias, key_mask=key_mask)
        return x + self.mlp(self.ln2(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.ln_eps)
        self.self_attn = T5Attention(cfg)
        self.ln2 = RMSNorm(cfg.d_model, cfg.ln_eps)
        self.cross_attn = T5Attention(cfg)
        self.ln3 = RMSNorm(cfg.d_model, cfg.ln_eps)
        self.mlp = GatedGelu(cfg)

    def forward(self, x, enc, bias, enc_mask):
        x = x + self.self_attn(self.ln1(x), bias=bias, causal=True)
        # Cross-attention carries no position bias in T5.
        x = x + self.cross_attn(self.ln2(x), kv=enc, key_mask=enc_mask)
        return x + self.mlp(self.ln3(x))


class T5(nn.Module):
    """``forward(enc_tokens, dec_tokens=None, enc_mask=None)``: fp32 logits
    (B, T_dec, vocab) of the decoder INPUT ids ``dec_tokens`` (already
    shifted right; :func:`seq2seq_loss` shifts for you); with
    ``dec_tokens=None`` the encoder only, its (B, T_enc, d_model) states in
    ``cfg.dtype``. ``enc_mask`` (B, T_enc) bool marks real source tokens
    (default ``enc_tokens != pad_id``).

    ``generator`` (default: a CPU generator seeded with 0) draws the
    initial weights as the reference's initializers shape them.
    """

    tp = sp = None

    def __init__(self, cfg: T5Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.remat:
            remat_context(cfg)
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.empty(cfg.vocab_size,
                                                  cfg.d_model))
        self.enc_rel = RelativeBias(cfg, bidirectional=True)
        self.enc = nn.ModuleList(EncoderLayer(cfg)
                                 for _ in range(cfg.num_encoder_layers))
        self.enc_norm = RMSNorm(cfg.d_model, cfg.ln_eps)
        self.dec_rel = RelativeBias(cfg, bidirectional=False)
        self.dec = nn.ModuleList(DecoderLayer(cfg)
                                 for _ in range(cfg.num_decoder_layers))
        self.dec_norm = RMSNorm(cfg.d_model, cfg.ln_eps)
        self.lm_head = nn.Parameter(torch.empty(cfg.vocab_size,
                                                cfg.d_model))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.embedding.normal_(0.0, 1.0, generator=generator)
            for rb in (self.enc_rel, self.dec_rel):
                rb.rel_bias.normal_(0.0, 0.02, generator=generator)
            self.lm_head.normal_(0.0, 0.02, generator=generator)
        for m in self.modules():
            if isinstance(m, Dense):
                m.reset_parameters(generator)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The shared embedding's rows in ``cfg.dtype`` (vocab-parallel
        under tensor parallelism)."""
        emb = self.embedding[tokens] if self.tp is None else \
            self.tp.embed(self.embedding, tokens)
        return emb.to(self.cfg.dtype)

    def encode(self, enc_tokens: torch.Tensor,
               enc_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.embed(enc_tokens)
        t = x.shape[1]
        bias = self.enc_rel(t, t)
        for layer in self.enc:
            x = maybe_remat(cfg, layer)(x, bias, enc_mask)
        return self.enc_norm(x)

    def forward(self, enc_tokens: torch.Tensor,
                dec_tokens: Optional[torch.Tensor] = None,
                enc_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        if enc_mask is None:
            enc_mask = enc_tokens != cfg.pad_id
        enc = self.encode(enc_tokens, enc_mask)
        if dec_tokens is None:
            return enc
        y = self.embed(dec_tokens)
        t = y.shape[1]
        bias = self.dec_rel(t, t)
        for layer in self.dec:
            y = maybe_remat(cfg, layer)(y, enc, bias, enc_mask)
        y = self.dec_norm(y)
        if self.tp is not None:
            y = self.tp.f(y)
        # v1.1: untied LM head, fp32 logits.
        return torch.einsum("btd,vd->btv", y.float(), self.lm_head.float())


def shift_right(tokens: torch.Tensor, start_id: int) -> torch.Tensor:
    """Teacher-forcing input: the start token, then all but the last."""
    return torch.cat([torch.full_like(tokens[:, :1], start_id),
                      tokens[:, :-1]], dim=1)


def seq2seq_loss(model: T5, enc_tokens: torch.Tensor, labels: torch.Tensor,
                 enc_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher-forced cross entropy over the non-pad ``labels`` (B, T_dec),
    the target ids; the decoder input is their right shift with the
    pad/start token. On a tensor-parallel model (``model.tp`` set) the
    log-likelihoods come from this rank's vocab slice of the logits with
    ``mp``'s vocab-parallel arithmetic: every rank returns the loss of the
    whole vocab, and the logits are never gathered."""
    cfg = model.cfg
    logits = model(enc_tokens, shift_right(labels, cfg.pad_id),
                   enc_mask=enc_mask)
    return _token_loss(logits, labels, cfg.pad_id, model.tp)


def _token_loss(logits: torch.Tensor, labels: torch.Tensor, pad_id: int,
                tp=None) -> torch.Tensor:
    """:func:`seq2seq_loss` over given logits: the pad-weighted mean
    negative log-likelihood of ``labels``, over the whole vocab or, with
    ``tp``, over its vocab slices."""
    if tp is None:
        logp = torch.log_softmax(logits, dim=-1)
        ll = logp.gather(-1, labels[..., None].long())[..., 0]
    else:
        from horovod_tpu_torch.parallel.mp import _vocab_parallel_ll
        ll = _vocab_parallel_ll(tp, logits, labels)
    w = (labels != pad_id).to(ll.dtype)
    return -(ll * w).sum() / w.sum().clamp_min(1)


def partition_rules() -> PartitionRules:
    """The reference's Megatron tp rule set (``horovod_tpu/models/t5.py``
    ``partition_rules``) over the port's parameter names, each (in, out)
    kernel's spec transposed for the (out, in) weight: column-parallel
    q / k / v / wi_0 / wi_1 split their output rows, row-parallel o / wo
    their input columns, the shared embedding and the untied head their
    vocab rows; the two bias tables and every RMSNorm stay whole."""
    return PartitionRules([
        (r"^embedding$", P("tp", None)),
        (r"^lm_head$", P("tp", None)),
        (r"\.(q|k|v|wi_0|wi_1)\.weight$", P("tp", None)),
        (r"\.(o|wo)\.weight$", P(None, "tp")),
        (r"\.rel_bias$", P()),
        (r"(^|\.)(ln1|ln2|ln3|enc_norm|dec_norm)\.weight$", P()),
    ])
