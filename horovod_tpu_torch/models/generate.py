"""Autoregressive generation with a KV cache for GPT-2, Llama and T5.

Port of ``horovod_tpu/models/generate.py``. Decode is its own program, one
token a step against cached K and V, written over the ported models'
parameters (it reads each ``nn.Module``'s weights and calls its norms and
``Dense`` layers) rather than through a ``decode`` flag in the training
modules. A model that ``parallel/mp.py`` made tensor-parallel decodes
through the same steps: its layers hold this rank's heads and sum their
row-parallel products, and the head gathers the vocab slices. The loop is
a Python loop over positions; the prompt is
teacher-forced through the same step (no prefill), as in the reference.

The cache is one K and one V of (B, T_total, kv heads, head dim) per layer
in the model's compute dtype, written in place. Decode computes in
``cfg.dtype`` with the training forward's fp32 islands: fp32 norms, fp32
softmax, an fp32 logits head, and the cast back to the compute dtype at
each layer boundary. :func:`greedy_token` closes the near-ties that remain
with a deterministic tolerance tie-break.

Sampling: greedy at ``temperature=0`` (the default), else a temperature
softmax with optional top-k, drawn with an explicit ``torch.Generator``
(its draws are not JAX's); ``eos_id`` freezes a finished row. The
per-family steps are exposed through :func:`decode_step`,
:func:`decode_verify_step`, :func:`init_cache` and :func:`decode_family`
for a serving engine to drive. Mixture-of-experts configs are refused, as
in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["generate", "t5_generate", "greedy_token",
           "decode_step", "decode_verify_step", "init_cache",
           "decode_family", "DecodeFamily",
           "DenseKVCache", "t5_decoder_bias", "t5_encode"]

_NEG_INF = -1e30

# Rows a decode step's row-wise work (norms, matrix products, the logits
# head) runs on for a CUDA batch. On an H100 a row reduction (LayerNorm's
# mean) over 8 rows, and a bf16 product with a long sum (K >= 2816) over
# fewer than 128 rows, add their terms in another order than the training
# forward's many-row kernels; the ulps that differ grow over GPT-2 medium's
# 24 layers into logits 0.045 from the forward's
# (``tools/torch_batch_invariance.py``). With this many rows they take the
# forward's kernels, and decode equals the forward (``chip_smoke.py`` phase
# 9 (g)).
MIN_ROWS = 128


def _is_scalar(pos) -> bool:
    return not torch.is_tensor(pos) or pos.dim() == 0


def _pad_rows(x):
    """A CUDA ``x`` of fewer than MIN_ROWS rows with zero rows appended;
    the step carries them through its row-wise work and reads only the
    batch's rows."""
    b = x.shape[0]
    if not x.is_cuda or b >= MIN_ROWS:
        return x
    return torch.cat([x, x.new_zeros((MIN_ROWS - b,) + x.shape[1:])])


class DenseKVCache:
    """The dense cache as a protocol object over the ``{layer: {"k",
    "v"}}`` dict of :func:`init_cache`. ``update(layer, k, v, pos)`` writes
    the (B, kv heads, head dim) K and V at ``pos`` (a scalar: every row, or
    (B,): one position a row) in place and returns (cache, K, V of the
    layer)."""

    __slots__ = ("layers",)

    def __init__(self, layers):
        self.layers = layers

    def update(self, layer, k, v, pos):
        ent = self.layers[layer]
        if _is_scalar(pos):
            ent["k"][:, pos] = k
            ent["v"][:, pos] = v
        else:
            rows = torch.arange(k.shape[0], device=k.device)
            ent["k"][rows, pos] = k
            ent["v"][rows, pos] = v
        return self, ent["k"], ent["v"]


def _as_cache(cache):
    """The raw dense dict or any protocol object; remember which."""
    if isinstance(cache, dict):
        return DenseKVCache(cache), True
    return cache, False


def _key_mask(t, pos, lead_dims, device):
    """(..., t) bool: key position <= query position. A scalar ``pos``
    broadcasts; (B,) positions get ``lead_dims`` singleton axes between
    the batch and the keys."""
    ar = torch.arange(t, device=device)
    if _is_scalar(pos):
        return ar <= pos
    idx = (None,) * (lead_dims + 1)
    return ar[idx] <= pos[(slice(None),) + idx]


def _attend_cached(q, ck, cv, idx, scale):
    """One query (B, H, hd) over a cache (B, T, Hkv, hd), keys <= idx. GQA
    stays grouped: query head j reads KV head j // (H / Hkv). Scores in the
    compute dtype, then fp32 with the scale and the softmax, probabilities
    cast back for the value product (the training dense path's flow)."""
    b, h, hd = q.shape
    hkv = ck.shape[2]
    qg = q.reshape(b, hkv, h // hkv, hd)
    s = torch.einsum("bkgd,btkd->bkgt", qg, ck).float() * scale
    s = torch.where(_key_mask(ck.shape[1], idx, 2, q.device), s, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgt,btkd->bkgd", p, cv).reshape(b, h, hd)


def _embed(model, tok):
    """The embedding rows of ``tok``: the vocab-parallel lookup when the
    model is tensor-parallel (``parallel/mp.py``)."""
    return model.wte[tok] if model.tp is None else \
        model.tp.embed(model.wte, tok)


def _head(model, logits):
    """(B, V) logits, or this rank's (B, V/mp) gathered along the vocab."""
    return logits if model.tp is None else model.tp.gather_vocab(logits)


def _gpt2_step(cfg, model, cache, tok, idx):
    """tok (B,) at position idx (scalar or (B,)) -> (cache, fp32 logits
    (B, V)). The head count is the one the qkv weight holds: all the
    heads, or this rank's under tensor parallelism."""
    cache, raw = _as_cache(cache)
    dt = cfg.dtype
    b, hd = tok.shape[0], cfg.d_model // cfg.num_heads
    x = _pad_rows(_embed(model, tok).to(dt) + model.wpe[idx].to(dt))
    for i, blk in enumerate(model.h):
        att, mlp = blk.attn, blk.mlp
        h = att.qkv.weight.shape[0] // (3 * hd)
        q, k, v = att.qkv(blk.ln1(x))[:b].split(h * hd, dim=-1)
        cache, ck, cv = cache.update(i, k.reshape(b, h, hd),
                                     v.reshape(b, h, hd), idx)
        o = _attend_cached(q.reshape(b, h, hd), ck, cv, idx, hd ** -0.5)
        x = x + att.out(_pad_rows(o.reshape(b, h * hd)))
        x = x + mlp.proj(F.gelu(mlp.fc(blk.ln2(x)), approximate="tanh"))
    # fp32 final norm and tied head.
    logits = (model.ln_f(x) @ model.wte.float().t())[:b]
    return (cache.layers if raw else cache), _head(model, logits)


def _rope_one(x, pos, theta):
    """The training rotation (``llama.apply_rope``) of (B, H, hd) ``x`` at
    one position a row: a scalar ``pos`` for all, or (B,)."""
    from horovod_tpu_torch.models.llama import apply_rope
    pos = torch.as_tensor(pos, device=x.device)
    pos = pos[:, None] if pos.dim() else pos[None]
    return apply_rope(x[:, None], pos, theta)[:, 0]


def _llama_step(cfg, model, cache, tok, idx):
    cache, raw = _as_cache(cache)
    dt = cfg.dtype
    b, hd = tok.shape[0], cfg.d_model // cfg.num_heads
    x = _pad_rows(_embed(model, tok).to(dt))
    for i, blk in enumerate(model.h):
        att, mlp = blk.attn, blk.mlp
        h, hkv = att.wq.weight.shape[0] // hd, att.wk.weight.shape[0] // hd
        y = blk.norm_attn(x)
        q = _rope_one(att.wq(y)[:b].reshape(b, h, hd), idx, cfg.rope_theta)
        k = _rope_one(att.wk(y)[:b].reshape(b, hkv, hd), idx,
                      cfg.rope_theta)
        cache, ck, cv = cache.update(i, k, att.wv(y)[:b].reshape(b, hkv, hd),
                                     idx)
        o = _attend_cached(q, ck, cv, idx, hd ** -0.5)
        x = x + att.wo(_pad_rows(o.reshape(b, h * hd)))
        y = blk.norm_mlp(x)
        x = x + mlp.down(F.silu(mlp.gate(y)) * mlp.up(y))
    # Untied fp32 head.
    logits = (model.norm_f(x).float() @ model.lm_head.float().t())[:b]
    return (cache.layers if raw else cache), _head(model, logits)


def _refuse_split_t5(model) -> None:
    """T5's decode reshapes by ``cfg.num_heads`` and reads the whole bias
    table and head, so on a tensor-parallel part it would give wrong
    tokens without an error: refuse it."""
    if model.tp is not None:
        raise NotImplementedError(
            "T5 decode runs on a whole model; this one is tensor-parallel "
            "(mp.tensor_parallel holds 1/mp of its heads, bias columns and "
            "vocab rows a rank). Decode a whole T5 (tensor-parallel decode "
            "is implemented for gpt2/llama, mp.tp_decode_step)")


def t5_encode(model, cfg, src, src_mask):
    """The encoder (the training one: ``model(src, None, enc_mask=)``) and
    every decoder layer's cross-attention K and V, once a generation:
    [{"k", "v": (B, T_src, H, hd)}] in ``cfg.dtype``. A tensor-parallel
    model is refused."""
    _refuse_split_t5(model)
    h, hd = cfg.num_heads, cfg.head_dim
    t = src.shape[1]
    enc = model(src, None, enc_mask=src_mask)
    return [{"k": lyr.cross_attn.k(enc).reshape(-1, t, h, hd),
             "v": lyr.cross_attn.v(enc).reshape(-1, t, h, hd)}
            for lyr in model.dec]


def t5_decoder_bias(cfg, model, t_dec: int) -> torch.Tensor:
    """The (T_dec, H, T_dec) causal relative-position bias of the decoder's
    self-attention: row ``idx`` biases the query at ``idx``."""
    buckets = model.dec_rel.buckets(t_dec, t_dec)
    return model.dec_rel.rel_bias[buckets].permute(0, 2, 1)


def _t5_step(cfg, model, cache, cross, src_mask, dec_bias, tok, idx):
    """One decoder token against the self-attention cache and the fixed
    cross K and V (T5: no 1/sqrt(d) scale; the causal relative bias of row
    ``idx``; cross-attention unbiased, and zero on an all-pad source). A
    tensor-parallel model is refused."""
    _refuse_split_t5(model)
    cache, raw = _as_cache(cache)
    b, h, hd = tok.shape[0], cfg.num_heads, cfg.head_dim
    dt = cfg.dtype
    x = _pad_rows(model.embedding[tok].to(dt))
    live = src_mask.any(dim=-1)[:, None, None]
    for i, lyr in enumerate(model.dec):
        sa, ca, mlp = lyr.self_attn, lyr.cross_attn, lyr.mlp
        y = lyr.ln1(x)
        q = sa.q(y)[:b].reshape(b, h, hd)
        cache, ck, cv = cache.update(i, sa.k(y)[:b].reshape(b, h, hd),
                                     sa.v(y)[:b].reshape(b, h, hd), idx)
        bias = dec_bias[idx][None] if _is_scalar(idx) else dec_bias[idx]
        t = ck.shape[1]
        s = torch.einsum("bhd,bthd->bht", q, ck).float() + bias[..., :t]
        s = torch.where(_key_mask(t, idx, 1, x.device), s, _NEG_INF)
        a = torch.softmax(s, dim=-1).to(dt)
        o = torch.einsum("bht,bthd->bhd", a, cv)
        x = x + sa.o(_pad_rows(o.reshape(b, h * hd)))
        q = ca.q(lyr.ln2(x))[:b].reshape(b, h, hd)
        s = torch.einsum("bhd,bthd->bht", q, cross[i]["k"]).float()
        s = torch.where(src_mask[:, None, :], s, _NEG_INF)
        a = torch.softmax(s, dim=-1).to(dt)
        a = torch.where(live, a, torch.zeros((), dtype=dt, device=a.device))
        o = torch.einsum("bht,bthd->bhd", a, cross[i]["v"])
        x = x + ca.o(_pad_rows(o.reshape(b, h * hd)))
        y = lyr.ln3(x)
        x = x + mlp.wo(F.gelu(mlp.wi_0(y), approximate="tanh") * mlp.wi_1(y))
    logits = (model.dec_norm(x).float() @ model.lm_head.float().t())[:b]
    return (cache.layers if raw else cache), logits


# ---------------------------------------------------------------------------
# The decode-step registry: one step per family, shared by generate() and a
# serving engine.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DecodeFamily:
    """One family's decode surface: ``step(cfg, model, cache, tok, pos,
    extras=None)`` advances every row one token (``extras``: T5's
    ``{"cross", "src_mask", "dec_bias"}``), and the cache geometry."""

    name: str
    step: Callable[..., Tuple[Any, torch.Tensor]]
    num_layers: Callable[[Any], int]
    kv_heads: Callable[[Any], int]
    head_dim: Callable[[Any], int]
    validate: Callable[[Any], None]


def _reject_moe(cfg) -> None:
    if getattr(cfg, "num_experts", 0) > 0:
        raise NotImplementedError(
            "generate() does not decode MoE configs yet")


def _gpt2_entry(cfg, model, cache, tok, pos, extras=None):
    return _gpt2_step(cfg, model, cache, tok, pos)


def _llama_entry(cfg, model, cache, tok, pos, extras=None):
    return _llama_step(cfg, model, cache, tok, pos)


def _t5_entry(cfg, model, cache, tok, pos, extras=None):
    if extras is None:
        raise ValueError("the T5 decode step needs extras= with "
                         "{'cross', 'src_mask', 'dec_bias'}")
    return _t5_step(cfg, model, cache, extras["cross"], extras["src_mask"],
                    extras["dec_bias"], tok, pos)


_FAMILIES = {
    "GPT2Config": DecodeFamily(
        name="gpt2", step=_gpt2_entry,
        num_layers=lambda c: c.num_layers,
        kv_heads=lambda c: c.num_heads,
        head_dim=lambda c: c.d_model // c.num_heads,
        validate=_reject_moe),
    "LlamaConfig": DecodeFamily(
        name="llama", step=_llama_entry,
        num_layers=lambda c: c.num_layers,
        kv_heads=lambda c: c.num_kv_heads,
        head_dim=lambda c: c.d_model // c.num_heads,
        validate=_reject_moe),
    "T5Config": DecodeFamily(
        name="t5", step=_t5_entry,
        num_layers=lambda c: c.num_decoder_layers,
        kv_heads=lambda c: c.num_heads,
        head_dim=lambda c: c.head_dim,
        validate=lambda c: None),
}


def decode_family(cfg) -> DecodeFamily:
    """The :class:`DecodeFamily` of a model config (by config type)."""
    fam = _FAMILIES.get(type(cfg).__name__)
    if fam is None:
        raise TypeError(
            f"no decode family registered for {type(cfg).__name__}; "
            f"known: {sorted(_FAMILIES)}")
    return fam


def decode_step(cfg) -> Callable[..., Tuple[Any, torch.Tensor]]:
    """``(model, cache, tok, pos, extras=None) -> (cache, logits)``: the
    family's one-token step bound to ``cfg``, without autograd."""
    fam = decode_family(cfg)
    fam.validate(cfg)

    @torch.no_grad()
    def step(model, cache, tok, pos, extras=None):
        return fam.step(cfg, model, cache, tok, pos, extras)

    return step


def decode_verify_step(cfg) -> Callable[..., Tuple[Any, torch.Tensor,
                                                   torch.Tensor]]:
    """The K-token verify chain of speculative decode: ``(model, cache,
    tok_seq (K, B), pos0, counts=None, extras=None, mask_fn=None) ->
    (cache, the step-0 fp32 logits (B, V), greedy (K, B))``. Row 0 of
    ``tok_seq`` is the committed token, rows 1.. the drafts; ``greedy[j]``
    is :func:`greedy_token` after ``tok_seq[:j + 1]``, each lane advancing
    from its own ``pos0``. ``mask_fn(cache, lane)`` applies the lane mask
    ``j < counts`` before step j (a paged cache's trash block). With K = 1
    it is the one-token step."""
    fam = decode_family(cfg)
    fam.validate(cfg)

    @torch.no_grad()
    def verify(model, cache, tok_seq, pos0, counts=None, extras=None,
               mask_fn=None):
        pos0 = torch.as_tensor(pos0, dtype=torch.long,
                               device=tok_seq.device)
        first, greedy = None, []
        for j in range(tok_seq.shape[0]):
            if mask_fn is not None and counts is not None:
                cache = mask_fn(cache, j < counts)
            cache, logits = fam.step(cfg, model, cache, tok_seq[j],
                                     pos0 + j, extras)
            if first is None:
                first = logits.float()
            greedy.append(greedy_token(logits))
        return cache, first, torch.stack(greedy)

    return verify


def init_cache(cfg, batch: int, total_len: int, device=None):
    """The dense KV cache: one K and one V of (B, T, kv heads, head dim) a
    layer, in the compute dtype (a GQA cache stays at KV width)."""
    fam = decode_family(cfg)
    kv, hd = fam.kv_heads(cfg), fam.head_dim(cfg)
    return {i: {"k": torch.zeros((batch, total_len, kv, hd),
                                 dtype=cfg.dtype, device=device),
                "v": torch.zeros((batch, total_len, kv, hd),
                                 dtype=cfg.dtype, device=device)}
            for i in range(fam.num_layers(cfg))}


def _step_fn(model):
    from horovod_tpu_torch.models.gpt2 import GPT2
    from horovod_tpu_torch.models.llama import Llama
    if isinstance(model, Llama):
        fam = _FAMILIES["LlamaConfig"]
    elif isinstance(model, GPT2):
        fam = _FAMILIES["GPT2Config"]
    else:
        raise TypeError(f"generate() supports GPT2 and Llama models, got "
                        f"{type(model).__name__}")
    fam.validate(model.cfg)
    return fam, fam.kv_heads(model.cfg)


def greedy_token(logits: torch.Tensor, rel_tol: float = 1e-5
                 ) -> torch.Tensor:
    """Deterministic greedy pick: the LOWEST token id whose logit is within
    ``rel_tol * max(1, |top|)`` of the maximum, so two lowerings whose
    logits agree well inside the tolerance pick the same token."""
    m = logits.max(dim=-1, keepdim=True).values
    eps = rel_tol * m.abs().clamp_min(1.0)
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(logits >= m - eps, ids,
                       logits.shape[-1]).min(dim=-1).values


def _sample(logits, temperature, top_k, generator):
    if temperature == 0.0:
        return greedy_token(logits)
    logits = logits.float() / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= kth, logits, _NEG_INF)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0]


def _check_sampling(cfg, temperature, top_k, generator):
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs generator=")
    if top_k is not None and not 1 <= top_k <= cfg.vocab_size:
        raise ValueError(f"top_k must be in [1, vocab_size="
                         f"{cfg.vocab_size}], got {top_k}")


@torch.no_grad()
def t5_generate(model: Any, src: torch.Tensor, max_new_tokens: int, *,
                temperature: float = 0.0, top_k: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                eos_id: Optional[int] = None,
                src_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Seq2seq decode: (B, T_src) -> (B, max_new_tokens) target ids. The
    encoder and every layer's cross K and V run once; the decoder starts
    from the pad/start token with a cached self-attention. Sampling as
    :func:`generate`. A tensor-parallel T5 is refused (``t5_encode``)."""
    from horovod_tpu_torch.models.t5 import T5
    if not isinstance(model, T5):
        raise TypeError(f"t5_generate needs a T5 model, got "
                        f"{type(model).__name__}")
    cfg = model.cfg
    if max_new_tokens <= 0:
        raise ValueError(
            f"max_new_tokens must be > 0, got {max_new_tokens}")
    _check_sampling(cfg, temperature, top_k, generator)
    b = src.shape[0]
    if src_mask is None:
        src_mask = src != cfg.pad_id
    cross = t5_encode(model, cfg, src, src_mask)
    t_dec = int(max_new_tokens)
    dec_bias = t5_decoder_bias(cfg, model, t_dec)
    cache = init_cache(cfg, b, t_dec, device=src.device)
    tok = torch.full((b,), cfg.pad_id, dtype=torch.long, device=src.device)
    done = torch.zeros(b, dtype=torch.bool, device=src.device)
    out = []
    for t in range(t_dec):
        cache, logits = _t5_step(cfg, model, cache, cross, src_mask,
                                 dec_bias, tok, t)
        tok = _sample(logits, temperature, top_k, generator)
        if eos_id is not None:
            tok = torch.where(done, eos_id, tok)
            done = done | (tok == eos_id)
        out.append(tok)
    return torch.stack(out, dim=1)


@torch.no_grad()
def generate(model: Any, prompt: torch.Tensor, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             eos_id: Optional[int] = None) -> torch.Tensor:
    """(B, P) prompt -> (B, P + max_new_tokens) tokens of a GPT-2 or Llama.
    The prompt is teacher-forced through the cached decode step that
    samples the continuation; ``temperature=0`` is greedy; ``eos_id``
    freezes a row once it samples EOS (later positions repeat it)."""
    fam, _ = _step_fn(model)
    cfg = model.cfg
    b, p = prompt.shape
    if max_new_tokens < 0:
        raise ValueError(
            f"max_new_tokens must be >= 0, got {max_new_tokens}")
    total = p + int(max_new_tokens)
    if total > cfg.max_seq_len:
        raise ValueError(f"prompt {p} + {max_new_tokens} new tokens "
                         f"exceeds max_seq_len={cfg.max_seq_len}")
    _check_sampling(cfg, temperature, top_k, generator)
    cache = init_cache(cfg, b, total, device=prompt.device)
    prompt = prompt.long()
    tok = prompt[:, 0]
    done = torch.zeros(b, dtype=torch.bool, device=prompt.device)
    out = [tok]
    for t in range(total - 1):
        cache, logits = fam.step(cfg, model, cache, tok, t)
        if t + 1 < p:              # teacher-force inside the prompt
            tok = prompt[:, t + 1]
        else:
            tok = _sample(logits, temperature, top_k, generator)
            if eos_id is not None:
                tok = torch.where(done, eos_id, tok)
                done = done | (tok == eos_id)
        out.append(tok)
    return torch.stack(out, dim=1)
