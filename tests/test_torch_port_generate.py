"""horovod_tpu_torch KV-cache generation (``models/generate.py``) against the
reference's ``generate`` / ``t5_generate`` and against the port's own
training forward; the cases of ``tests/test_generate.py``.

Tiny models are initialised by the JAX package and carried to the port with
``convert.py``; prompts and sources are numpy-seeded. In fp32 the greedy
tokens must equal the reference's exactly (both pick with
``greedy_token``'s tolerance tie-break), and the decode logits must equal
the port's forward at every position within the fp32 logit tolerance of
the other port tests; in bf16 within the reference's own bound, atol 0.02
(``tests/test_generate.py``). Sampling draws from a ``torch.Generator``,
whose draws are not JAX's: it is held to being seeded and reproducible, and
to ``top_k=1`` being greedy, as the reference's tests hold it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import generate as jgen
from horovod_tpu.models.gpt2 import GPT2 as JGPT2
from horovod_tpu.models.gpt2 import GPT2Config as JGPT2Config
from horovod_tpu.models.llama import Llama as JLlama
from horovod_tpu.models.llama import LlamaConfig as JLlamaConfig
from horovod_tpu.models.t5 import T5 as JT5
from horovod_tpu.models.t5 import T5Config as JT5Config
from horovod_tpu.models.t5 import shift_right as jshift_right

from horovod_tpu_torch.models import generate as G
from horovod_tpu_torch.models.convert import gpt2_params_from_jax
from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config
from horovod_tpu_torch.models.llama import Llama, LlamaConfig
from horovod_tpu_torch.models.t5 import T5, T5Config

LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_LOGIT_ATOL = 0.02
P, NEW = 7, 9


def _prompt(seed=0, b=2, p=P):
    return np.random.default_rng(seed).integers(1, 256, (b, p)).astype(
        np.int32)


def _decoder(family, kv=None, dtype="fp32", **kw):
    """(JAX model, its numpy params, the port model with them)."""
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    if family == "gpt2":
        jm = JGPT2(JGPT2Config.tiny(dtype=jdt, **kw))
        pm = GPT2(GPT2Config.tiny(dtype=tdt, **kw))
    else:
        jm = JLlama(JLlamaConfig.tiny(num_kv_heads=kv, dtype=jdt, **kw))
        pm = Llama(LlamaConfig.tiny(num_kv_heads=kv, dtype=tdt, **kw))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.asarray(_prompt()))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    pm.load_state_dict(gpt2_params_from_jax(params), strict=True)
    return jm, params, pm


def _t5():
    src = _prompt(5, p=14)
    jm = JT5(JT5Config.tiny(dtype=jnp.float32))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(src),
                              jshift_right(jnp.asarray(src[:, :6]), 0))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    pm = T5(T5Config.tiny(dtype=torch.float32))
    pm.load_state_dict(gpt2_params_from_jax(params), strict=True)
    return jm, params, pm, src


@pytest.fixture(scope="module")
def gpt2_fp32():
    return _decoder("gpt2")


@pytest.fixture(scope="module")
def t5_fp32():
    return _t5()


@pytest.mark.parametrize("family,kv", [("gpt2", None), ("llama", 4),
                                       ("llama", 2)])
def test_greedy_tokens_equal_reference(gpt2_fp32, family, kv):
    jm, params, pm = gpt2_fp32 if family == "gpt2" else _decoder(family, kv)
    prompt = _prompt(1)
    want = np.asarray(jgen.generate(jm, params, jnp.asarray(prompt), NEW))
    got = G.generate(pm, torch.tensor(prompt), NEW)
    assert got.shape == (2, P + NEW)
    np.testing.assert_array_equal(got.numpy(), want)


def test_t5_greedy_tokens_equal_reference(t5_fp32):
    jm, params, pm, src = t5_fp32
    want = np.asarray(jgen.t5_generate(jm, params, jnp.asarray(src), 7))
    got = G.t5_generate(pm, torch.tensor(src), 7)
    np.testing.assert_array_equal(got.numpy(), want)


def _teacher_forced_logits(step, pm, cache, tokens, extras=None):
    out = []
    for t in range(tokens.shape[1]):
        cache, logits = step(pm, cache, tokens[:, t], t, extras)
        out.append(logits)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("family,kv,dtype",
                         [("gpt2", None, "fp32"), ("llama", 2, "fp32"),
                          ("gpt2", None, "bf16"), ("llama", 2, "bf16")])
def test_decode_logits_match_own_forward(family, kv, dtype):
    """Teacher-forcing a sequence through the cached step gives the
    training forward's logits at every position (dense attention)."""
    _, _, pm = _decoder(family, kv, dtype, attention="dense")
    tokens = torch.tensor(_prompt(2, p=20)).long()
    cache = G.init_cache(pm.cfg, 2, 20)
    dec = _teacher_forced_logits(G.decode_step(pm.cfg), pm, cache, tokens)
    with torch.no_grad():
        fwd = pm(tokens)
    if dtype == "fp32":
        np.testing.assert_allclose(dec.numpy(), fwd.numpy(), **LOGIT_TOL)
    else:
        np.testing.assert_allclose(dec.float().numpy(), fwd.float().numpy(),
                                   rtol=0, atol=BF16_LOGIT_ATOL)


def test_t5_decode_logits_match_own_forward(t5_fp32):
    _, _, pm, src = t5_fp32
    cfg = pm.cfg
    src_t = torch.tensor(src)
    src_t[1, -4:] = 0
    mask = src_t != 0
    dec_in = torch.tensor(_prompt(3, p=8)).long()
    dec_in[:, 0] = cfg.pad_id
    with torch.no_grad():
        extras = {"cross": G.t5_encode(pm, cfg, src_t, mask),
                  "src_mask": mask,
                  "dec_bias": G.t5_decoder_bias(cfg, pm, 8)}
        fwd = pm(src_t, dec_in)
    dec = _teacher_forced_logits(G.decode_step(cfg), pm,
                                 G.init_cache(cfg, 2, 8), dec_in, extras)
    np.testing.assert_allclose(dec.numpy(), fwd.numpy(), **LOGIT_TOL)


def test_gqa_cache_is_kv_width():
    cfg = LlamaConfig.tiny(num_kv_heads=2)
    cache = G.init_cache(cfg, 3, 11)
    assert len(cache) == cfg.num_layers
    assert cache[0]["k"].shape == (3, 11, 2, cfg.d_model // cfg.num_heads)
    assert cache[0]["v"].dtype == torch.bfloat16
    assert G._step_fn(Llama(LlamaConfig.tiny(num_kv_heads=2)))[1] == 2
    assert G.decode_family(T5Config.tiny()).num_layers(T5Config.tiny()) == 2


def test_verify_chain_equals_single_steps(gpt2_fp32):
    """``decode_verify_step`` over K tokens from per-row positions equals
    K one-token steps: the same cache, the step-0 logits, the greedy
    picks."""
    _, _, pm = gpt2_fp32
    cfg = pm.cfg
    tok_seq = torch.tensor(_prompt(4, b=2, p=4)).long().t()     # (K, B)
    pos0 = torch.tensor([0, 3])
    step = G.decode_step(cfg)
    ref_cache = G.init_cache(cfg, 2, 8)
    singles = []
    for j in range(4):
        ref_cache, logits = step(pm, ref_cache, tok_seq[j], pos0 + j)
        singles.append(logits)
    cache, first, greedy = G.decode_verify_step(cfg)(
        pm, G.init_cache(cfg, 2, 8), tok_seq, pos0)
    assert torch.equal(first, singles[0])
    assert torch.equal(greedy, torch.stack([G.greedy_token(x)
                                            for x in singles]))
    for i in cache:
        assert torch.equal(cache[i]["k"], ref_cache[i]["k"])


def test_greedy_token_breaks_ties_to_the_lowest_id():
    logits = torch.tensor([[1.0, 3.0, 3.0 - 1e-6, 2.0],
                           [5.0, 1.0, 5.0, 5.0 + 1e-4]])
    assert G.greedy_token(logits).tolist() == [1, 3]
    want = jgen.greedy_token(jnp.asarray(logits.numpy()))
    np.testing.assert_array_equal(G.greedy_token(logits).numpy(),
                                  np.asarray(want))


def test_sampling_seeded_varies_and_top_k_one_is_greedy(gpt2_fp32):
    _, _, pm = gpt2_fp32
    prompt = torch.tensor(_prompt(6, p=4))

    def sample(seed, **kw):
        return G.generate(pm, prompt, 12, temperature=1.0,
                          generator=torch.Generator().manual_seed(seed),
                          **kw)
    a, b, c = sample(1), sample(1), sample(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    greedy = G.generate(pm, prompt, 8)
    topk1 = G.generate(pm, prompt, 8, temperature=0.7, top_k=1,
                       generator=torch.Generator().manual_seed(3))
    assert torch.equal(greedy, topk1)


def test_eos_freezes_a_row(gpt2_fp32, t5_fp32):
    """EOS is a token the seeded run samples mid-row; the same draws with
    ``eos_id`` set repeat EOS in that row from its first hit on."""
    _, _, pm = gpt2_fp32
    _, _, t5, src = t5_fp32
    prompt = torch.tensor(_prompt(7, p=4))
    runs = [(lambda **kw: G.generate(pm, prompt, 16, **kw), 4),
            (lambda **kw: G.t5_generate(t5, torch.tensor(src), 12, **kw), 0)]
    for run, start in runs:
        def sample(**kw):
            return run(temperature=1.0, top_k=8,
                       generator=torch.Generator().manual_seed(0), **kw)
        free = sample()
        eos = int(free[0, start + 3])
        out = sample(eos_id=eos)[:, start:]
        for row in out:
            hits = torch.nonzero(row == eos)
            if len(hits):
                assert (row[hits[0, 0]:] == eos).all()
        assert (out[0, 3:] == eos).all()


def test_t5_padded_and_all_pad_sources(t5_fp32):
    _, _, pm, src = t5_fp32
    src_t = torch.tensor(src)
    padded = torch.cat([src_t, torch.zeros(2, 6, dtype=src_t.dtype)], 1)
    assert torch.equal(G.t5_generate(pm, src_t, 6),
                       G.t5_generate(pm, padded, 6))
    dead = src_t.clone()
    dead[0] = 0
    out = G.t5_generate(pm, dead, 5)
    assert out.shape == (2, 5) and ((out >= 0) & (out < 256)).all()
    assert torch.equal(out[1], G.t5_generate(pm, src_t, 5)[1])


def test_argument_errors_and_moe_rejection(gpt2_fp32, t5_fp32):
    _, _, pm = gpt2_fp32
    prompt = torch.tensor(_prompt(8, p=4))
    cases = [
        (dict(max_new_tokens=-3), "max_new_tokens"),
        (dict(max_new_tokens=10_000), "max_seq_len"),
        (dict(max_new_tokens=4, temperature=-1.0), "temperature"),
        (dict(max_new_tokens=4, temperature=0.5), "generator"),
        (dict(max_new_tokens=4, temperature=1.0, top_k=0,
              generator=torch.Generator()), "top_k"),
        (dict(max_new_tokens=4, temperature=1.0, top_k=10_000,
              generator=torch.Generator()), "top_k"),
    ]
    for kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            G.generate(pm, prompt, **kw)
    _, _, t5, src = t5_fp32
    with pytest.raises(ValueError, match="max_new_tokens"):
        G.t5_generate(t5, torch.tensor(src), 0)
    with pytest.raises(TypeError, match="needs a T5 model"):
        G.t5_generate(pm, prompt, 4)
    with pytest.raises(TypeError, match="supports GPT2 and Llama"):
        G.generate(t5, prompt, 4)
    with pytest.raises(TypeError, match="no decode family"):
        G.decode_family(object())
    with pytest.raises(ValueError, match="extras="):
        G.decode_step(t5.cfg)(t5, G.init_cache(t5.cfg, 2, 4),
                              prompt[:, 0], 0)
    moe = Llama(LlamaConfig.tiny(num_experts=4))
    with pytest.raises(NotImplementedError, match="MoE"):
        G.generate(moe, torch.zeros(1, 4, dtype=torch.long), 4)
    with pytest.raises(NotImplementedError, match="MoE"):
        G.decode_step(moe.cfg)
