"""Rematerialization in the port (``horovod_tpu_torch/utils/remat.py``)
against the port without it and against the JAX package with it.

For GPT-2, Llama, BERT and T5 under ``remat_policy`` "full" and "dots": the
loss and every gradient equal the same port model without remat bit for bit
on the CPU (the recompute runs the same ops on the same inputs), and equal
the JAX model with the same remat (``nn.remat``, with
``dots_with_no_batch_dims_saveable`` for "dots") within the fp32 tolerances
of the other port tests, parameters carried over by ``convert.py``. The
parity runs use dense attention (JAX's flash runs in Pallas interpret mode
and remat does not touch the attention's arithmetic); the bit-for-bit runs
use flash, whose forward must run twice a layer under remat. The "dots"
policy must save the outputs of ``aten.mm`` / ``aten.addmm`` and nothing
else, and the MoE experts' products must reach ``aten.bmm``.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models.bert import Bert as JBert
from horovod_tpu.models.bert import BertConfig as JBertConfig
from horovod_tpu.models.bert import mlm_loss as jmlm_loss
from horovod_tpu.models.gpt2 import GPT2 as JGPT2
from horovod_tpu.models.gpt2 import GPT2Config as JGPT2Config
from horovod_tpu.models.gpt2 import loss_fn as jloss_fn
from horovod_tpu.models.llama import Llama as JLlama
from horovod_tpu.models.llama import LlamaConfig as JLlamaConfig
from horovod_tpu.models.t5 import T5 as JT5
from horovod_tpu.models.t5 import T5Config as JT5Config
from horovod_tpu.models.t5 import seq2seq_loss as jseq2seq_loss
from horovod_tpu.models.t5 import shift_right as jshift_right

from horovod_tpu_torch.models.bert import Bert, BertConfig, mlm_loss
from horovod_tpu_torch.models.convert import gpt2_params_from_jax
from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config, loss_fn
from horovod_tpu_torch.models.llama import Llama, LlamaConfig
from horovod_tpu_torch.models.t5 import T5, T5Config, seq2seq_loss
fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
from horovod_tpu_torch.utils import remat as R

# fp32 on both sides; the two frameworks sum in different orders (as
# tests/test_torch_port_gpt2.py states them).
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
B, T = 4, 16
POLICIES = ("full", "dots")


def _inputs(seed=0):
    g = np.random.default_rng(seed)
    tokens = g.integers(1, 256, (B, T)).astype(np.int32)
    mask = np.ones((B, T), bool)
    mask[1, -5:] = False
    mpos = (g.random((B, T)) < 0.3).astype(np.float32)
    labels = g.integers(1, 256, (B, 10)).astype(np.int32)
    labels[2, -3:] = 0                        # padded targets
    return tokens, mask, mpos, labels


def _family(name, remat, policy, attention="dense"):
    """(JAX model, port model, JAX loss(params), port loss(model))."""
    tokens, mask, mpos, labels = _inputs()
    kw = dict(remat=remat, remat_policy=policy)
    jt, tt = jnp.asarray(tokens), torch.tensor(tokens)
    if name in ("gpt2", "llama"):
        jcls, jcfg, pcls, pcfg = {
            "gpt2": (JGPT2, JGPT2Config, GPT2, GPT2Config),
            "llama": (JLlama, JLlamaConfig, Llama, LlamaConfig)}[name]
        jm = jcls(jcfg.tiny(dtype=jnp.float32, attention=attention, **kw))
        pm = pcls(pcfg.tiny(dtype=torch.float32, attention=attention, **kw))
        return (jm, pm, lambda p: jloss_fn(jm.apply({"params": p}, jt), jt),
                lambda m: loss_fn(m(tt), tt))
    if name == "bert":
        jm = JBert(dataclasses.replace(JBertConfig.tiny(), dtype=jnp.float32,
                                       attention=attention, **kw))
        pm = Bert(BertConfig.tiny(dtype=torch.float32, attention=attention,
                                  **kw))

        def jloss(p):
            mlm, nsp = jm.apply({"params": p}, jt, None, jnp.asarray(mask))
            return jmlm_loss(mlm, jt, jnp.asarray(mpos)) \
                + 0.1 * (nsp ** 2).mean()

        def ploss(m):
            mlm, nsp = m(tt, attention_mask=torch.tensor(mask))
            return mlm_loss(mlm, tt, torch.tensor(mpos)) \
                + 0.1 * (nsp ** 2).mean()
        return jm, pm, jloss, ploss
    jm = JT5(JT5Config.tiny(dtype=jnp.float32, **kw))
    pm = T5(T5Config.tiny(dtype=torch.float32, **kw))
    src = tokens.copy()
    src[3, -6:] = 0                           # a padded source row
    jl, tl = jnp.asarray(labels), torch.tensor(labels)
    return (jm, pm,
            lambda p: jseq2seq_loss(jm, p, jnp.asarray(src), jl),
            lambda m: seq2seq_loss(m, torch.tensor(src), tl))


@pytest.fixture(scope="module")
def jax_params():
    """Each family's reference parameters (numpy), initialised once."""
    tokens, _, _, labels = _inputs()
    out = {}
    for name in ("gpt2", "llama", "bert", "t5"):
        jm = _family(name, False, "full")[0]
        args = ((jnp.asarray(tokens), jshift_right(jnp.asarray(labels), 0))
                if name == "t5" else (jnp.asarray(tokens),))
        out[name] = jax.tree_util.tree_map(
            np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0),
                                         *args)["params"])
    return out


def _port_grads(pm, ploss, params):
    pm.load_state_dict(gpt2_params_from_jax(params), strict=True)
    loss = ploss(pm)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in pm.named_parameters()}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ["gpt2", "llama", "bert", "t5"])
def test_remat_matches_no_remat_and_reference(jax_params, name, policy):
    params = jax_params[name]
    jm, pm, jloss, ploss = _family(name, True, policy)
    loss, grads = _port_grads(pm, ploss, params)
    _, plain, _, ploss_plain = _family(name, False, "full")
    want_loss, want = _port_grads(plain, ploss_plain, params)
    assert torch.equal(loss, want_loss)
    for n in want:
        assert torch.equal(grads[n], want[n]), n
    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree_util.tree_map(jnp.asarray, params))
    ref = gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert set(ref) == set(grads)
    for n in sorted(ref):
        np.testing.assert_allclose(grads[n].numpy(), ref[n].numpy(),
                                   err_msg=n, **GRAD_TOL)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ["gpt2", "llama", "bert"])
def test_flash_forward_runs_twice_a_layer_bit_for_bit(monkeypatch, name,
                                                      policy):
    """The flash path under remat: loss and gradients bit for bit against
    no remat, with the plain forward run once in the forward and once in
    the recompute of each layer, the two backward passes once a layer."""
    counts = {}
    for fn in ("flash_fwd_plain", "flash_bwd_dq_plain",
               "flash_bwd_dkv_plain"):
        orig = getattr(fa, fn)

        def counted(*a, _orig=orig, _fn=fn, **k):
            counts[_fn] = counts.get(_fn, 0) + 1
            return _orig(*a, **k)
        monkeypatch.setattr(fa, fn, counted)
    runs = {}
    for remat in (False, True):
        counts.clear()
        # Both built from the default seed: the same weights.
        _, pm, _, ploss = _family(name, remat, policy, attention="flash")
        loss = ploss(pm)
        loss.backward()
        runs[remat] = (loss, {n: p.grad for n, p in pm.named_parameters()},
                       dict(counts))
    layers = pm.cfg.num_layers
    assert runs[False][2] == {"flash_fwd_plain": layers,
                              "flash_bwd_dq_plain": layers,
                              "flash_bwd_dkv_plain": layers}
    assert runs[True][2] == {"flash_fwd_plain": 2 * layers,
                             "flash_bwd_dq_plain": layers,
                             "flash_bwd_dkv_plain": layers}
    assert torch.equal(runs[True][0], runs[False][0])
    for n, g in runs[False][1].items():
        assert torch.equal(runs[True][1][n], g), n


def _saved_and_seen(monkeypatch, model, run):
    """The ops the "dots" policy saved and every op it was asked about,
    over one forward and backward of ``run(model)``."""
    saved, seen = [], set()
    policy = R.dots_policy

    def recording(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if ctx.is_recompute:
            return decision
        seen.add(op)
        if decision == R.CheckpointPolicy.MUST_SAVE:
            saved.append(op)
        return decision
    monkeypatch.setattr(R, "dots_policy", recording)
    run(model).backward()
    return saved, seen


def test_dots_saves_exactly_mm_and_addmm(monkeypatch):
    """GPT-2: each Dense reaches ``addmm`` (qkv, out, fc, proj: four a
    layer), the attention's einsums ``bmm``; only the four are saved."""
    m = GPT2(GPT2Config.tiny(dtype=torch.float32, remat=True,
                             remat_policy="dots"))
    tt = torch.tensor(_inputs()[0])
    saved, seen = _saved_and_seen(monkeypatch, m,
                                  lambda m: loss_fn(m(tt), tt))
    aten = torch.ops.aten
    assert saved == [aten.addmm.default] * 4 * m.cfg.num_layers
    assert aten.bmm.default in seen
    assert R.SAVED_OPS == {aten.mm.default, aten.addmm.default}


def test_dots_saves_moe_dispatch_and_combine_not_experts(monkeypatch):
    """Mixtral-style Llama: the bias-free projections (wq, wk, wv, wo), the
    router and the dispatch and combine products reach ``mm`` and are saved
    (seven a layer); the experts' products reach ``bmm`` and are not."""
    m = Llama(LlamaConfig.tiny(dtype=torch.float32, num_experts=4,
                               remat=True, remat_policy="dots"))
    tt = torch.tensor(_inputs()[0])
    from horovod_tpu_torch.models.llama import loss_fn_moe
    saved, seen = _saved_and_seen(monkeypatch, m,
                                  lambda m: loss_fn_moe(m, tt))
    aten = torch.ops.aten
    assert saved == [aten.mm.default] * 7 * m.cfg.num_layers
    assert aten.bmm.default in seen


@pytest.mark.parametrize("name", ["gpt2", "llama", "bert", "t5"])
def test_unknown_policy_raises_as_reference(jax_params, name):
    """The reference raises when the model is applied, the port when it is
    built; the same error. Without remat the policy is not read."""
    msg = "unknown remat_policy 'all': expected 'full' or 'dots'"
    with pytest.raises(ValueError, match=msg):
        _family(name, True, "all")
    jcfg = dataclasses.replace(_family(name, False, "full")[0].cfg,
                               remat=True, remat_policy="all")
    with pytest.raises(ValueError, match=msg):
        _jax_loss_with_cfg(name, jcfg, jax_params[name])
    _family(name, False, "all")


def _jax_loss_with_cfg(name, jcfg, params):
    tokens, mask, _, labels = _inputs()
    jt = jnp.asarray(tokens)
    model = {"gpt2": JGPT2, "llama": JLlama, "bert": JBert, "t5": JT5}[name]
    if name == "t5":
        return model(jcfg).apply({"params": params}, jt,
                                 jshift_right(jnp.asarray(labels), 0))
    return model(jcfg).apply({"params": params}, jt)
