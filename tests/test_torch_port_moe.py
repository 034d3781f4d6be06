"""horovod_tpu_torch MoE == horovod_tpu MoE: both routers' dispatch, combine
and aux loss, ``MoEMLP`` with GELU and SwiGLU experts, tiny MoE GPT-2 and
Llama with ``loss_fn_moe``, and one data-parallel step.

The reference's flax modules are initialised by JAX; their parameters are
carried to the port with ``convert.py`` (the MoE leaves keep their layout).
The same numpy inputs go through both, in fp32 on the CPU. Dispatch is a
one-hot tensor and must be equal exactly, so the same tokens are dropped
over capacity; everything else holds the fp32 tolerances of the other port
tests. The step runs on a two-rank gloo world (half the batch each, plain
SGD, ``op=Average``), against the reference's gradients of each half
averaged: routing capacity and the aux loss depend on the tokens a rank
sees, so the reference's step is taken on the same two halves.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models.gpt2 import GPT2 as JGPT2
from horovod_tpu.models.gpt2 import GPT2Config as JGPT2Config
from horovod_tpu.models.gpt2 import loss_fn_moe as jloss_fn_moe
from horovod_tpu.models.llama import Llama as JLlama
from horovod_tpu.models.llama import LlamaConfig as JLlamaConfig
from horovod_tpu.ops import moe as jmoe

from horovod_tpu_torch.models.convert import (gpt2_params_from_jax,
                                              llama_params_from_jax)
from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config, loss_fn_moe
from horovod_tpu_torch.models.llama import Llama, LlamaConfig
from horovod_tpu_torch.models.llama import loss_fn_moe as llama_loss_moe
from horovod_tpu_torch.ops import moe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fp32 on both sides; the two frameworks sum in different orders (as
# tests/test_torch_port_gpt2.py states them).
OUT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
STEP_TOL = dict(rtol=0, atol=2e-5)
B, T = 4, 16
LR = 0.5
N, D, E = 64, 16, 4


def _x(seed=0, shape=(N, D)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, T)).astype(
        np.int32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("cf", [2.0, 0.5], ids=["ample", "over_capacity"])
@pytest.mark.parametrize("router", ["top1", "top2"])
def test_router_matches_reference(router, cf):
    x = _x(1)
    jcls = jmoe.Top1Router if router == "top1" else jmoe.Top2Router
    jr = jcls(num_experts=E, capacity_factor=cf)
    params = jr.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jd, jc, ja = jr.apply(params, jnp.asarray(x))
    pcls = moe.Top1Router if router == "top1" else moe.Top2Router
    pr = pcls(D, E, cf)
    pr.load_state_dict({"router": torch.tensor(
        np.asarray(params["params"]["router"]))})
    pd, pc, pa = pr(torch.tensor(x))
    assert pd.shape == jd.shape == (N, E, pr.capacity(N))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_allclose(pc.detach().numpy(), np.asarray(jc),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pa.item(), float(ja), rtol=1e-6)
    k = 1 if router == "top1" else 2
    kept = pd.numpy().sum()
    if cf < 1:                  # the same tokens were dropped on both sides
        assert kept < k * N
    else:
        assert kept == k * N


def test_load_balance_loss_matches_reference():
    probs = torch.softmax(torch.tensor(_x(2, (N, E))), dim=-1)
    idx = probs.argmax(-1)
    want = jmoe.switch_load_balance_loss(jnp.asarray(probs.numpy()),
                                         jnp.asarray(idx.numpy()))
    np.testing.assert_allclose(
        moe.switch_load_balance_loss(probs, idx).item(), float(want),
        rtol=1e-6)
    uniform = torch.full((N, E), 1.0 / E)
    assert abs(moe.switch_load_balance_loss(
        uniform, torch.arange(N) % E).item() - 1.0) < 1e-6


@pytest.mark.parametrize("activation,router",
                         [("gelu", "top1"), ("gelu", "top2"),
                          ("swiglu", "top2"), ("swiglu", "top1")])
def test_moe_mlp_output_and_gradients_match(activation, router):
    x = _x(3, (B, T, D))
    jl = jmoe.MoEMLP(num_experts=E, d_ff=32, capacity_factor=1.0,
                     dtype=jnp.float32, router_type=router,
                     activation=activation)
    params = jax.jit(jl.init)(jax.random.PRNGKey(0),
                              jnp.asarray(x))["params"]
    if activation == "gelu":        # nonzero biases, so their path shows
        params["b_in"] = jnp.asarray(_x(4, (E, 32)) * 0.1)
        params["b_out"] = jnp.asarray(_x(5, (E, D)) * 0.1)

    def jloss(p, xx):
        out, aux = jl.apply({"params": p}, xx)
        return jnp.mean(out ** 2) + 1e-2 * aux, (out, aux)

    (jv, (jout, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    pl = moe.MoEMLP(D, E, 32, 1.0, torch.float32, router_type=router,
                    activation=activation)
    pl.load_state_dict(gpt2_params_from_jax(_np(params)), strict=True)
    xt = torch.tensor(x, requires_grad=True)
    out, aux = pl(xt)
    loss = (out ** 2).mean() + 1e-2 * aux
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **OUT_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(loss.item(), float(jv), rtol=1e-5)
    want = gpt2_params_from_jax(_np(jg))
    got = {n: p.grad for n, p in pl.named_parameters()}
    assert set(got) == set(want)
    for n in sorted(want):
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   err_msg=n, **GRAD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **GRAD_TOL)


def test_dropped_tokens_come_back_as_zeros():
    """At one slot an expert (cf tiny) nearly every token is dropped: its
    output row is exactly 0, as in the reference."""
    x = _x(6, (1, N, D))
    pl = moe.MoEMLP(D, E, 32, 1e-3, torch.float32)
    pl.reset_parameters(torch.Generator().manual_seed(0))
    out, _ = pl(torch.tensor(x))
    kept = pl.router(torch.tensor(x[0]))[0].sum(dim=(1, 2)) > 0
    assert 0 < int(kept.sum()) <= E      # one slot an expert
    assert (out[0][~kept] == 0).all() and (out[0][kept] != 0).any()


def _families():
    return {
        "gpt2": (JGPT2, JGPT2Config, GPT2, GPT2Config, loss_fn_moe,
                 gpt2_params_from_jax),
        "llama": (JLlama, JLlamaConfig, Llama, LlamaConfig, llama_loss_moe,
                  llama_params_from_jax)}


@pytest.fixture(scope="module")
def jax_models():
    out = {}
    for name, (jcls, jcfg, *_rest) in _families().items():
        jm = jcls(jcfg.tiny(dtype=jnp.float32, num_experts=4,
                            expert_capacity_factor=1.0))
        params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(_tokens()))["params"]
        out[name] = (jm, _np(params))
    return out


def _port(name, params):
    _, _, pcls, pcfg, _, convert = _families()[name]
    m = pcls(pcfg.tiny(dtype=torch.float32, num_experts=4,
                       expert_capacity_factor=1.0))
    m.load_state_dict(convert(params), strict=True)
    return m


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_tiny_moe_model_logits_loss_and_gradients_match(jax_models, name):
    jm, params = jax_models[name]
    tokens = _tokens(1)
    jt = jnp.asarray(tokens)
    jlogits, state = jax.jit(lambda p: jm.apply(
        {"params": p}, jt, mutable=["losses"]))(params)
    jaux = np.asarray(jnp.stack(jax.tree_util.tree_leaves(state["losses"])))
    jv, jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn_moe(jm, p, jt)))(params)
    m = _port(name, params)
    tt = torch.tensor(tokens)
    logits, aux = m(tt, return_aux=True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **OUT_TOL)
    np.testing.assert_allclose(aux.detach().numpy(), jaux, rtol=1e-5)
    loss = _families()[name][4](m, tt)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), rtol=1e-5)
    want = gpt2_params_from_jax(_np(jg))
    got = {n: p.grad for n, p in m.named_parameters()}
    assert set(got) == set(want)
    assert any(".moe." in n for n in got)
    for n in sorted(want):
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   err_msg=n, **GRAD_TOL)


def test_loss_fn_moe_and_router_errors_as_reference():
    tt = torch.tensor(_tokens())
    with pytest.raises(ValueError, match="loss_fn_moe needs an MoE config"):
        loss_fn_moe(GPT2(GPT2Config.tiny(dtype=torch.float32)), tt)
    msg = "unknown router_type 'top3'"
    with pytest.raises(ValueError, match=msg):
        GPT2(GPT2Config.tiny(num_experts=4, moe_router="top3"))
    with pytest.raises(ValueError, match=msg):
        Llama(LlamaConfig.tiny(num_experts=4, moe_router="top3"))
    jm = JLlama(JLlamaConfig.tiny(num_experts=4, moe_router="top3"))
    with pytest.raises(ValueError, match=msg):
        jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(_tokens()))
    with pytest.raises(ValueError, match="unknown activation 'relu'"):
        moe.MoEMLP(D, E, 32, activation="relu")


_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.llama import (Llama, LlamaConfig,
                                                loss_fn_moe)

    hvd.init(device="cpu")
    data = np.load(sys.argv[2])
    m = Llama(LlamaConfig.tiny(dtype=torch.float32, num_experts=4,
                               expert_capacity_factor=1.0),
              torch.Generator().manual_seed(100 + hvd.rank()))
    if hvd.rank() == 0:
        m.load_state_dict({k[2:]: torch.tensor(data[k]) for k in data.files
                           if k.startswith("p:")})
    hvd.broadcast_parameters(m.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=float(sys.argv[4])))
    half = data["tokens"].shape[0] // hvd.size()
    tok = torch.tensor(data["tokens"][hvd.rank() * half:
                                      (hvd.rank() + 1) * half])
    opt.zero_grad()
    loss_fn_moe(m, tok).backward()
    opt.step()
    np.savez(sys.argv[3] + f".rank{hvd.rank()}.npz",
             **{n: p.detach().numpy() for n, p in m.named_parameters()})
    hvd.shutdown()
""")


def test_one_step_two_gloo_ranks_matches_reference(tmp_path, jax_models):
    jm, params = jax_models["llama"]
    tokens = _tokens(4)
    grad = jax.jit(jax.grad(lambda p, t: jloss_fn_moe(jm, p, t)))
    halves = [grad(params, jnp.asarray(tokens[i * B // 2:(i + 1) * B // 2]))
              for i in range(2)]
    want = gpt2_params_from_jax(_np(jax.tree_util.tree_map(
        lambda p, a, b: p - LR * (a + b) / 2, params, *halves)))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    data = tmp_path / "data.npz"
    sd = llama_params_from_jax(params)
    np.savez(data, tokens=tokens,
             **{f"p:{k}": v.numpy() for k, v in sd.items()})
    out = tmp_path / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--timeout", "240", str(script), REPO, str(data), str(out),
         str(LR)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ranks = [dict(np.load(f"{out}.rank{i}.npz")) for i in range(2)]
    for name in ranks[0]:        # every rank took the same step
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name])
    assert set(ranks[0]) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(ranks[0][name], want[name].numpy(),
                                   err_msg=name, **STEP_TOL)
