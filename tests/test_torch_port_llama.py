"""horovod_tpu_torch Llama == horovod_tpu Llama: RoPE, logits, the loss,
every gradient and one data-parallel SGD step.

A tiny fp32 Llama with grouped-query attention (4 query heads over 2 KV
heads) is initialised by the JAX package; its parameters are carried to the
port with ``llama_params_from_jax``. The same numpy tokens go through both.
JAX runs on the 8-device CPU mesh of tests/conftest.py with flash attention
in Pallas interpret mode; the port runs its plain kernel versions on the
CPU. The optimizer step runs on a two-rank gloo world (half the batch each,
launched by the port's runner) against the reference's step with the batch
sharded over the mesh (the mean of the eight shards' mean losses is the
mean of the two halves'). The step is plain SGD, whose update is the
averaged gradient itself (Adam's first update is about ``lr * sign(g)``).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.models.llama import Llama as JLlama
from horovod_tpu.models.llama import LlamaConfig as JConfig
from horovod_tpu.models.llama import apply_rope as japply_rope
from horovod_tpu.models.llama import loss_fn as jloss_fn

from horovod_tpu_torch.models.convert import llama_params_from_jax
from horovod_tpu_torch.models.llama import (Llama, LlamaConfig, apply_rope,
                                            loss_fn)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fp32 on both sides; the two frameworks sum in different orders (as
# tests/test_torch_port_gpt2.py states them).
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
STEP_TOL = dict(rtol=0, atol=2e-5)
B, T = 8, 32
LR = 0.5


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, T)).astype(
        np.int32)


def _jcfg(attention="flash"):
    return JConfig.tiny(dtype=jnp.float32, attention=attention)


@pytest.fixture(scope="module")
def jax_params():
    params = JLlama(_jcfg()).init(jax.random.PRNGKey(0),
                                  jnp.asarray(_tokens()))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(params_np, attention):
    m = Llama(LlamaConfig.tiny(dtype=torch.float32, attention=attention),
              torch.Generator().manual_seed(1))
    m.load_state_dict(llama_params_from_jax(params_np), strict=True)
    return m


def test_config_fields_match_reference():
    jf = [f.name for f in dataclasses.fields(JConfig)]
    pf = [f.name for f in dataclasses.fields(LlamaConfig)]
    assert jf == pf
    for name in pf:
        if name != "dtype":
            for preset in ("llama7b", "small", "tiny"):
                assert getattr(getattr(JConfig, preset)(), name) == \
                    getattr(getattr(LlamaConfig, preset)(), name), name
    assert LlamaConfig.tiny().num_kv_heads < LlamaConfig.tiny().num_heads
    moe = Llama(LlamaConfig.tiny(num_experts=4))
    assert moe.h[0].mlp.moe.w_gate.shape == (4, 64, 128)
    with pytest.raises(ValueError, match="unknown router_type 'top3'"):
        Llama(LlamaConfig.tiny(num_experts=4, moe_router="top3"))
    with pytest.raises(ValueError, match="must divide"):
        Llama(LlamaConfig.tiny(num_kv_heads=3))


def test_converted_state_dict_covers_every_parameter(jax_params):
    sd = llama_params_from_jax(jax_params)
    m = Llama(LlamaConfig.tiny(dtype=torch.float32))
    assert set(sd) == set(m.state_dict())
    np.testing.assert_array_equal(sd["h.1.attn.wk.weight"].numpy(),
                                  jax_params["h1"]["attn"]["wk"]["kernel"].T)
    np.testing.assert_array_equal(sd["lm_head"].numpy(),
                                  jax_params["lm_head"])


@pytest.mark.parametrize("positions", ["shared", "per_row"])
def test_rope_matches_reference(positions):
    g = np.random.default_rng(5)
    x = g.standard_normal((2, 6, 3, 8)).astype(np.float32)
    pos = (np.arange(6) if positions == "shared"
           else g.integers(0, 50, (2, 6))).astype(np.int32)
    want = japply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = apply_rope(torch.tensor(x), torch.tensor(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_logits_and_loss_match(jax_params, attention):
    tokens = _tokens()
    jl = JLlama(_jcfg(attention)).apply({"params": jax_params},
                                        jnp.asarray(tokens))
    tt = torch.tensor(tokens)
    pl = _port_model(jax_params, attention)(tt)
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl),
                               **LOGIT_TOL)
    np.testing.assert_allclose(loss_fn(pl, tt).item(),
                               float(jloss_fn(jl, jnp.asarray(tokens))),
                               rtol=1e-5)


def test_packed_segments_match(jax_params):
    tokens = _tokens(2)
    seg = np.sort(np.random.default_rng(3).integers(0, 3, (B, T)),
                  axis=1).astype(np.int32)
    jl = JLlama(_jcfg()).apply({"params": jax_params}, jnp.asarray(tokens),
                               segment_ids=jnp.asarray(seg))
    pl = _port_model(jax_params, "flash")(torch.tensor(tokens),
                                          segment_ids=torch.tensor(seg))
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl),
                               **LOGIT_TOL)


def test_every_gradient_matches(jax_params):
    tokens = _tokens(1)
    jm = JLlama(_jcfg())
    jgrads = jax.grad(lambda p: jloss_fn(
        jm.apply({"params": p}, jnp.asarray(tokens)),
        jnp.asarray(tokens)))(jax_params)
    want = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    m = _port_model(jax_params, "flash")
    tt = torch.tensor(tokens)
    loss_fn(m(tt), tt).backward()
    got = {n: p.grad for n, p in m.named_parameters()}
    assert set(got) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.fixture(scope="module")
def jax_step(jax_params):
    """Params after one JAX ``DistributedOptimizer(optax.sgd(LR))`` step
    with the batch sharded over the 8-device mesh."""
    tokens = jnp.asarray(_tokens(4))
    jm = JLlama(_jcfg())
    opt = jhvd.DistributedOptimizer(optax.sgd(LR))
    params = jax.tree_util.tree_map(jnp.asarray, jax_params)
    state = opt.init(params)

    def step(p, s, tok):
        g = jax.grad(lambda p: jloss_fn(jm.apply({"params": p}, tok),
                                        tok))(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s

    new, _ = jhvd.spmd(step, in_specs=(P(), P(), P("hvd")),
                       out_specs=(P(), P()))(params, state, tokens)
    return llama_params_from_jax(jax.tree_util.tree_map(np.asarray, new))


_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig, loss_fn

    hvd.init(device="cpu")
    data = np.load(sys.argv[2])
    m = Llama(LlamaConfig.tiny(dtype=torch.float32, attention="flash"),
              torch.Generator().manual_seed(100 + hvd.rank()))  # differ ...
    if hvd.rank() == 0:                       # ... until the broadcast
        m.load_state_dict({k[2:]: torch.tensor(data[k]) for k in data.files
                           if k.startswith("p:")})
    hvd.broadcast_parameters(m.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=float(sys.argv[4])))
    half = data["tokens"].shape[0] // hvd.size()
    tok = torch.tensor(data["tokens"][hvd.rank() * half:
                                      (hvd.rank() + 1) * half])
    opt.zero_grad()
    loss_fn(m(tok), tok).backward()
    opt.step()
    np.savez(sys.argv[3] + f".rank{hvd.rank()}.npz",
             **{n: p.detach().numpy() for n, p in m.named_parameters()})
    hvd.shutdown()
""")


def test_one_step_two_gloo_ranks_matches_jax(tmp_path, jax_params,
                                             jax_step):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    data = tmp_path / "data.npz"
    sd = llama_params_from_jax(jax_params)
    np.savez(data, tokens=_tokens(4),
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
    assert set(ranks[0]) == set(jax_step)
    for name in sorted(jax_step):
        np.testing.assert_allclose(ranks[0][name], jax_step[name].numpy(),
                                   err_msg=name, **STEP_TOL)
