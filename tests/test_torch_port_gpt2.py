"""horovod_tpu_torch GPT-2 == horovod_tpu GPT-2, forward, gradients and one
data-parallel AdamW step.

A tiny fp32 GPT-2 is initialised by the JAX package; its parameters are
carried to the port with ``gpt2_params_from_jax``. The same numpy tokens go
through both. JAX runs on the 8-device CPU mesh of tests/conftest.py with
flash attention in Pallas interpret mode; the port runs its plain versions
on the CPU. The optimizer step runs on a one-process port world and on a
two-rank gloo world (half the batch each, launched by the port's runner).
"""

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
from horovod_tpu.models.gpt2 import GPT2 as JGPT2
from horovod_tpu.models.gpt2 import GPT2Config as JConfig
from horovod_tpu.models.gpt2 import loss_fn as jloss_fn

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.convert import gpt2_params_from_jax
from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config, loss_fn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fp32 on both sides; the two frameworks sum in different orders.
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
B, T = 8, 32


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, T)).astype(
        np.int32)


@pytest.fixture(scope="module")
def jax_params():
    cfg = JConfig.tiny(dtype=jnp.float32, attention="flash")
    params = JGPT2(cfg).init(jax.random.PRNGKey(0),
                             jnp.asarray(_tokens()))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(params_np, attention):
    m = GPT2(GPT2Config.tiny(dtype=torch.float32, attention=attention),
             torch.Generator().manual_seed(1))
    m.load_state_dict(gpt2_params_from_jax(params_np), strict=True)
    return m


def test_config_fields_match_reference():
    import dataclasses
    jf = [f.name for f in dataclasses.fields(JConfig)]
    pf = [f.name for f in dataclasses.fields(GPT2Config)]
    assert jf == pf
    for name in ("vocab_size", "max_seq_len", "num_layers", "num_heads",
                 "d_model", "ln_eps", "attention"):
        assert getattr(JConfig.medium(), name) == \
            getattr(GPT2Config.medium(), name)
        assert getattr(JConfig.tiny(), name) == \
            getattr(GPT2Config.tiny(), name)


@pytest.mark.parametrize("kw", [{}, {"num_layers": 3, "d_model": 96,
                                     "num_heads": 6, "vocab_size": 512}])
def test_get_model_gpt2_builds_the_reference_config(kw):
    """``get_model("gpt2", **kw)`` builds ``GPT2(GPT2Config(**kw))`` as the
    reference's ``get_model`` does (``horovod_tpu/models/__init__.py``)."""
    from horovod_tpu.models import get_model as jget_model

    from horovod_tpu_torch.models import get_model
    with torch.device("meta"):
        m = get_model("gpt2", **kw)
    want = jget_model("gpt2", **kw).cfg
    assert isinstance(m, GPT2)
    for name in ("vocab_size", "max_seq_len", "num_layers", "num_heads",
                 "d_model", "ln_eps", "attention", "remat", "num_experts"):
        assert getattr(m.cfg, name) == getattr(want, name), name


def test_converted_state_dict_covers_every_parameter(jax_params):
    sd = gpt2_params_from_jax(jax_params)
    m = GPT2(GPT2Config.tiny(dtype=torch.float32))
    assert set(sd) == set(m.state_dict())
    # flax Dense kernels are (in, out); the port stores (out, in).
    np.testing.assert_array_equal(
        sd["h.0.attn.qkv.weight"].numpy(),
        jax_params["h0"]["attn"]["qkv"]["kernel"].T)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_logits_and_loss_match(jax_params, attention):
    tokens = _tokens()
    jm = JGPT2(JConfig.tiny(dtype=jnp.float32, attention=attention))
    jl = jm.apply({"params": jax_params}, jnp.asarray(tokens))
    m = _port_model(jax_params, attention)
    tt = torch.tensor(tokens)
    pl = m(tt)
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl),
                               **LOGIT_TOL)
    np.testing.assert_allclose(loss_fn(pl, tt).item(),
                               float(jloss_fn(jl, jnp.asarray(tokens))),
                               rtol=1e-5)


def test_every_gradient_matches(jax_params):
    tokens = _tokens(1)
    jm = JGPT2(JConfig.tiny(dtype=jnp.float32, attention="flash"))
    jgrads = jax.grad(lambda p: jloss_fn(
        jm.apply({"params": p}, jnp.asarray(tokens)),
        jnp.asarray(tokens)))(jax_params)
    want = gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    m = _port_model(jax_params, "flash")
    tt = torch.tensor(tokens)
    loss_fn(m(tt), tt).backward()
    got = {n: p.grad for n, p in m.named_parameters()}
    assert set(got) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_packed_segments_match(jax_params):
    tokens = _tokens(2)
    seg = np.sort(np.random.default_rng(3).integers(0, 3, (B, T)),
                  axis=1).astype(np.int32)
    jm = JGPT2(JConfig.tiny(dtype=jnp.float32, attention="flash"))
    jl = jm.apply({"params": jax_params}, jnp.asarray(tokens),
                  segment_ids=jnp.asarray(seg))
    m = _port_model(jax_params, "flash")
    pl = m(torch.tensor(tokens), segment_ids=torch.tensor(seg))
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl),
                               **LOGIT_TOL)
    np.testing.assert_allclose(
        loss_fn(pl, torch.tensor(tokens), torch.tensor(seg)).item(),
        float(jloss_fn(jl, jnp.asarray(tokens), jnp.asarray(seg))),
        rtol=1e-5)


# ------------------------------------------------- one DistributedOptimizer step

@pytest.fixture(scope="module")
def jax_step(jax_params):
    """Params after one JAX hvd.DistributedOptimizer(optax.adamw(1e-4))
    step with the batch sharded over the 8-device mesh."""
    tokens = jnp.asarray(_tokens(4))
    jm = JGPT2(JConfig.tiny(dtype=jnp.float32, attention="flash"))
    opt = jhvd.DistributedOptimizer(optax.adamw(1e-4))
    params = jax.tree_util.tree_map(jnp.asarray, jax_params)
    state = opt.init(params)

    def step(p, s, tok):
        g = jax.grad(lambda p: jloss_fn(jm.apply({"params": p}, tok),
                                        tok))(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s

    sstep = jhvd.spmd(step, in_specs=(P(), P(), P("hvd")),
                      out_specs=(P(), P()))
    new, _ = sstep(params, state, tokens)
    return gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray, new))


# After one Adam step every parameter moves by about lr = 1e-4. Where a
# gradient is 0 up to fp32 noise (the key part of the qkv bias: softmax is
# invariant to it) g / (|g| + eps) is noise in both frameworks; such
# elements ended up to 7.2e-6 apart when measured.
STEP_TOL = dict(rtol=0, atol=2e-5)


def _assert_params_close(got, want):
    assert set(got) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(np.asarray(got[name]),
                                   want[name].numpy(), err_msg=name,
                                   **STEP_TOL)


def test_one_step_single_process_matches_jax(jax_params, jax_step):
    hvd.init(device="cpu")
    try:
        m = _port_model(jax_params, "flash")
        hvd.broadcast_parameters(m.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            m.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8))
        tt = torch.tensor(_tokens(4))
        opt.zero_grad()
        loss_fn(m(tt), tt).backward()
        opt.step()
        got = {n: p.detach().numpy() for n, p in m.named_parameters()}
    finally:
        hvd.shutdown()
    _assert_params_close(got, jax_step)


_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config, loss_fn

    hvd.init(device="cpu")
    data = np.load(sys.argv[2])
    m = GPT2(GPT2Config.tiny(dtype=torch.float32, attention="flash"),
             torch.Generator().manual_seed(100 + hvd.rank()))  # differ ...
    if hvd.rank() == 0:                      # ... until the broadcast
        m.load_state_dict({k[2:]: torch.tensor(data[k]) for k in data.files
                           if k.startswith("p:")})
    hvd.broadcast_parameters(m.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        m.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8))
    hvd.broadcast_optimizer_state(opt, root_rank=0)
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
    sd = gpt2_params_from_jax(jax_params)
    np.savez(data, tokens=_tokens(4),
             **{f"p:{k}": v.numpy() for k, v in sd.items()})
    out = tmp_path / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--timeout", "240", str(script), REPO, str(data), str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ranks = [dict(np.load(f"{out}.rank{i}.npz")) for i in range(2)]
    for name in ranks[0]:        # every rank took the same step
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name])
    _assert_params_close(ranks[0], jax_step)
