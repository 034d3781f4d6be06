"""horovod_tpu_torch BERT == horovod_tpu BERT: MLM and NSP logits, the MLM
loss, every gradient, and one data-parallel SGD step under Adasum.

A tiny fp32 BERT is initialised by the JAX package; its parameters are
carried to the port with ``bert_params_from_jax``. The same numpy tokens,
token types, key-padding mask and masked positions go through both. JAX
runs on the 8-device CPU mesh of tests/conftest.py with flash attention in
Pallas interpret mode; the port runs its plain kernel versions on the CPU.
The optimizer step runs on a two-rank gloo world (half the batch each,
launched by the port's runner) with ``op=Adasum``, against the reference's
``DistributedOptimizer(op=Adasum)`` over a process set of ranks {0, 1} of
the mesh, which reduces the same two halves. The step is plain SGD, whose
update is the combined gradient itself: Adam's first update is about
``lr * sign(g)`` whatever the reduction, so it would not tell Adasum from
an average.
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
from horovod_tpu.models.bert import Bert as JBert
from horovod_tpu.models.bert import BertConfig as JConfig
from horovod_tpu.models.bert import mlm_loss as jmlm_loss

from horovod_tpu_torch.models.bert import Bert, BertConfig, mlm_loss
from horovod_tpu_torch.models.convert import bert_params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fp32 on both sides; the two frameworks sum in different orders (as
# tests/test_torch_port_gpt2.py states them).
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
STEP_TOL = dict(rtol=0, atol=2e-5)
B, T = 8, 32
LR = 0.5


def _batch(seed=0):
    """tokens, token types, key mask (the last keys of some rows padded)
    and the 15 % masked positions, from numpy."""
    g = np.random.default_rng(seed)
    tokens = g.integers(0, 256, (B, T)).astype(np.int32)
    types = (np.arange(T)[None] >= g.integers(8, T, (B, 1))).astype(
        np.int32)
    mask = np.ones((B, T), bool)
    mask[1, -5:] = False
    mask[4, -11:] = False
    mpos = (g.random((B, T)) < 0.15).astype(np.float32)
    return tokens, types, mask, mpos


def _jcfg(attention="flash"):
    return dataclasses.replace(JConfig.tiny(), dtype=jnp.float32,
                               attention=attention)


@pytest.fixture(scope="module")
def jax_params():
    tokens = _batch()[0]
    params = JBert(_jcfg()).init(jax.random.PRNGKey(0),
                                 jnp.asarray(tokens))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(params_np, attention):
    m = Bert(BertConfig.tiny(dtype=torch.float32, attention=attention),
             torch.Generator().manual_seed(1))
    m.load_state_dict(bert_params_from_jax(params_np), strict=True)
    return m


def _jax_forward(params, attention, batch):
    tokens, types, mask, _ = batch
    return JBert(_jcfg(attention)).apply(
        {"params": params}, jnp.asarray(tokens), jnp.asarray(types),
        jnp.asarray(mask))


def _port_forward(m, batch):
    tokens, types, mask, _ = batch
    return m(torch.tensor(tokens), torch.tensor(types), torch.tensor(mask))


def test_config_fields_match_reference():
    jf = [f.name for f in dataclasses.fields(JConfig)]
    pf = [f.name for f in dataclasses.fields(BertConfig)]
    assert jf == pf
    for name in pf:
        if name != "dtype":
            for preset in ("large", "tiny"):
                assert getattr(getattr(JConfig, preset)(), name) == \
                    getattr(getattr(BertConfig, preset)(), name), name
    assert BertConfig.large().dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="sequence-parallel"):
        Bert(BertConfig.tiny(use_ring_attention=True))
    with pytest.raises(NotImplementedError, match="remat"):
        Bert(BertConfig.tiny(remat=True))


def test_converted_state_dict_covers_every_parameter(jax_params):
    sd = bert_params_from_jax(jax_params)
    m = Bert(BertConfig.tiny(dtype=torch.float32))
    assert set(sd) == set(m.state_dict())
    n_jax = sum(np.asarray(x).size
                for x in jax.tree_util.tree_leaves(jax_params))
    assert n_jax == sum(p.numel() for p in m.parameters())
    np.testing.assert_array_equal(
        sd["layer.1.qkv.weight"].numpy(),
        jax_params["layer1"]["qkv"]["kernel"].T)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_logits_and_loss_match(jax_params, attention):
    batch = _batch()
    jmlm, jnsp = _jax_forward(jax_params, attention, batch)
    pmlm, pnsp = _port_forward(_port_model(jax_params, attention), batch)
    np.testing.assert_allclose(pmlm.detach().numpy(), np.asarray(jmlm),
                               **LOGIT_TOL)
    np.testing.assert_allclose(pnsp.detach().numpy(), np.asarray(jnsp),
                               **LOGIT_TOL)
    tokens, _, _, mpos = batch
    np.testing.assert_allclose(
        mlm_loss(pmlm, torch.tensor(tokens), torch.tensor(mpos)).item(),
        float(jmlm_loss(jmlm, jnp.asarray(tokens), jnp.asarray(mpos))),
        rtol=1e-5)


def test_packed_segments_match(jax_params):
    tokens = _batch(2)[0]
    seg = np.sort(np.random.default_rng(3).integers(0, 3, (B, T)),
                  axis=1).astype(np.int32)
    jmlm, _ = JBert(_jcfg()).apply({"params": jax_params},
                                   jnp.asarray(tokens),
                                   segment_ids=jnp.asarray(seg))
    pmlm, _ = _port_model(jax_params, "flash")(
        torch.tensor(tokens), segment_ids=torch.tensor(seg))
    np.testing.assert_allclose(pmlm.detach().numpy(), np.asarray(jmlm),
                               **LOGIT_TOL)


def _jax_loss(params, batch):
    tokens, types, mask, mpos = (jnp.asarray(a) for a in batch)
    mlm, nsp = JBert(_jcfg()).apply({"params": params}, tokens, types, mask)
    # The NSP head joins the loss so that its gradients are not all zero.
    return jmlm_loss(mlm, tokens, mpos) + 0.1 * jnp.mean(nsp ** 2)


def _port_loss(m, batch):
    mlm, nsp = _port_forward(m, batch)
    return mlm_loss(mlm, torch.tensor(batch[0]),
                    torch.tensor(batch[3])) + 0.1 * (nsp ** 2).mean()


def test_every_gradient_matches(jax_params):
    batch = _batch(1)
    jgrads = jax.grad(_jax_loss)(jax_params, batch)
    want = bert_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    m = _port_model(jax_params, "flash")
    _port_loss(m, batch).backward()
    got = {n: p.grad for n, p in m.named_parameters()}
    assert set(got) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


# --------------------------------- one DistributedOptimizer step, Adasum

@pytest.fixture(scope="module")
def jax_adasum_step(jax_params):
    """Rank 0's and rank 1's params after one JAX
    ``DistributedOptimizer(optax.sgd(LR), op=Adasum)`` step over a
    process set {0, 1} of the mesh, ranks 0 and 1 holding the two halves
    of the batch (the other six devices are outside the set)."""
    batch = _batch(4)
    half = B // 2
    rows = np.concatenate([np.arange(B)] + [np.arange(half)] * 6)
    tok8, typ8, mask8, mpos8 = (jnp.asarray(a[rows]) for a in batch)
    ps = jhvd.add_process_set([0, 1])
    try:
        opt = jhvd.DistributedOptimizer(optax.sgd(LR), op=jhvd.Adasum,
                                        process_set=ps)
        params = jax.tree_util.tree_map(jnp.asarray, jax_params)
        state = opt.init(params)

        def step(p, s, tok, typ, mask, mpos):
            g = jax.grad(_jax_loss)(p, (tok, typ, mask, mpos))
            u, s = opt.update(g, s, p)
            return jax.tree_util.tree_map(lambda x: x[None],
                                          optax.apply_updates(p, u))

        new = jhvd.spmd(step, in_specs=(P(), P(), P("hvd"), P("hvd"),
                                        P("hvd"), P("hvd")),
                        out_specs=P("hvd"))(params, state, tok8, typ8,
                                            mask8, mpos8)
    finally:
        jhvd.remove_process_set(ps)
    return [bert_params_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x)[r], new)) for r in range(2)]


_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.bert import Bert, BertConfig, mlm_loss

    hvd.init(device="cpu")
    data = np.load(sys.argv[2])
    m = Bert(BertConfig.tiny(dtype=torch.float32, attention="flash"),
             torch.Generator().manual_seed(100 + hvd.rank()))  # differ ...
    if hvd.rank() == 0:                      # ... until the broadcast
        m.load_state_dict({k[2:]: torch.tensor(data[k]) for k in data.files
                           if k.startswith("p:")})
    hvd.broadcast_parameters(m.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=float(sys.argv[4])),
        op=hvd.Adasum)
    half = data["tokens"].shape[0] // hvd.size()
    rows = slice(hvd.rank() * half, (hvd.rank() + 1) * half)
    tok, typ, mask, mpos = (torch.tensor(data[k][rows]) for k in
                            ("tokens", "types", "mask", "mpos"))
    opt.zero_grad()
    mlm, nsp = m(tok, typ, mask)
    (mlm_loss(mlm, tok, mpos) + 0.1 * (nsp ** 2).mean()).backward()
    opt.step()
    np.savez(sys.argv[3] + f".rank{hvd.rank()}.npz",
             **{n: p.detach().numpy() for n, p in m.named_parameters()})
    hvd.shutdown()
""")


def test_one_adasum_step_two_gloo_ranks_matches_jax(tmp_path, jax_params,
                                                    jax_adasum_step):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    data = tmp_path / "data.npz"
    tokens, types, mask, mpos = _batch(4)
    sd = bert_params_from_jax(jax_params)
    np.savez(data, tokens=tokens, types=types, mask=mask, mpos=mpos,
             **{f"p:{k}": v.numpy() for k, v in sd.items()})
    out = tmp_path / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--timeout", "240", str(script), REPO, str(data), str(out),
         str(LR)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    for rank in range(2):
        got = dict(np.load(f"{out}.rank{rank}.npz"))
        want = jax_adasum_step[rank]
        assert set(got) == set(want)
        for name in sorted(want):
            np.testing.assert_allclose(got[name], want[name].numpy(),
                                       err_msg=f"rank {rank} {name}",
                                       **STEP_TOL)
