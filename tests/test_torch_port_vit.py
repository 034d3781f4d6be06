"""horovod_tpu_torch ViT == horovod_tpu ViT: logits, the loss, every
gradient and one data-parallel SGD step.

A tiny fp32 ViT (32x32 images, 8x8 patches: 16 patches and the cls token,
a length no tile divides) is initialised by the JAX package; its parameters
are carried to the port with ``vit_params_from_jax``. The same numpy images
go through both, NHWC into the reference and NCHW into the port. JAX runs
on the 8-device CPU mesh of tests/conftest.py with flash attention in
Pallas interpret mode; the port runs its plain kernel versions on the CPU.
The optimizer step runs on a two-rank gloo world (half the batch each,
launched by the port's runner) against the reference's step with the batch
sharded over the mesh (the mean of the eight shards' mean losses is the
mean of the two halves'). The step is plain SGD, whose update is the
averaged gradient itself: Adam's first update, about ``lr * sign(g)``,
turns gradients that are 0 up to fp32 noise (the key part of the qkv bias:
softmax ignores it) into updates of either sign.
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
import torch.nn.functional as F
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.models.vit import ViT as JViT
from horovod_tpu.models.vit import ViTConfig as JConfig

from horovod_tpu_torch.models.convert import vit_params_from_jax
from horovod_tpu_torch.models.vit import ViT, ViTConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fp32 on both sides; the two frameworks sum in different orders (as
# tests/test_torch_port_gpt2.py states them).
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
STEP_TOL = dict(rtol=0, atol=2e-5)
B = 8
LR = 0.5


def _batch(seed=0):
    """NHWC images and labels, from numpy."""
    g = np.random.default_rng(seed)
    return (g.standard_normal((B, 32, 32, 3)).astype(np.float32),
            g.integers(0, 10, (B,)).astype(np.int32))


def _nchw(images):
    return torch.tensor(np.ascontiguousarray(images.transpose(0, 3, 1, 2)))


def _jcfg(attention="flash"):
    return dataclasses.replace(JConfig.tiny(), dtype=jnp.float32,
                               attention=attention)


@pytest.fixture(scope="module")
def jax_params():
    params = JViT(_jcfg()).init(jax.random.PRNGKey(0),
                                jnp.asarray(_batch()[0]))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(params_np, attention):
    m = ViT(ViTConfig.tiny(dtype=torch.float32, attention=attention),
            torch.Generator().manual_seed(1))
    m.load_state_dict(vit_params_from_jax(params_np), strict=True)
    return m


def _jax_loss(params, images, labels):
    logits = JViT(_jcfg()).apply({"params": params}, images)
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], 1))


def test_config_fields_match_reference():
    jf = [f.name for f in dataclasses.fields(JConfig)]
    pf = [f.name for f in dataclasses.fields(ViTConfig)]
    assert jf == pf
    for name in pf:
        if name != "dtype":
            for preset in ("b16", "tiny"):
                assert getattr(getattr(JConfig, preset)(), name) == \
                    getattr(getattr(ViTConfig, preset)(), name), name
    assert ViTConfig.b16().dtype == torch.bfloat16


def test_converted_state_dict_covers_every_parameter(jax_params):
    sd = vit_params_from_jax(jax_params)
    m = ViT(ViTConfig.tiny(dtype=torch.float32))
    assert set(sd) == set(m.state_dict())
    # flax's conv kernel (kh, kw, in, out) is torch's (out, in, kh, kw).
    np.testing.assert_array_equal(
        sd["patchify.weight"].numpy(),
        jax_params["patchify"]["kernel"].transpose(3, 2, 0, 1))
    assert tuple(sd["pos_embed"].shape) == (1, 17, 64)
    with torch.device("meta"):
        full = ViT(ViTConfig.b16())
    assert tuple(full.pos_embed.shape) == (1, 197, 768)
    assert tuple(full.patchify.weight.shape) == (768, 3, 16, 16)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_logits_and_loss_match(jax_params, attention):
    images, labels = _batch()
    jl = JViT(_jcfg(attention)).apply({"params": jax_params},
                                      jnp.asarray(images))
    pl = _port_model(jax_params, attention)(_nchw(images))
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl),
                               **LOGIT_TOL)
    np.testing.assert_allclose(
        F.cross_entropy(pl, torch.tensor(labels).long()).item(),
        float(_jax_loss(jax_params, jnp.asarray(images),
                        jnp.asarray(labels))), rtol=1e-5)


def test_every_gradient_matches(jax_params):
    images, labels = _batch(1)
    jgrads = jax.grad(_jax_loss)(jax_params, jnp.asarray(images),
                                 jnp.asarray(labels))
    want = vit_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    m = _port_model(jax_params, "flash")
    F.cross_entropy(m(_nchw(images)), torch.tensor(labels).long()).backward()
    got = {n: p.grad for n, p in m.named_parameters()}
    assert set(got) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.fixture(scope="module")
def jax_step(jax_params):
    """Params after one JAX ``DistributedOptimizer(optax.sgd(LR))`` step
    with the batch sharded over the 8-device mesh."""
    images, labels = (jnp.asarray(a) for a in _batch(4))
    opt = jhvd.DistributedOptimizer(optax.sgd(LR))
    params = jax.tree_util.tree_map(jnp.asarray, jax_params)
    state = opt.init(params)

    def step(p, s, x, y):
        g = jax.grad(_jax_loss)(p, x, y)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s

    new, _ = jhvd.spmd(step, in_specs=(P(), P(), P("hvd"), P("hvd")),
                       out_specs=(P(), P()))(params, state, images, labels)
    return vit_params_from_jax(jax.tree_util.tree_map(np.asarray, new))


_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    import torch.nn.functional as F
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.vit import ViT, ViTConfig

    hvd.init(device="cpu")
    data = np.load(sys.argv[2])
    m = ViT(ViTConfig.tiny(dtype=torch.float32, attention="flash"),
            torch.Generator().manual_seed(100 + hvd.rank()))  # differ ...
    if hvd.rank() == 0:                     # ... until the broadcast
        m.load_state_dict({k[2:]: torch.tensor(data[k]) for k in data.files
                           if k.startswith("p:")})
    hvd.broadcast_parameters(m.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=float(sys.argv[4])))
    half = data["images"].shape[0] // hvd.size()
    rows = slice(hvd.rank() * half, (hvd.rank() + 1) * half)
    x = torch.tensor(data["images"][rows]).permute(0, 3, 1, 2).contiguous()
    y = torch.tensor(data["labels"][rows]).long()
    opt.zero_grad()
    F.cross_entropy(m(x), y).backward()
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
    images, labels = _batch(4)
    sd = vit_params_from_jax(jax_params)
    np.savez(data, images=images, labels=labels,
             **{f"p:{k}": v.numpy() for k, v in sd.items()})
    out = tmp_path / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--timeout", "240", str(script), REPO, str(data), str(out),
         str(LR)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ranks = [dict(np.load(f"{out}.rank{i}.npz")) for i in range(2)]
    for name in ranks[0]:        # every rank took the same step
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name])
    assert set(ranks[0]) == set(jax_step)
    for name in sorted(jax_step):
        np.testing.assert_allclose(ranks[0][name], jax_step[name].numpy(),
                                   err_msg=name, **STEP_TOL)
