"""Tensor-parallel training in horovod_tpu_torch (``mp.tensor_parallel``,
``mp.vocab_parallel_loss``) == the reference's GSPMD training: the models'
``partition_rules()`` applied by ``shard_pytree`` on a tp = 2 mesh of CPU
devices 0-1, the step under ``jax.jit`` (``__graft_entry__.py:85-100``).

Tiny fp32 GPT-2 and Llama (4 heads over 2 kv heads), weights of the
reference's init carried over with ``models/convert.py``, 4 x 32 tokens,
three AdamW steps (lr 1e-3, weight decay 1e-4, eps 1e-8; the reference's
``optax.adamw``, the port's ``torch.optim.AdamW`` under
``DistributedOptimizer`` over the mesh's dp set). Two spawned gloo worlds
run side by side:

* two ranks, ``HOROVOD_MESH=dp1xmp2``: the losses equal the reference's
  (rtol 1e-5) and ``merge_params`` of the ranks' parameters its final
  parameters (rtol 1e-5, atol 1e-4, a tenth of lr, as in
  ``tests/test_torch_port_fsdp.py``: Adam's early updates are about lr
  times the sign of the gradient, so small gradients summed in another
  order move their elements by a share of lr). The key part of GPT-2's
  qkv bias has a gradient that is exactly 0 in exact arithmetic (softmax
  is invariant to a constant a query adds to all its scores), so Adam
  moves it by up to lr a step in a direction that rounding noise picks:
  it is held to ``STEPS * lr`` alone. Each replicated parameter's gradient
  is identical on both ranks; a step issues 4 in-step allreduces a layer
  and 4 more (the embedding's sum, the loss's max and its sums, the
  head's f); the first step's
  gradients equal the dense model's split (rtol 1e-4, atol 1e-6), and with
  Megatron's f taken out of the attention and the MLP they do not;
* four ranks, ``HOROVOD_MESH=dp2xmp2``, each dp row on its half of the
  batch: the losses, averaged over the dp rows, and the merged parameters
  equal one process training the dense model on the whole batch (same
  tolerances).
"""

import json
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

from horovod_tpu.models import gpt2 as jgpt2
from horovod_tpu.models import llama as jllama
from horovod_tpu.parallel import make_mesh as jmake_mesh
from horovod_tpu.parallel import shard_pytree as jshard_pytree

from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config, loss_fn
from horovod_tpu_torch.models.llama import Llama, LlamaConfig
from horovod_tpu_torch.parallel import mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("gpt2", "llama")
STEPS, LR, WD = 3, 1e-3, 1e-4
LOSS_TOL = dict(rtol=1e-5, atol=0)
PARAM_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _jcfg(fam):
    return (jgpt2.GPT2Config.tiny(dtype=jnp.float32) if fam == "gpt2"
            else jllama.LlamaConfig.tiny(dtype=jnp.float32))


def _cfg(fam):
    return (GPT2Config.tiny(dtype=torch.float32) if fam == "gpt2"
            else LlamaConfig.tiny(dtype=torch.float32))


def _tokens():
    return np.random.default_rng(7).integers(0, 256, (4, 32)).astype(
        np.int32)


def _jparams(fam):
    model = (jgpt2.GPT2 if fam == "gpt2" else jllama.Llama)(_jcfg(fam))
    params = model.init(jax.random.PRNGKey(3), jnp.ones((1, 4), jnp.int32))
    return model, jax.tree_util.tree_map(np.asarray, params["params"])


def _dense_one_process(fam, state, tokens):
    """The port's dense model on the whole batch, AdamW in one process."""
    m = (GPT2 if fam == "gpt2" else Llama)(_cfg(fam))
    m.load_state_dict(state)
    opt = torch.optim.AdamW(m.parameters(), lr=LR, weight_decay=WD, eps=1e-8)
    tok = torch.tensor(tokens).long()
    losses = []
    for _ in range(STEPS):
        opt.zero_grad()
        loss = loss_fn(m(tok), tok)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses, {k: v.detach() for k, v in m.state_dict().items()}


_WORKER = textwrap.dedent('''
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config, loss_fn
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig
    from horovod_tpu_torch.parallel import mp

    STEPS, LR, WD = 3, 1e-3, 1e-4
    hvd.init(device="cpu")
    r = hvd.rank()
    mesh = hvd.mesh2d()
    dp_set = mesh.process_set("dp")
    tokens = torch.tensor(np.load(sys.argv[2] + ".tokens.npy")).long()
    rows = tokens.shape[0] // hvd.dp_size()
    tok = tokens[hvd.dp_rank() * rows:(hvd.dp_rank() + 1) * rows]
    out, info = {}, {}

    def traced():
        return sum(s["value"] for s in metrics.snapshot()["counters"].get(
            "collective_traced_total", [])
            if s["labels"].get("kind") == "allreduce")

    def build(fam):
        cfg = (GPT2Config.tiny(dtype=torch.float32) if fam == "gpt2"
               else LlamaConfig.tiny(dtype=torch.float32))
        m = (GPT2 if fam == "gpt2" else Llama)(cfg)
        m.load_state_dict(convert.gpt2_params_from_jax(
            dict(np.load(sys.argv[2] + f".{fam}.npz"))))
        return m

    for fam in ("gpt2", "llama"):
        m = mp.tensor_parallel(build(fam))
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            m.parameters(), lr=LR, weight_decay=WD, eps=1e-8),
            process_set=dp_set)
        losses, per_step = [], []
        for s in range(STEPS):
            opt.zero_grad()
            n0 = traced()
            loss = mp.vocab_parallel_loss(m(tok), tok)
            loss.backward()
            per_step.append(traced() - n0)
            if s == 0:
                for n, p in m.named_parameters():
                    out[f"{fam}:grad:{n}"] = p.grad.numpy().copy()
            opt.step()
            losses.append(loss.item())
        info[fam] = {"losses": losses, "traced_a_step": per_step}
        for n, p in m.named_parameters():
            out[f"{fam}:param:{n}"] = p.detach().numpy()
        if sys.argv[3] == "planted":
            # The dense model's gradient, split for this rank, and the
            # tensor-parallel one with f taken out of attention and MLP.
            dense = build(fam)
            loss_fn(dense(tok), tok).backward()
            want = mp.split_params(dense.cfg, {
                n: p.grad for n, p in dense.named_parameters()},
                hvd.mp_size(), hvd.mp_rank())
            for label, no_f in (("tp", False), ("no_f", True)):
                m = mp.tensor_parallel(build(fam))
                if no_f:
                    for blk in m.h:
                        blk.attn.tp = blk.mlp.tp = None
                mp.vocab_parallel_loss(m(tok), tok).backward()
                info[fam][label + "_grad_err"] = max(
                    float(((p.grad - want[n]).abs()
                           - 1e-4 * want[n].abs()).max())
                    for n, p in m.named_parameters())
    np.savez(sys.argv[2] + f".rank{r}.npz", **out)
    with open(sys.argv[2] + f".rank{r}.json", "w") as f:
        json.dump(info, f)
    hvd.shutdown()
''')


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    np.save(tmp / "a.tokens.npy", _tokens())
    np.save(tmp / "b.tokens.npy", _tokens())
    params = {}
    for fam in FAMILIES:
        _, params[fam] = _jparams(fam)
        flat = convert.flatten_tree(params[fam])
        for prefix in ("a", "b"):
            np.savez(tmp / f"{prefix}.{fam}.npz", **flat)
    return tmp, params


@pytest.fixture(scope="module")
def worlds(inputs):
    """The two-rank and the four-rank world, started together."""
    tmp, _ = inputs
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    procs = {}
    for prefix, n, mesh, mode in (("a", 2, "dp1xmp2", "planted"),
                                  ("b", 4, "dp2xmp2", "plain")):
        env = dict(os.environ, OMP_NUM_THREADS="1", HOROVOD_MESH=mesh)
        procs[prefix] = (n, subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
             str(n), "--timeout", "200", str(script), REPO,
             str(tmp / prefix), mode],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    out = {}
    for prefix, (n, p) in procs.items():
        _, err = p.communicate(timeout=260)
        assert p.returncode == 0, err[-4000:]
        out[prefix] = [(dict(np.load(tmp / f"{prefix}.rank{r}.npz")),
                        json.load(open(tmp / f"{prefix}.rank{r}.json")))
                       for r in range(n)]
    return out


@pytest.fixture(scope="module")
def reference(inputs):
    """Three GSPMD steps of each family on a tp = 2 mesh: (losses, final
    params in the port's layout)."""
    tmp, params = inputs
    tokens = jnp.asarray(_tokens())
    mesh = jmake_mesh({"tp": 2}, devices=jax.devices()[:2])
    out = {}
    for fam in FAMILIES:
        model, _ = _jparams(fam)
        mod = jgpt2 if fam == "gpt2" else jllama
        p = jshard_pytree(jax.tree_util.tree_map(jnp.asarray, params[fam]),
                          mesh, mod.partition_rules())
        opt = optax.adamw(LR, eps=1e-8, weight_decay=WD)
        st = opt.init(p)

        def step(p, st, tok, model=model, mod=mod, opt=opt):
            loss, g = jax.value_and_grad(
                lambda p: mod.loss_fn(model.apply({"params": p}, tok),
                                      tok))(p)
            u, st = opt.update(g, st, p)
            return optax.apply_updates(p, u), st, loss

        with jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else mesh:
            fn = jax.jit(step)
            losses = []
            for _ in range(STEPS):
                p, st, loss = fn(p, st, tokens)
                losses.append(float(loss))
        out[fam] = (losses, convert.gpt2_params_from_jax(
            jax.tree_util.tree_map(np.asarray, p)))
    return out


def _merged(ranks, fam, which="param"):
    cfg = _cfg(fam)
    key = f"{fam}:{which}:"
    parts = [{k[len(key):]: torch.tensor(v) for k, v in arrs.items()
              if k.startswith(key)} for arrs, _ in ranks]
    return mp.merge_params(cfg, parts)


def _close(got, want, tol):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), want[k].numpy()
        if k.endswith("attn.qkv.bias"):
            d = w.shape[0] // 3
            np.testing.assert_allclose(g[d:2 * d], w[d:2 * d], rtol=0,
                                       atol=STEPS * LR, err_msg=k)
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        np.testing.assert_allclose(g, w, err_msg=k, **tol)


@pytest.mark.parametrize("fam", FAMILIES)
def test_two_mp_ranks_train_as_reference_gspmd(worlds, reference, fam):
    losses, params = reference[fam]
    for _, info in worlds["a"]:
        np.testing.assert_allclose(info[fam]["losses"], losses, **LOSS_TOL)
    _close(_merged(worlds["a"], fam), params, PARAM_TOL)


@pytest.mark.parametrize("fam", FAMILIES)
def test_replicated_grads_identical_on_mp_ranks(worlds, fam):
    (a, _), (b, _) = worlds["a"]
    cfg = _cfg(fam)
    whole = [k for k in a if k.startswith(f"{fam}:grad:")
             and mp._kind(mp.mp_partition_rules(cfg, "megatron"),
                          k.split(":", 2)[2]) == "whole"]
    assert len(whole) >= 2 * cfg.num_layers + 1
    for k in whole:
        assert np.array_equal(a[k], b[k]), k
    split = [k for k in a if k.startswith(f"{fam}:grad:") and k not in whole]
    assert any(not np.array_equal(a[k], b[k]) for k in split)


@pytest.mark.parametrize("fam", FAMILIES)
def test_in_step_allreduces_a_step(worlds, fam):
    layers = _cfg(fam).num_layers
    for _, info in worlds["a"]:
        assert info[fam]["traced_a_step"] == [4 * layers + 4] * STEPS


@pytest.mark.parametrize("fam", FAMILIES)
def test_leaving_out_f_breaks_the_gradients(worlds, fam):
    for _, info in worlds["a"]:
        assert info[fam]["tp_grad_err"] <= GRAD_TOL["atol"]
        assert info[fam]["no_f_grad_err"] > 1e-3


@pytest.mark.parametrize("fam", FAMILIES)
def test_dp2xmp2_trains_as_one_process(worlds, inputs, fam):
    _, params = inputs
    state = convert.gpt2_params_from_jax(params[fam])
    losses, final = _dense_one_process(fam, state, _tokens())
    ranks = worlds["b"]
    for row in range(2):
        got = [ranks[2 * row + c][1][fam]["losses"] for c in range(2)]
        assert got[0] == got[1]
    mean = np.mean([ranks[0][1][fam]["losses"], ranks[2][1][fam]["losses"]],
                   axis=0)
    np.testing.assert_allclose(mean, losses, **LOSS_TOL)
    for row in range(2):
        _close(_merged(ranks[2 * row:2 * row + 2], fam), final, PARAM_TOL)
