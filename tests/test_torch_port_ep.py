"""Expert parallelism in horovod_tpu_torch (``ops/moe.ExpertParallel``,
``mp.tensor_parallel(model, ep=)``) == the reference's ``ep`` axis.

One spawned gloo world of four ranks:

* The MoE layer, top-1 and top-2 routers, GELU and SwiGLU experts
  (E 4, capacity factor 1.0, so tokens are dropped), split over the ep
  line of ``make_mesh({"dp": 2, "ep": 2})`` and of ``make_mesh({"ep":
  4})``: every rank routes the same (2, 16, 8) tokens and keeps E/ep
  experts. The output and the aux loss are the port's dense layer's bit
  for bit, and the reference's unsharded layer's within the fp32
  tolerances of ``tests/test_torch_port_moe.py`` (the reference's own ep
  check, ``tests/test_moe.py:82-108``, holds its GSPMD layer to the
  unsharded one). The gradients of ``mean(out**2) + 1e-2 aux``: the
  router's and the tokens' equal the reference's, each rank's experts'
  are the reference's rows of its experts; with f over ep taken out the
  tokens' gradient misses the other ranks' experts.
* The reference's dp x ep x tp step (``__graft_entry__.py:105-136``) on
  its factorization of four devices, (dp, ep, tp) = (1, 2, 2): a tiny fp32
  MoE GPT-2 (E 4, top-2) from the reference's init, three AdamW steps
  (lr 1e-3, weight decay 1e-4, eps 1e-8) of ``loss_fn_moe``'s objective
  (``mp.vocab_parallel_loss`` + 1e-2 times the mean aux loss), the
  optimizer over the dp line. Losses within rtol 1e-5 of the reference's
  GSPMD step, the parameters merged over tp and ep within rtol 1e-5, atol
  1e-4 (GPT-2's qkv-bias key part to steps x lr, as in
  ``tests/test_torch_port_tp_train.py``). The first step's gradients of
  the replicated weights are equal on all four ranks, those split over
  tp on the two ep ranks of a tp place, and the experts' on the two tp
  ranks of an ep place.
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
from jax.sharding import NamedSharding, PartitionSpec as JP

from horovod_tpu.models import gpt2 as jgpt2
from horovod_tpu.ops import moe as jmoe
from horovod_tpu.parallel import make_mesh as jmake_mesh
from horovod_tpu.parallel import shard_pytree as jshard_pytree

from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models.gpt2 import GPT2Config
from horovod_tpu_torch.parallel import mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = [f"{a}-{r}" for a in ("gelu", "swiglu") for r in ("top1", "top2")]
EP_MESHES = {"dp2xep2": {"dp": 2, "ep": 2}, "ep4": {"ep": 4}}
B, T, D, F, E = 2, 16, 8, 16, 4
OUT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
STEPS, LR, WD = 3, 1e-3, 1e-4
LOSS_TOL = dict(rtol=1e-5, atol=0)
PARAM_TOL = dict(rtol=1e-5, atol=1e-4)
MOE_DIMS = (1, 2, 2)
EXPERTS = ("w_in", "w_out", "b_in", "b_out", "w_gate")


def _x():
    return np.random.default_rng(21).standard_normal((B, T, D)).astype(
        np.float32)


def _moe_tokens():
    return np.random.default_rng(2).integers(0, 256, (2, 32)).astype(
        np.int32)


def _jmoe_cfg():
    return jgpt2.GPT2Config.tiny(dtype=jnp.float32, num_experts=4,
                                 moe_router="top2")


_WORKER = textwrap.dedent('''
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from horovod_tpu_torch.ops import moe
    from horovod_tpu_torch.parallel import make_mesh, mp

    STEPS, LR, WD = 3, 1e-3, 1e-4
    base = sys.argv[2]
    B, T, D, F, E = 2, 16, 8, 16, 4
    hvd.init(device="cpu")
    r = hvd.rank()
    out, info = {}, {}
    x = torch.tensor(np.load(base + ".x.npy"))

    def layer(spec, ep=None, no_f=False):
        act, router = spec.split("-")
        pl = moe.MoEMLP(D, E, F, 1.0, torch.float32, router_type=router,
                        activation=act)
        pl.load_state_dict(convert.gpt2_params_from_jax(
            dict(np.load(base + f".{spec}.npz"))))
        if ep is not None:
            el, lo = E // ep.size(), ep.rank() * (E // ep.size())
            for name in ("w_in", "w_out", "b_in", "b_out", "w_gate"):
                if hasattr(pl, name):
                    getattr(pl, name).data = \\
                        getattr(pl, name).data[lo:lo + el].clone()
            pl.ep = moe.ExpertParallel(ep)
            if no_f:
                pl.ep.f = lambda t: t
        xx = x.clone().requires_grad_(True)
        o, aux = pl(xx)
        ((o ** 2).mean() + 1e-2 * aux).backward()
        return o.detach(), aux.detach(), xx.grad, {
            n: p.grad for n, p in pl.named_parameters()}

    meshes = json.loads(sys.argv[3])
    for spec in json.loads(sys.argv[4]):
        dense = layer(spec)
        for tag, axes in meshes.items():
            ps = make_mesh(axes).process_set("ep")
            o, aux, gx, g = layer(spec, ps)
            key = f"{tag}:{spec}"
            info[key] = {"out_equal": bool(torch.equal(o, dense[0])),
                         "aux_equal": bool(torch.equal(aux, dense[1])),
                         "ep_rank": ps.rank(), "ep_size": ps.size()}
            out[key + ":out"], out[key + ":aux"] = o.numpy(), aux.numpy()
            out[key + ":gx"] = gx.numpy()
            for n, t in g.items():
                out[key + ":g:" + n] = t.numpy()
            # How far past the gradient tolerance (rtol 1e-3) the tokens'
            # gradient leaves the dense one's without f.
            no_f = layer(spec, ps, no_f=True)[2]
            info[key]["no_f_gx_err"] = float(
                ((no_f - dense[2]).abs() - 1e-3 * dense[2].abs()).max())

    # The dp x ep x tp MoE step.
    dims = json.loads(sys.argv[5])
    mesh = make_mesh(dict(zip(("dp", "ep", "tp"), dims)))
    at = mesh.coords(r)
    tp_set = mesh.process_set("tp")
    tokens = torch.tensor(np.load(base + ".moe_tokens.npy")).long()
    rows = tokens.shape[0] // dims[0]
    tok = tokens[at["dp"] * rows:(at["dp"] + 1) * rows]
    m = GPT2(GPT2Config.tiny(dtype=torch.float32, num_experts=4,
                             moe_router="top2"))
    m.load_state_dict(convert.gpt2_params_from_jax(
        dict(np.load(base + ".moe_gpt2.npz"))))
    m = mp.tensor_parallel(m, tp_set, ep=mesh.process_set("ep"))
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        m.parameters(), lr=LR, weight_decay=WD, eps=1e-8),
        process_set=mesh.process_set("dp"))
    losses = []
    for s in range(STEPS):
        opt.zero_grad()
        logits, aux = m(tok, return_aux=True)
        loss = mp.vocab_parallel_loss(logits, tok, tp_set) \\
            + 1e-2 * aux.mean()
        loss.backward()
        if s == 0:
            for n, p in m.named_parameters():
                out["step:grad:" + n] = p.grad.numpy().copy()
        opt.step()
        losses.append(loss.item())
    info["step"] = {"losses": losses, "at": at}
    for n, p in m.named_parameters():
        out["step:param:" + n] = p.detach().numpy()
    np.savez(base + f".rank{r}.npz", **out)
    with open(base + f".rank{r}.json", "w") as f:
        json.dump(info, f)
    hvd.shutdown()
''')


def _layer_reference(spec):
    """The reference's unsharded layer: its parameters (the GELU biases
    drawn nonzero, so their path shows) and out, aux and the gradients of
    ``mean(out**2) + 1e-2 aux`` as numpy."""
    act, router = spec.split("-")
    jl = jmoe.MoEMLP(num_experts=E, d_ff=F, capacity_factor=1.0,
                     dtype=jnp.float32, router_type=router, activation=act)
    x = jnp.asarray(_x())
    params = jax.jit(jl.init)(jax.random.PRNGKey(7), x)["params"]
    if act == "gelu":
        rng = np.random.default_rng(8)
        params["b_in"] = jnp.asarray(rng.standard_normal((E, F)) * 0.1,
                                     jnp.float32)
        params["b_out"] = jnp.asarray(rng.standard_normal((E, D)) * 0.1,
                                      jnp.float32)

    def loss(p, xx):
        o, aux = jl.apply({"params": p}, xx)
        return jnp.mean(o ** 2) + 1e-2 * aux, (o, aux)

    (_, (o, aux)), (g, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return as_np(params), {"out": np.asarray(o), "aux": float(aux),
                           "gx": np.asarray(gx),
                           "g": convert.gpt2_params_from_jax(as_np(g))}


def _moe_step_reference(params, mesh):
    """Three GSPMD AdamW steps of the tiny MoE GPT-2 on the dp x ep x tp
    mesh, tokens ``P("dp")``: (losses, final parameters in the port's
    layout)."""
    model = jgpt2.GPT2(_jmoe_cfg())
    p = jshard_pytree(jax.tree_util.tree_map(jnp.asarray, params), mesh,
                      jgpt2.partition_rules())
    tokens = jax.device_put(jnp.asarray(_moe_tokens()),
                            NamedSharding(mesh, JP("dp")))
    opt = optax.adamw(LR, eps=1e-8, weight_decay=WD)
    st = opt.init(p)

    def step(p, st, tok):
        loss, g = jax.value_and_grad(
            lambda p: jgpt2.loss_fn_moe(model, p, tok))(p)
        u, st = opt.update(g, st, p)
        return optax.apply_updates(p, u), st, loss

    with jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else mesh:
        fn = jax.jit(step)
        losses = []
        for _ in range(STEPS):
            p, st, loss = fn(p, st, tokens)
            losses.append(float(loss))
    return losses, convert.gpt2_params_from_jax(
        jax.tree_util.tree_map(np.asarray, p))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world (started first, run beside the reference) and the
    reference: (ranks, layer references, step reference)."""
    tmp = tmp_path_factory.mktemp("ep")
    base = tmp / "w"
    np.save(f"{base}.x.npy", _x())
    np.save(f"{base}.moe_tokens.npy", _moe_tokens())
    layers = {}
    for spec in LAYERS:
        params, layers[spec] = _layer_reference(spec)
        np.savez(f"{base}.{spec}.npz", **convert.flatten_tree(params))
    jm = jgpt2.GPT2(_jmoe_cfg())
    moe_params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(1), jnp.asarray(_moe_tokens()))["params"])
    np.savez(f"{base}.moe_gpt2.npz", **convert.flatten_tree(moe_params))
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    p = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "4",
         "--timeout", "200", str(script), REPO, str(base),
         json.dumps(EP_MESHES), json.dumps(LAYERS), json.dumps(MOE_DIMS)],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    step = _moe_step_reference(moe_params, jmake_mesh(
        dict(zip(("dp", "ep", "tp"), MOE_DIMS)), devices=jax.devices()[:4]))
    _, err = p.communicate(timeout=260)
    assert p.returncode == 0, err[-4000:]
    ranks = [(dict(np.load(f"{base}.rank{r}.npz")),
              json.load(open(f"{base}.rank{r}.json"))) for r in range(4)]
    return ranks, layers, step


@pytest.mark.parametrize("spec", LAYERS)
@pytest.mark.parametrize("tag", list(EP_MESHES))
def test_ep_layer_is_the_dense_layer_and_the_reference(runs, tag, spec):
    ranks, layers, _ = runs
    want = layers[spec]
    key = f"{tag}:{spec}"
    for arrs, info in ranks:
        i = info[key]
        assert i["out_equal"] and i["aux_equal"], i
        np.testing.assert_allclose(arrs[key + ":out"], want["out"],
                                   **OUT_TOL)
        np.testing.assert_allclose(float(arrs[key + ":aux"]), want["aux"],
                                   rtol=1e-6)
        np.testing.assert_allclose(arrs[key + ":gx"], want["gx"],
                                   **GRAD_TOL)
        el = E // i["ep_size"]
        lo = i["ep_rank"] * el
        for n, g in want["g"].items():
            got = arrs[f"{key}:g:{n}"]
            w = g.numpy()[lo:lo + el] if n in EXPERTS else g.numpy()
            assert got.shape == w.shape, n
            np.testing.assert_allclose(got, w, err_msg=n, **GRAD_TOL)


@pytest.mark.parametrize("spec", LAYERS)
def test_leaving_out_f_over_ep_breaks_the_token_gradient(runs, spec):
    ranks, _, _ = runs
    for tag in EP_MESHES:
        for _, info in ranks:
            assert info[f"{tag}:{spec}"]["no_f_gx_err"] > GRAD_TOL["atol"]


def _merged(ranks):
    """The step's final parameters: tp parts merged, then the experts of
    the ep places concatenated (ranks row-major over (dp, ep, tp))."""
    cfg = GPT2Config.tiny(dtype=torch.float32)
    dp, ep, tp = MOE_DIMS
    per_ep = []
    for e in range(ep):
        parts = [{k[len("step:param:"):]: torch.tensor(v)
                  for k, v in ranks[e * tp + c][0].items()
                  if k.startswith("step:param:")} for c in range(tp)]
        rules = mp.mp_partition_rules(cfg, "megatron")
        per_ep.append({k: mp._merge_one(mp._kind(rules, k),
                                        [p[k] for p in parts])
                       for k in parts[0]})
    return {k: torch.cat([p[k] for p in per_ep]) if k.split(".")[-1]
            in EXPERTS else per_ep[0][k] for k in per_ep[0]}


def test_dp_ep_tp_moe_step_matches_the_reference(runs):
    ranks, _, (losses, params) = runs
    for _, info in ranks:
        np.testing.assert_allclose(info["step"]["losses"], losses,
                                   **LOSS_TOL)
    got = _merged(ranks)
    assert set(got) == set(params)
    for k, w in params.items():
        g, w = got[k].numpy(), w.numpy()
        if k.endswith("attn.qkv.bias"):
            d = w.shape[0] // 3
            np.testing.assert_allclose(g[d:2 * d], w[d:2 * d], rtol=0,
                                       atol=STEPS * LR, err_msg=k)
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        np.testing.assert_allclose(g, w, err_msg=k, **PARAM_TOL)


def test_replicated_grads_identical_on_ep_and_tp_ranks(runs):
    ranks, _, _ = runs
    cfg = GPT2Config.tiny(dtype=torch.float32)
    rules = mp.mp_partition_rules(cfg, "megatron")
    keys = [k for k in ranks[0][0] if k.startswith("step:grad:")]
    kinds = {"whole": 0, "tp": 0, "ep": 0}
    for k in keys:
        name = k[len("step:grad:"):]
        if name.split(".")[-1] in EXPERTS:
            groups, kind = [(0, 1), (2, 3)], "ep"     # tp ranks of a place
        elif mp._kind(rules, name) == "whole":
            groups, kind = [(0, 1, 2, 3)], "whole"
        else:
            groups, kind = [(0, 2), (1, 3)], "tp"     # ep ranks of a place
        kinds[kind] += 1
        for g in groups:
            for r in g[1:]:
                assert np.array_equal(ranks[g[0]][0][k], ranks[r][0][k]), \
                    (k, g)
    assert all(kinds.values()), kinds
