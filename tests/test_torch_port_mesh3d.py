"""dp x sp x tp training in horovod_tpu_torch == the reference's dryrun
step (``__graft_entry__.py:66-103``): ``make_mesh({"dp", "sp", "tp"})``,
the models' ``partition_rules()`` applied by ``shard_pytree``, the tokens
laid out ``P("dp", "sp")`` and the step under ``jax.jit`` on the CPU
devices of ``tests/conftest.py``.

Tiny fp32 GPT-2 and Llama (4 heads over 2 kv heads), the reference's
init carried over with ``models/convert.py``, 4 x 64 tokens, three AdamW
steps (lr 1e-3, weight decay 1e-4, eps 1e-8). The port wires the model
with ``mp.tensor_parallel(model, mesh.process_set("tp"),
sp=mesh.process_set("sp"))`` (ring flash attention or the dense ring over
the sp line at the local head count), takes
``mp.vocab_parallel_loss(..., sp=, layout=)`` and averages the gradients
over the dp x sp plane (``DistributedOptimizer(process_set=
mesh.process_set(("dp", "sp")))``). Two spawned gloo worlds of four ranks
run side by side: (dp, sp, tp) = (1, 2, 2) and (2, 2, 1), the reference's
dryrun factorization of 4 devices and one more. Each trains both ring
layouts with dense and with flash (the plain versions on the CPU)
attention, and Ulysses (its all-to-alls over the sp line, at the local
head count); the ranks of a dp row return one loss, the rows' mean is the
reference's (rtol 1e-5), and
the parameters, merged over tp, its final parameters (rtol 1e-5, atol
1e-4; GPT-2's qkv-bias key part, whose gradient is 0 in exact
arithmetic, to steps x lr: ``tests/test_torch_port_tp_train.py`` says
why). In the (1, 2, 2) world the first step's gradient averaged over the
plane equals the dense model's, split for the rank (rtol 1e-4, atol
1e-6), and averaged over the dp line alone it does not. Each rank's sets
are the reference mesh's lines and planes through it.
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
from horovod_tpu.models import llama as jllama
from horovod_tpu.parallel import make_mesh as jmake_mesh
from horovod_tpu.parallel import shard_pytree as jshard_pytree

from horovod_tpu_torch.models import convert
from horovod_tpu_torch.parallel import mp
from horovod_tpu_torch.models.gpt2 import GPT2Config
from horovod_tpu_torch.models.llama import LlamaConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("gpt2", "llama")
RUNS = [f"{layout}-{attn}" for layout in ("contiguous", "striped")
        for attn in ("dense", "flash")] + ["contiguous-ulysses"]
MESHES = {"a": (1, 2, 2), "b": (2, 2, 1)}
AXES = ("dp", "sp", "tp")
PLANES = [("dp",), ("sp",), ("tp",), ("dp", "sp"), ("dp", "tp"),
          ("sp", "tp"), ("dp", "sp", "tp")]
STEPS, LR, WD = 3, 1e-3, 1e-4
LOSS_TOL = dict(rtol=1e-5, atol=0)
PARAM_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _tokens():
    return np.random.default_rng(11).integers(0, 256, (4, 64)).astype(
        np.int32)


def _jparams(fam):
    cfg = (jgpt2.GPT2Config.tiny(dtype=jnp.float32) if fam == "gpt2"
           else jllama.LlamaConfig.tiny(dtype=jnp.float32))
    model = (jgpt2.GPT2 if fam == "gpt2" else jllama.Llama)(cfg)
    params = model.init(jax.random.PRNGKey(5), jnp.ones((1, 4), jnp.int32))
    return model, jax.tree_util.tree_map(np.asarray, params["params"])


_WORKER = textwrap.dedent('''
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config, loss_fn
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig
    from horovod_tpu_torch.parallel import make_mesh, mp

    STEPS, LR, WD = 3, 1e-3, 1e-4
    base, dims = sys.argv[2], json.loads(sys.argv[3])
    hvd.init(device="cpu")
    r = hvd.rank()
    mesh = make_mesh(dict(zip(("dp", "sp", "tp"), dims)))
    at = mesh.coords(r)
    tp_set, sp_set = mesh.process_set("tp"), mesh.process_set("sp")
    plane = mesh.process_set(("dp", "sp"))
    tokens = torch.tensor(np.load(base + ".tokens.npy")).long()
    rows = tokens.shape[0] // dims[0]
    batch = tokens[at["dp"] * rows:(at["dp"] + 1) * rows]
    out, info = {}, {"sets": {}}
    for axes in json.loads(sys.argv[4]):
        ps = mesh.process_set(tuple(axes))
        info["sets"]["+".join(axes)] = list(range(hvd.size())) \\
            if ps.ranks is None else ps.ranks

    def shard(x, layout):
        n, s = dims[1], at["sp"]
        if layout == "striped":
            return x[:, s::n].contiguous()
        t = x.shape[1] // n
        return x[:, s * t:(s + 1) * t]

    def build(fam, **kw):
        cfg = (GPT2Config.tiny(dtype=torch.float32, **kw) if fam == "gpt2"
               else LlamaConfig.tiny(dtype=torch.float32, **kw))
        m = (GPT2 if fam == "gpt2" else Llama)(cfg)
        m.load_state_dict(convert.gpt2_params_from_jax(
            dict(np.load(base + f".{fam}.npz"))))
        return m

    for fam in ("gpt2", "llama"):
        for run in json.loads(sys.argv[5]):
            layout, attn = run.split("-")
            kw = dict(sp_impl="ulysses", attention="flash") \
                if attn == "ulysses" else dict(attention=attn)
            m = mp.tensor_parallel(
                build(fam, use_ring_attention=True, ring_layout=layout,
                      **kw), tp_set, sp=sp_set)
            tok = shard(batch, layout)

            def loss_of():
                return mp.vocab_parallel_loss(m(tok), tok, tp_set, sp=m.sp,
                                              layout=layout)

            if sys.argv[6] == "planted" and run == "contiguous-flash":
                # The first step's gradient over the plane and over the
                # dp line alone, against the dense model's split.
                loss_of().backward()
                dense = build(fam)
                loss_fn(dense(batch), batch).backward()
                want = mp.split_params(dense.cfg, {
                    n: p.grad for n, p in dense.named_parameters()},
                    dims[2], at["tp"])
                for label, ps in (("plane", plane),
                                  ("dp_only", mesh.process_set("dp"))):
                    info[f"{fam}:{label}_grad_err"] = max(
                        float(((hvd.allreduce(p.grad, process_set=ps)
                                - want[n]).abs()
                               - 1e-4 * want[n].abs()).max())
                        for n, p in m.named_parameters())
                m.zero_grad()
            opt = hvd.DistributedOptimizer(torch.optim.AdamW(
                m.parameters(), lr=LR, weight_decay=WD, eps=1e-8),
                process_set=plane)
            losses = []
            for s in range(STEPS):
                opt.zero_grad()
                loss = loss_of()
                loss.backward()
                opt.step()
                losses.append(loss.item())
            info[f"{fam}:{run}"] = losses
            for n, p in m.named_parameters():
                out[f"{fam}:{run}:{n}"] = p.detach().numpy()
    np.savez(base + f".rank{r}.npz", **out)
    with open(base + f".rank{r}.json", "w") as f:
        json.dump(info, f)
    hvd.shutdown()
''')


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh3d")
    params = {}
    for fam in FAMILIES:
        _, params[fam] = _jparams(fam)
    for prefix in MESHES:
        np.save(tmp / f"{prefix}.tokens.npy", _tokens())
        for fam in FAMILIES:
            np.savez(tmp / f"{prefix}.{fam}.npz",
                     **convert.flatten_tree(params[fam]))
    return tmp, params


def _reference(params):
    """Three GSPMD AdamW steps of each family on each mesh, as the dryrun
    takes one: {(mesh, family): (losses, final params in the port's
    layout)}."""
    out = {}
    for prefix, dims in MESHES.items():
        mesh = jmake_mesh(dict(zip(AXES, dims)), devices=jax.devices()[:4])
        tokens = jax.device_put(jnp.asarray(_tokens()),
                                NamedSharding(mesh, JP("dp", "sp")))
        for fam in FAMILIES:
            model, _ = _jparams(fam)
            mod = jgpt2 if fam == "gpt2" else jllama
            p = jshard_pytree(jax.tree_util.tree_map(jnp.asarray,
                                                     params[fam]),
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
            out[prefix, fam] = (losses, convert.gpt2_params_from_jax(
                jax.tree_util.tree_map(np.asarray, p)))
    return out


@pytest.fixture(scope="module")
def runs(inputs):
    """The two worlds (started first, run beside the reference's steps)
    and the reference: (worlds, reference)."""
    tmp, params = inputs
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    procs = {}
    for prefix, dims in MESHES.items():
        procs[prefix] = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "4",
             "--timeout", "200", str(script), REPO, str(tmp / prefix),
             json.dumps(dims), json.dumps(PLANES), json.dumps(RUNS),
             "planted" if prefix == "a" else "plain"],
            cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    reference = _reference(params)
    worlds = {}
    for prefix, p in procs.items():
        _, err = p.communicate(timeout=260)
        assert p.returncode == 0, err[-4000:]
        worlds[prefix] = [(dict(np.load(tmp / f"{prefix}.rank{r}.npz")),
                           json.load(open(tmp / f"{prefix}.rank{r}.json")))
                          for r in range(4)]
    return worlds, reference


def _cfg(fam):
    return (GPT2Config.tiny(dtype=torch.float32) if fam == "gpt2"
            else LlamaConfig.tiny(dtype=torch.float32))


def _merged(ranks, dims, fam, run):
    """The parameters of the tp ranks of (dp 0, sp 0), merged."""
    key = f"{fam}:{run}:"
    parts = [{k[len(key):]: torch.tensor(v) for k, v in arrs.items()
              if k.startswith(key)} for arrs, _ in ranks[:dims[2]]]
    return mp.merge_params(_cfg(fam), parts)


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


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("fam", FAMILIES)
@pytest.mark.parametrize("prefix", list(MESHES))
def test_trains_as_the_reference_dryrun_step(runs, prefix, fam, run):
    worlds, reference = runs
    losses, params = reference[prefix, fam]
    dp, sp, tp = MESHES[prefix]
    # The ranks of one dp row return its loss; the rows' mean is the
    # reference's.
    rows = [[info[f"{fam}:{run}"] for _, info in
             worlds[prefix][d * sp * tp:(d + 1) * sp * tp]]
            for d in range(dp)]
    for row in rows:
        assert all(x == row[0] for x in row)
    np.testing.assert_allclose(np.mean([row[0] for row in rows], axis=0),
                               losses, **LOSS_TOL)
    _close(_merged(worlds[prefix], MESHES[prefix], fam, run), params,
           PARAM_TOL)


@pytest.mark.parametrize("fam", FAMILIES)
def test_leaving_out_the_plane_reduce_breaks_the_gradients(runs, fam):
    worlds, _ = runs
    for _, info in worlds["a"]:
        assert info[f"{fam}:plane_grad_err"] <= GRAD_TOL["atol"]
        assert info[f"{fam}:dp_only_grad_err"] > 1e-3


@pytest.mark.parametrize("prefix", list(MESHES))
def test_each_ranks_sets_are_its_lines_and_planes(runs, prefix):
    """Rank r's set over a tuple of axes is the plane of the reference's
    device array through r over those axes (a line for one axis)."""
    worlds, _ = runs
    ref = jmake_mesh(dict(zip(AXES, MESHES[prefix])),
                     devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    for r, (_, info) in enumerate(worlds[prefix]):
        at = [int(i) for i in np.argwhere(ids == r)[0]]
        for axes in PLANES:
            idx = tuple(slice(None) if a in axes else at[j]
                        for j, a in enumerate(ref.axis_names))
            plane = sorted(int(x) for x in np.ravel(ids[idx]))
            assert info["sets"]["+".join(axes)] == plane, (r, axes)
