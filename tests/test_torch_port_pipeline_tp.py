"""Pipelines with tensor and data parallelism in horovod_tpu_torch
(``models/gpt2_pipeline.py``) == the reference's GSPMD programs
(``tests/test_pipeline.py``'s ``TestGPT2PipelineTensorParallel`` without
the interleaved case, ``Test1F1B.test_gpt2_1f1b_tp_matches_single_device``
and the dryrun's pipeline steps, ``__graft_entry__.py:139-197``,
``:249-296`` and ``:368-406``).

One spawned gloo world of eight ranks runs every case beside the
reference, which runs under ``shard_map`` over ``make_mesh`` of the CPU
devices of ``tests/conftest.py`` (``hvd.spmd`` for the pp-only step).
Weights are the reference's init carried over with
``gpt2_params_from_jax``; tokens come from numpy with the reference's
seeds and shapes. The port stacks with ``make_pp_tp_params``, splits with
``shard_pytree(blocks, mesh, block_specs_tp())`` and steps with
``gpt2_pp_tp_loss_and_grad`` / ``gpt2_pp_tp_1f1b_loss_and_grad`` over
``mesh.process_set("pp")`` and ``("tp")``; under dp it averages the loss
and every gradient over ``mesh.process_set("dp")``.

* pp 4 x tp 2 GPipe (8 layers, 4 heads, d 32, fp32, M 4 x 2 x 16), pp 2 x
  tp 2 x dp 2 (4 layers, M 4 x (2 over dp) x 16) and pp 4 x tp 2 1F1B (M
  10): the loss (rtol 1e-5, atol 1e-6) and each rank's block gradients,
  its (stage, tp) part, and the whole ``rest`` gradients, identical on
  every rank (rtol 2e-3, atol 1e-5; 2e-5 under 1F1B).
* The dryrun: the pp 8 step with the SGD 0.1 update and the 1F1B loss
  after it; pp 4 x tp 2 GPipe and 1F1B; pp 2 x tp 2 x dp 2: losses,
  gradients and the updated parameters at the same bars.
* ``HOROVOD_MP_RULES=off`` leaves the pp x tp split and its gradients as
  they are: the layout reads ``block_specs_tp`` only.
* A stage body without f (the tp sum of the column-parallel inputs'
  cotangents) leaves the gradient bar.
* The head-major layout and its specs are the reference's, transposed to
  the port's (out, in) weights.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as JP

import horovod_tpu as jhvd
from horovod_tpu.models import gpt2 as jgpt2
from horovod_tpu.models import gpt2_pipeline as jgp
from horovod_tpu.parallel import make_mesh as jmake_mesh
from horovod_tpu.utils.compat import shard_map as jshard_map

from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import gpt2_pipeline as gp
from horovod_tpu_torch.parallel.mesh import Mesh
from horovod_tpu_torch.parallel.sharding import P, PartitionRules, _local_block

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-3, atol=1e-5)
GRAD_TOL_1F1B = dict(rtol=2e-3, atol=2e-5)
LR = 0.1

# name: (mesh axes, layers, heads, schedule, tokens seed, tokens shape,
# init key); the tokens' middle dim is the microbatch (or, under dp, the
# dp-sharded batch).
CASES = {
    "pp_tp": ({"pp": 4, "tp": 2}, 8, 4, "gpipe", 13, (4, 2, 16), 0),
    "pp_tp_dp": ({"pp": 2, "tp": 2, "dp": 2}, 4, 4, "gpipe", 17,
                 (4, 2, 16), 0),
    "1f1b_tp": ({"pp": 4, "tp": 2}, 8, 4, "1f1b", 23, (10, 2, 16), 0),
    "dryrun_pp_tp": ({"pp": 4, "tp": 2}, 4, 4, "gpipe", 5, (4, 1, 16), 4),
    "dryrun_1f1b_tp": ({"pp": 4, "tp": 2}, 4, 4, "1f1b", 7, (8, 1, 16), 4),
    "dryrun_pp_tp_dp": ({"pp": 2, "tp": 2, "dp": 2}, 2, 4, "gpipe", 6,
                        (4, 2, 16), 5),
}
# The dryrun's pp step (``:139-197``): 8 stages, 2 heads, PRNGKey(2), M 4
# x 2 x 16 from seed 3, then 1F1B on the updated weights, 16 x 2 x 16 from
# seed 7.
PP = dict(layers=8, heads=2, key=2, tokens=(3, (4, 2, 16)),
          tokens_1f1b=(7, (16, 2, 16)))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 128, shape) \
        .astype(np.int32)


def _cfg(layers, heads):
    return jgpt2.GPT2Config(vocab_size=128, max_seq_len=32,
                            num_layers=layers, num_heads=heads, d_model=32,
                            dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def _jparams(layers, heads, key):
    model = jgpt2.GPT2(_cfg(layers, heads))
    params = jax.jit(model.init)(jax.random.PRNGKey(key),
                                 jnp.zeros((1, 16), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, params["params"])


_WORKER = textwrap.dedent('''
    import json, os, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import config
    from horovod_tpu_torch.models import gpt2_pipeline as gp
    from horovod_tpu_torch.models.gpt2 import GPT2Config
    from horovod_tpu_torch.parallel import make_mesh, shard_pytree
    from horovod_tpu_torch.parallel.mp import TensorParallel

    base, cases = sys.argv[2], json.loads(sys.argv[3])
    hvd.init(device="cpu")
    r = hvd.rank()
    out, info = {}, {}
    data = dict(np.load(base + ".inputs.npz"))
    meshes = {}

    def cfg_of(layers, heads):
        return GPT2Config(vocab_size=128, max_seq_len=32, num_layers=layers,
                          num_heads=heads, d_model=32, dtype=torch.float32)

    def params_of(tag):
        return {k[len(tag) + 1:]: torch.tensor(v) for k, v in data.items()
                if k.startswith(tag + ":")}

    def save(tag, loss, gb, gr):
        info[f"{tag}_loss"] = float(loss)
        for k, v in gb.items():
            out[f"{tag}:blocks:{k}"] = v.numpy()
        for k, v in gr.items():
            out[f"{tag}:rest:{k}"] = v.numpy()

    def run(tag, case, tp=None):
        axes, layers, heads, schedule = case[:4]
        key = "x".join(f"{a}{n}" for a, n in axes.items())
        if key not in meshes:
            meshes[key] = make_mesh(axes)
        mesh = meshes[key]
        cfg = cfg_of(layers, heads)
        blocks, rest = gp.make_pp_tp_params(params_of(tag.split("-")[0]),
                                            axes["pp"], heads)
        local = shard_pytree(blocks, mesh, gp.block_specs_tp())
        tokens = torch.tensor(data["tok:" + tag.split("-")[0]]).long()
        make = (gp.gpt2_pp_tp_loss_and_grad if schedule == "gpipe"
                else gp.gpt2_pp_tp_1f1b_loss_and_grad)
        step = make(cfg, mesh.process_set("pp"),
                    tp or mesh.process_set("tp"))
        if "dp" in axes:
            d = mesh.coords(r)["dp"]
            tokens = tokens[:, d:d + 1]
        loss, gb, gr = step(local, rest, tokens)
        if "dp" in axes:
            dp = mesh.process_set("dp")
            loss = hvd.allreduce(loss, process_set=dp)
            gb = {k: hvd.allreduce(g, process_set=dp) for k, g in gb.items()}
            gr = {k: hvd.allreduce(g, process_set=dp) for k, g in gr.items()}
        info[f"{tag}_shapes"] = {k: list(v.shape) for k, v in local.items()}
        save(tag, loss, gb, gr)

    for tag, case in cases.items():
        run(tag, case)

    # A stage body without f: the tp ranks' input cotangents not summed.
    case = cases["pp_tp"]
    mesh = meshes["pp4xtp2"]
    no_f = TensorParallel(mesh.process_set("tp"))
    no_f.f = lambda x: x
    run("pp_tp-no_f", case, tp=no_f)

    # HOROVOD_MP_RULES=off: the pp x tp layout is block_specs_tp's.
    os.environ["HOROVOD_MP_RULES"] = "off"
    config.refresh()
    run("pp_tp-rules_off", case)
    del os.environ["HOROVOD_MP_RULES"]
    config.refresh()

    # The dryrun's pp step over the whole world, the SGD 0.1 update, then
    # 1F1B on the updated weights.
    cfg = cfg_of(8, 2)
    blocks, rest = gp.stack_block_params(params_of("pp"), hvd.size())
    local = {k: v[r:r + 1] for k, v in blocks.items()}
    loss, gb, gr = gp.gpt2_pp_loss_and_grad(cfg)(
        local, rest, torch.tensor(data["tok:pp"]).long())
    local = {k: v - 0.1 * gb[k] for k, v in local.items()}
    rest = {k: v - 0.1 * gr[k] for k, v in rest.items()}
    save("pp_sgd", loss, local, rest)
    loss, _, _ = gp.gpt2_pp_1f1b_loss_and_grad(cfg)(
        local, rest, torch.tensor(data["tok:pp_1f1b"]).long())
    info["pp_1f1b_loss"] = float(loss)

    np.savez(base + f".rank{r}.npz", **out)
    with open(base + f".rank{r}.json", "w") as f:
        json.dump(info, f)
    hvd.shutdown()
''')


def _plain(jblocks):
    """The reference's head-major block tree back in its plain layout."""
    b = jax.tree_util.tree_map(np.asarray, jblocks)
    qkv, out = b["attn"]["qkv"], b["attn"]["out"]
    lead = qkv["kernel"].shape[:2]
    d = qkv["kernel"].shape[2]
    b["attn"] = {"qkv": {"kernel": qkv["kernel"].reshape(lead + (d, 3 * d)),
                         "bias": qkv["bias"].reshape(lead + (3 * d,))},
                 "out": {"kernel": out["kernel"].reshape(lead + (d, d)),
                         "bias": out["bias"]}}
    return b


def _port_state(jblocks, jrest):
    """A reference (S, K, ...) block tree (plain layout) and rest as the
    port's whole state dict."""
    flat = {}
    for path, a in convert.flatten_tree(jblocks).items():
        a = np.asarray(a)
        k_ = a.shape[1]
        for s in range(a.shape[0]):
            for k in range(k_):
                flat[f"h{s * k_ + k}/{path}"] = a[s, k]
    flat.update(convert.flatten_tree(
        jax.tree_util.tree_map(np.asarray, jrest)))
    return convert.gpt2_params_from_jax(flat)


def _ref_case(case, params):
    """The reference's (loss, port-layout block grads, rest grads) of a
    pp x tp (x dp) case, under ``shard_map`` as its test runs it."""
    axes, layers, heads, schedule, seed, shape, _ = case
    cfg = _cfg(layers, heads)
    S = axes["pp"]
    blocks, rest = jgp.make_pp_tp_params(params, S, heads)
    specs = jgp.block_specs_tp("pp", "tp")
    mesh = jmake_mesh(axes, devices=jax.devices()[:WORLD])
    base = (jgp.gpt2_pp_tp_loss_and_grad if schedule == "gpipe"
            else jgp.gpt2_pp_tp_1f1b_loss_and_grad)(cfg, "pp", "tp")

    def step(blocks, rest, toks):
        l, gb, gr = base(blocks, rest, toks)
        if "dp" in axes:
            l = lax.pmean(l, "dp")
            gb = jax.tree_util.tree_map(lambda g: lax.pmean(g, "dp"), gb)
            gr = jax.tree_util.tree_map(lambda g: lax.pmean(g, "dp"), gr)
        return l, gb, gr

    fn = jax.jit(jshard_map(
        step, mesh=mesh,
        in_specs=(specs, JP(), JP(None, "dp") if "dp" in axes else JP()),
        out_specs=(JP(), specs, JP()), check_vma=False))
    loss, g_blocks, g_rest = fn(blocks, rest,
                                jnp.asarray(_tokens(seed, shape)))
    state = _port_state(_plain(g_blocks), g_rest)
    return (float(loss),) + gp.make_pp_tp_params(state, S, heads)


def _ref_pp():
    """The dryrun's pp step, SGD 0.1 update and 1F1B loss after it, under
    ``hvd.spmd`` over the 8 devices."""
    cfg = _cfg(PP["layers"], PP["heads"])
    blocks, rest = jgp.stack_block_params(
        _jparams(PP["layers"], PP["heads"], PP["key"]), WORLD)
    grad_step = jgp.gpt2_pp_loss_and_grad(cfg, axis_name="hvd")

    def pp_step(blocks, rest, tokens):
        l, g_blocks, g_rest = grad_step(blocks, rest, tokens)
        blocks = jax.tree_util.tree_map(lambda p, g: p - LR * g, blocks,
                                        g_blocks)
        rest = jax.tree_util.tree_map(lambda p, g: p - LR * g, rest, g_rest)
        return l, blocks, rest

    specs = dict(in_specs=(JP("hvd"), JP(), JP()),
                 out_specs=(JP(), JP("hvd"), JP()))
    loss, blocks, rest = jhvd.spmd(pp_step, **specs)(
        blocks, rest, jnp.asarray(_tokens(*PP["tokens"])))
    step_1f1b = jgp.gpt2_pp_1f1b_loss_and_grad(cfg, axis_name="hvd")
    l1f, _, _ = jhvd.spmd(step_1f1b, **specs)(
        blocks, rest, jnp.asarray(_tokens(*PP["tokens_1f1b"])))
    return (float(loss),) + gp.stack_block_params(
        _port_state(blocks, rest), WORLD) + (float(l1f),)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The eight-rank world (started first, run beside the reference) and
    the reference: (ranks [(arrays, info)], reference)."""
    tmp = tmp_path_factory.mktemp("pipeline_tp")
    inputs = {}
    for tag, case in CASES.items():
        _, layers, heads, _, seed, shape, key = case
        inputs["tok:" + tag] = _tokens(seed, shape)
        for k, v in convert.gpt2_params_from_jax(
                _jparams(layers, heads, key)).items():
            inputs[f"{tag}:{k}"] = v.numpy()
    inputs["tok:pp"] = _tokens(*PP["tokens"])
    inputs["tok:pp_1f1b"] = _tokens(*PP["tokens_1f1b"])
    for k, v in convert.gpt2_params_from_jax(
            _jparams(PP["layers"], PP["heads"], PP["key"])).items():
        inputs["pp:" + k] = v.numpy()
    np.savez(tmp / "w.inputs.npz", **inputs)
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
         str(WORLD), "--timeout", "200", str(script), REPO, str(tmp / "w"),
         json.dumps(CASES)],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    reference = {tag: _ref_case(case, _jparams(*case[1:3], case[6]))
                 for tag, case in CASES.items()}
    reference["pp"] = _ref_pp()
    _, err = proc.communicate(timeout=260)
    assert proc.returncode == 0, err[-4000:]
    ranks = [(dict(np.load(tmp / f"w.rank{r}.npz")),
              json.load(open(tmp / f"w.rank{r}.json")))
             for r in range(WORLD)]
    return ranks, reference


def _mesh(axes):
    return Mesh(np.arange(WORLD).reshape(tuple(axes.values())),
                tuple(axes))


def _check(ranks, tag, want, axes, tol, rules=None):
    """Every rank's loss, its part of the block gradients under ``rules``
    (default ``block_specs_tp()``) and the whole rest gradients against
    ``want``."""
    loss, blocks, rest = want[:3]
    mesh, rules = _mesh(axes), rules or gp.block_specs_tp()
    for r, (arrs, info) in enumerate(ranks):
        np.testing.assert_allclose(info[f"{tag}_loss"], loss, **LOSS_TOL)
        coords = mesh.coords(r)
        for k, v in blocks.items():
            part = _local_block(v, rules.spec_for(k), mesh, coords)
            np.testing.assert_allclose(arrs[f"{tag}:blocks:{k}"],
                                       part.numpy(),
                                       err_msg=f"rank {r} {k}", **tol)
        for k, v in rest.items():
            got = arrs[f"{tag}:rest:{k}"]
            np.testing.assert_allclose(got, v.numpy(),
                                       err_msg=f"rank {r} {k}", **tol)
            assert np.array_equal(got, ranks[0][0][f"{tag}:rest:{k}"]), k


@pytest.mark.parametrize("tag", ["pp_tp", "pp_tp_dp", "1f1b_tp"])
def test_matches_reference(runs, tag):
    ranks, ref = runs
    axes, schedule = CASES[tag][0], CASES[tag][3]
    _check(ranks, tag, ref[tag], axes,
           GRAD_TOL if schedule == "gpipe" else GRAD_TOL_1F1B)


@pytest.mark.parametrize("tag", ["dryrun_pp_tp", "dryrun_1f1b_tp",
                                 "dryrun_pp_tp_dp"])
def test_dryrun_steps_match_reference(runs, tag):
    ranks, ref = runs
    axes, schedule = CASES[tag][0], CASES[tag][3]
    _check(ranks, tag, ref[tag], axes,
           GRAD_TOL if schedule == "gpipe" else GRAD_TOL_1F1B)


def test_dryrun_pp_step_with_sgd_then_1f1b(runs):
    ranks, ref = runs
    loss, blocks, rest, loss_1f1b = ref["pp"]
    _check(ranks, "pp_sgd", (loss, blocks, rest), {"pp": WORLD},
           dict(rtol=1e-5, atol=1e-6), PartitionRules([(r"", P("pp"))]))
    for _, info in ranks:
        np.testing.assert_allclose(info["pp_1f1b_loss"], loss_1f1b,
                                   rtol=1e-5)


def test_mp_rules_off_leaves_the_pp_tp_layout(runs):
    ranks, _ = runs
    for arrs, info in ranks:
        assert info["pp_tp-rules_off_shapes"] == info["pp_tp_shapes"]
        assert info["pp_tp_shapes"]["attn.qkv.weight"] == [1, 2, 3, 2, 8,
                                                           32]
        for k in arrs:
            if k.startswith("pp_tp:"):
                assert np.array_equal(
                    arrs["pp_tp-rules_off" + k[len("pp_tp"):]], arrs[k]), k


def test_stage_without_f_leaves_the_bar(runs):
    ranks, ref = runs
    _, blocks, _ = ref["pp_tp"]
    mesh, rules = _mesh(CASES["pp_tp"][0]), gp.block_specs_tp()
    worst = 0.0
    for r, (arrs, info) in enumerate(ranks):
        # The forward does not change: f is the identity there.
        np.testing.assert_allclose(info["pp_tp-no_f_loss"], ref["pp_tp"][0],
                                   **LOSS_TOL)
        for k, v in blocks.items():
            want = _local_block(v, rules.spec_for(k), mesh,
                                mesh.coords(r)).numpy()
            err = np.abs(arrs[f"pp_tp-no_f:blocks:{k}"] - want).max()
            worst = max(worst, err / (GRAD_TOL["atol"]
                                      + GRAD_TOL["rtol"] * np.abs(want).max()))
    assert worst > 10, worst


def test_layout_is_the_references_transposed():
    params = _jparams(8, 4, 0)
    jblocks, _ = jgp.make_pp_tp_params(params, 4, 4)
    blocks, _ = gp.make_pp_tp_params(convert.gpt2_params_from_jax(params),
                                     4, 4)
    jq = np.asarray(jblocks["attn"]["qkv"]["kernel"])   # (S, K, D, 3, H, hd)
    np.testing.assert_array_equal(
        blocks["attn.qkv.weight"].numpy(), np.moveaxis(jq, 2, -1))
    np.testing.assert_array_equal(blocks["attn.qkv.bias"].numpy(),
                                  jblocks["attn"]["qkv"]["bias"])
    jo = np.asarray(jblocks["attn"]["out"]["kernel"])   # (S, K, H, hd, D)
    np.testing.assert_array_equal(blocks["attn.out.weight"].numpy(),
                                  np.moveaxis(jo, -1, 2))
    # Each spec is the reference's with the kernels' in-axis moved last.
    jspecs = convert.flatten_tree(jgp.block_specs_tp("pp", "tp"))
    rules = gp.block_specs_tp()
    for path, jspec in jspecs.items():
        jspec = tuple(jspec) + (None,) * (len(blocks[
            convert._port_name("h0/" + path)[len("h.0."):]].shape)
            - len(jspec))
        if path.endswith("kernel"):
            jspec = jspec[:2] + jspec[3:] + jspec[2:3] \
                if path.startswith("attn/qkv") or path.startswith("mlp/fc") \
                else jspec[:2] + jspec[-1:] + jspec[2:-1]
        name = convert._port_name("h0/" + path)[len("h.0."):]
        got = tuple(rules.spec_for(name))
        assert got + (None,) * (len(jspec) - len(got)) == jspec, path
