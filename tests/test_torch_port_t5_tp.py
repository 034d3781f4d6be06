"""T5 under tensor parallelism in horovod_tpu_torch == the reference's GSPMD
T5: ``models/t5.py``'s ``partition_rules()`` applied by ``shard_pytree`` on
``make_mesh({"dp": 2, "tp": 4})`` (``tests/test_t5.py:142-169``, the
dryrun's step at ``__graft_entry__.py:477-510``).

One spawned gloo world of eight ranks, dp 2 x tp 4, wires a tiny T5 with
``mp.tensor_parallel(model, mesh.process_set("tp"))``; each dp row takes
its slice of the batch. Weights are the reference's init carried over
with ``t5_params_from_jax``; the inputs come from numpy with a seed.

* Gradients, batch 2 x 24 source / 16 target tokens, without and with
  padded source tails (the cross attention's key mask): each rank's
  gradient, averaged over the dp line, equals its slice of the
  reference's one-device gradient, in bf16 at the reference test's bar
  (rtol 5e-2, atol 1e-2) and in fp32 at rtol 1e-4, atol 1e-6 (the bar of
  GPT-2's and Llama's tensor-parallel gradients in
  ``tests/test_torch_port_tp_train.py``). The rows' mean loss is the
  reference's (rtol 1e-5 in fp32, 1e-3 in bf16).
* The replicated parameters: both ``rel_bias`` tables' and every
  RMSNorm weight's gradients are identical on the four tp ranks and are
  the reference's whole gradients. With the f on the tables taken out,
  each rank keeps only its own heads' columns and the tables' gradients
  leave the fp32 bar.
* The dryrun step: ``T5Config.tiny()`` (bf16) and its fp32 twin, batch
  4 x 24 / 16, one AdamW step (lr 1e-3, weight decay 1e-4, the
  reference's ``hvd.DistributedOptimizer(optax.adamw(1e-3))``, the
  port's ``DistributedOptimizer`` over the dp line). Adam's first update
  is lr times the sign of each gradient element, so an element whose
  gradient is near 0 may move by up to 2 lr where the two sums round
  differently (``tests/test_torch_port_tp_train.py``). fp32: the loss
  within rtol 1e-5 and every parameter within rtol 1e-5, atol 1e-4 (a
  tenth of lr). bf16: the loss within rtol 1e-3; parameters whose
  reference gradient exceeds the bf16 gradient bar (1e-2) within atol
  1e-4, every other element within 2 lr.
* The rules cover every port parameter, and each flax path's spec maps
  to its port name's, transposed for the (out, in) weights.
* The refusals: ``validate_tp``, ``mp_partition_rules``, ``split_params``
  and ``tp_decode_step`` refuse T5 with the reference's error (and
  ``merge_params`` refuses it); ``t5_generate`` and the T5 decode step
  refuse a split model; ``tensor_parallel`` refuses ``sp=`` / ``ep=`` and
  a line that does not divide the heads; ``HOROVOD_MP_RULES=off`` leaves
  T5's split and gradients as they are.
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
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import horovod_tpu as jhvd
from horovod_tpu.models import t5 as jt5
from horovod_tpu.parallel import make_mesh as jmake_mesh
from horovod_tpu.parallel import mp as jmp
from horovod_tpu.parallel import shard_pytree as jshard_pytree

from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import t5
from horovod_tpu_torch.parallel import mp
from horovod_tpu_torch.parallel.sharding import P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DP, TP = 2, 4
LR, WD = 1e-3, 1e-4
CASES = [f"{batch}-{dt}" for batch in ("plain", "padded")
         for dt in ("bf16", "fp32")]
GRAD_TOL = {"bf16": dict(rtol=5e-2, atol=1e-2),
            "fp32": dict(rtol=1e-4, atol=1e-6)}
LOSS_RTOL = {"bf16": 1e-3, "fp32": 1e-5}
PARAM_TOL = dict(rtol=1e-5, atol=1e-4)
JDT = {"bf16": jnp.bfloat16, "fp32": jnp.float32}


def _grad_batch(padded):
    """test_t5.py's batch: 2 x 24 source and 2 x 16 target ids, from the
    seed of its ``rng`` fixture; ``padded`` pads two source tails."""
    g = np.random.default_rng(42)
    src = g.integers(1, 256, (2, 24)).astype(np.int32)
    tgt = g.integers(1, 256, (2, 16)).astype(np.int32)
    if padded:
        src[0, -6:] = 0
        src[1, -11:] = 0
    return src, tgt


def _step_batch():
    """The dryrun's batch: 2 * dp rows of 24 source and 16 target ids."""
    g = np.random.default_rng(13)
    src = g.integers(1, 256, (2 * DP, 24)).astype(np.int32)
    tgt = g.integers(1, 256, (2 * DP, 16)).astype(np.int32)
    return src, tgt


@functools.lru_cache(maxsize=None)
def _jparams(key, step):
    """The reference's init of the tiny T5 with ``PRNGKey(key)`` on the
    gradient batch or (``step``) the dryrun's."""
    src, tgt = _step_batch() if step else _grad_batch(False)
    model = jt5.T5(jt5.T5Config.tiny(dtype=jnp.float32))
    params = jax.jit(model.init)(jax.random.PRNGKey(key), jnp.asarray(src),
                                 jt5.shift_right(jnp.asarray(tgt), 0))
    return jax.tree_util.tree_map(np.asarray, params["params"])


_WORKER = textwrap.dedent('''
    import json, os, sys, types
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import config
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models import generate as G
    from horovod_tpu_torch.models.t5 import T5, T5Config, seq2seq_loss
    from horovod_tpu_torch.parallel import make_mesh, mp

    LR, WD = 1e-3, 1e-4
    DT = {"bf16": torch.bfloat16, "fp32": torch.float32}
    base = sys.argv[2]
    hvd.init(device="cpu")
    r = hvd.rank()
    mesh = make_mesh({"dp": 2, "tp": 4})
    d = mesh.coords(r)["dp"]
    tp_set, dp_set = mesh.process_set("tp"), mesh.process_set("dp")
    out, info = {}, {"errors": {}}

    def load(name):
        return [torch.tensor(np.load(base + f".{name}.{x}.npy")).long()
                for x in ("src", "tgt")]

    def build(tag, dt, **kw):
        m = T5(T5Config.tiny(dtype=DT[dt], **kw))
        m.load_state_dict(convert.t5_params_from_jax(
            dict(np.load(base + f".{tag}.npz"))))
        return m

    def dp_grads(m, src, tgt):
        loss = seq2seq_loss(m, src, tgt)
        loss.backward()
        return loss.item(), {n: hvd.allreduce(p.grad, process_set=dp_set)
                             for n, p in m.named_parameters()}

    for case in json.loads(sys.argv[3]):
        batch, dt = case.split("-")
        src, tgt = load(batch)
        m = mp.tensor_parallel(build("grad", dt), tp_set)
        info[case], grads = dp_grads(m, src[d:d + 1], tgt[d:d + 1])
        for n, g in grads.items():
            out[f"{case}:grad:{n}"] = g.numpy()

    # The tables without their f: each rank keeps its own heads' columns.
    src, tgt = load("plain")
    m = mp.tensor_parallel(build("grad", "fp32"), tp_set)
    for rb in (m.enc_rel, m.dec_rel):
        rb.tp = types.SimpleNamespace(f=lambda x: x, size=rb.tp.size,
                                      rank=rb.tp.rank)
    _, grads = dp_grads(m, src[d:d + 1], tgt[d:d + 1])
    for n in ("enc_rel.rel_bias", "dec_rel.rel_bias"):
        out[f"no_f:grad:{n}"] = grads[n].numpy()

    # HOROVOD_MP_RULES=off: T5 splits by its own rules all the same.
    os.environ["HOROVOD_MP_RULES"] = "off"
    config.refresh()
    m = mp.tensor_parallel(build("grad", "fp32"), tp_set)
    info["rules_off_shapes"] = {n: list(p.shape)
                                for n, p in m.named_parameters()}
    _, grads = dp_grads(m, src[d:d + 1], tgt[d:d + 1])
    info["rules_off_same_grads"] = all(
        np.array_equal(g.numpy(), out[f"plain-fp32:grad:{n}"])
        for n, g in grads.items())
    del os.environ["HOROVOD_MP_RULES"]
    config.refresh()

    # The dryrun's dp x tp step: one AdamW step over the dp line.
    src, tgt = load("step")
    rows = slice(2 * d, 2 * d + 2)
    for dt in ("bf16", "fp32"):
        m = mp.tensor_parallel(build("step", dt), tp_set)
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            m.parameters(), lr=LR, weight_decay=WD, eps=1e-8),
            process_set=dp_set)
        opt.zero_grad()
        loss = seq2seq_loss(m, src[rows], tgt[rows])
        loss.backward()
        opt.step()
        info[f"step-{dt}"] = loss.item()
        for n, p in m.named_parameters():
            out[f"step-{dt}:param:{n}"] = p.detach().numpy()

    # Refusals on a split model and on lines it cannot take.
    def error(label, fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 -- the message is the result
            info["errors"][label] = [type(e).__name__, str(e)]

    src, tgt = load("plain")
    cfg = m.cfg
    error("t5_generate", lambda: G.t5_generate(m, src, 2))
    error("decode_step", lambda: G.decode_step(cfg)(
        m, G.init_cache(cfg, 2, 2), tgt[:, 0], 0,
        {"cross": None, "src_mask": src != 0, "dec_bias": None}))
    error("sp", lambda: mp.tensor_parallel(build("grad", "fp32"), tp_set,
                                           sp=tp_set))
    error("ep", lambda: mp.tensor_parallel(build("grad", "fp32"), tp_set,
                                           ep=tp_set))
    error("heads", lambda: mp.tensor_parallel(
        T5(T5Config.tiny(num_heads=6)), tp_set))
    np.savez(base + f".rank{r}.npz", **out)
    with open(base + f".rank{r}.json", "w") as f:
        json.dump(info, f)
    hvd.shutdown()
''')


def _reference(params, step_params):
    """The reference's one-device gradients and losses of each case, and
    the dryrun's GSPMD step in bf16 and fp32: (grads {case: port-named
    grads}, losses {case: loss}, steps {dt: (loss, port-named params)})."""
    grads, losses, steps = {}, {}, {}
    p = jax.tree_util.tree_map(jnp.asarray, params)
    for dt in ("bf16", "fp32"):
        model = jt5.T5(jt5.T5Config.tiny(dtype=JDT[dt]))
        fn = jax.jit(lambda p, s, t, model=model: jax.value_and_grad(
            lambda p: jt5.seq2seq_loss(model, p, s, t))(p))
        for batch in ("plain", "padded"):
            src, tgt = _grad_batch(batch == "padded")
            loss, g = fn(p, jnp.asarray(src), jnp.asarray(tgt))
            losses[f"{batch}-{dt}"] = float(loss)
            grads[f"{batch}-{dt}"] = convert.t5_params_from_jax(
                jax.tree_util.tree_map(np.asarray, g))
    mesh = jmake_mesh({"dp": DP, "tp": TP}, devices=jax.devices()[:8])
    src, tgt = (jax.device_put(jnp.asarray(x), NamedSharding(mesh, JP("dp")))
                for x in _step_batch())
    for dt in ("bf16", "fp32"):
        model = jt5.T5(jt5.T5Config.tiny(dtype=JDT[dt]))
        sp = jshard_pytree(jax.tree_util.tree_map(jnp.asarray, step_params),
                           mesh, jt5.partition_rules())
        opt = jhvd.DistributedOptimizer(optax.adamw(LR))
        st = opt.init(sp)

        def step(p, st, s, t, model=model, opt=opt):
            loss, g = jax.value_and_grad(
                lambda p: jt5.seq2seq_loss(model, p, s, t))(p)
            u, st = opt.update(g, st, p)
            return optax.apply_updates(p, u), st, loss, g

        with jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else mesh:
            sp, st, loss, g = jax.jit(step)(sp, st, src, tgt)
        steps[dt] = (float(loss), convert.t5_params_from_jax(
            jax.tree_util.tree_map(np.asarray, sp)),
            convert.t5_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              g)))
    return grads, losses, steps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The eight-rank world (started first, run beside the reference) and
    the reference: (ranks [(arrays, info)], reference)."""
    tmp = tmp_path_factory.mktemp("t5_tp")
    for name, (src, tgt) in (("plain", _grad_batch(False)),
                             ("padded", _grad_batch(True)),
                             ("step", _step_batch())):
        np.save(tmp / f"w.{name}.src.npy", src)
        np.save(tmp / f"w.{name}.tgt.npy", tgt)
    params, step_params = _jparams(0, False), _jparams(9, True)
    np.savez(tmp / "w.grad.npz", **convert.flatten_tree(params))
    np.savez(tmp / "w.step.npz", **convert.flatten_tree(step_params))
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
         str(DP * TP), "--timeout", "200", str(script), REPO, str(tmp / "w"),
         json.dumps(CASES)],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    reference = _reference(params, step_params)
    _, err = proc.communicate(timeout=260)
    assert proc.returncode == 0, err[-4000:]
    ranks = [(dict(np.load(tmp / f"w.rank{r}.npz")),
              json.load(open(tmp / f"w.rank{r}.json")))
             for r in range(DP * TP)]
    return ranks, reference


def _split(tree, r):
    """Rank ``r``'s tp part of a port-named tree (its tp coordinate)."""
    return mp._split_t5(t5.T5Config.tiny(), tree, TP, r % TP)


def _whole_names(names):
    rules = t5.partition_rules()
    return [n for n in names if rules.spec_for(n) == P()]


@pytest.mark.parametrize("case", CASES)
def test_each_ranks_gradient_is_its_slice_of_the_reference(runs, case):
    ranks, (grads, losses, _) = runs
    dt = case.split("-")[1]
    rows = [ranks[d * TP][1][case] for d in range(DP)]
    for d in range(DP):
        assert all(info[case] == rows[d]
                   for _, info in ranks[d * TP:(d + 1) * TP])
    np.testing.assert_allclose(np.mean(rows), losses[case],
                               rtol=LOSS_RTOL[dt])
    for r, (arrs, _) in enumerate(ranks):
        want = _split(grads[case], r)
        key = f"{case}:grad:"
        got = {k[len(key):]: v for k, v in arrs.items()
               if k.startswith(key)}
        assert set(got) == set(want)
        for n in sorted(want):
            assert got[n].shape == tuple(want[n].shape), n
            np.testing.assert_allclose(got[n], want[n].numpy(),
                                       err_msg=f"rank {r} {n}",
                                       **GRAD_TOL[dt])


@pytest.mark.parametrize("case", CASES)
def test_replicated_gradients_identical_on_tp_ranks_and_whole(runs, case):
    ranks, (grads, _, _) = runs
    dt = case.split("-")[1]
    whole = _whole_names(grads[case])
    cfg = t5.T5Config.tiny()
    assert len(whole) == 2 + 2 * cfg.num_encoder_layers \
        + 3 * cfg.num_decoder_layers + 2
    for n in whole:
        first = ranks[0][0][f"{case}:grad:{n}"]
        for arrs, _ in ranks:
            assert np.array_equal(arrs[f"{case}:grad:{n}"], first), n
        np.testing.assert_allclose(first, grads[case][n].numpy(),
                                   err_msg=n, **GRAD_TOL[dt])


def test_leaving_out_the_tables_f_breaks_their_gradients(runs):
    ranks, (grads, _, _) = runs
    for n in ("enc_rel.rel_bias", "dec_rel.rel_bias"):
        want = grads["plain-fp32"][n].numpy()
        tol = GRAD_TOL["fp32"]
        for r, (arrs, _) in enumerate(ranks):
            np.testing.assert_allclose(arrs[f"plain-fp32:grad:{n}"], want,
                                       **tol)
            bad = arrs[f"no_f:grad:{n}"]
            h = want.shape[1] // TP
            own = slice((r % TP) * h, (r % TP + 1) * h)
            # Its own heads' columns are right, the others are zero.
            np.testing.assert_allclose(bad[:, own], want[:, own], **tol)
            assert not np.any(np.delete(bad, np.s_[own], axis=1))
            assert np.abs(bad - want).max() > 1e3 * tol["atol"]


@pytest.mark.parametrize("dt", ["bf16", "fp32"])
def test_dryrun_dp_x_tp_step_equals_the_reference(runs, dt):
    ranks, (_, _, steps) = runs
    loss, params, g = steps[dt]
    rows = [ranks[d * TP][1][f"step-{dt}"] for d in range(DP)]
    np.testing.assert_allclose(np.mean(rows), loss, rtol=LOSS_RTOL[dt])
    for r, (arrs, _) in enumerate(ranks):
        want, grad = _split(params, r), _split(g, r)
        key = f"step-{dt}:param:"
        for n in sorted(want):
            got, w = arrs[key + n], want[n].numpy()
            if dt == "fp32":
                np.testing.assert_allclose(got, w, err_msg=n, **PARAM_TOL)
                continue
            # A sign that bf16 rounding may flip moves by up to 2 lr.
            np.testing.assert_allclose(got, w, rtol=0, atol=2 * LR + 1e-5,
                                       err_msg=n)
            big = np.abs(grad[n].numpy()) > GRAD_TOL["bf16"]["atol"]
            np.testing.assert_allclose(got[big], w[big], err_msg=n,
                                       **PARAM_TOL)


def test_partition_rules_cover_every_parameter_as_the_reference():
    cfg = t5.T5Config.tiny()
    with torch.device("meta"):
        names = [n for n, _ in t5.T5(cfg).named_parameters()]
    rules = t5.partition_rules()
    kinds = {}
    for n in names:
        spec = tuple(rules.spec_for(n))
        leaf = n.split(".")[-2] if n.endswith(".weight") else n
        kinds.setdefault(spec, set()).add(leaf.split(".")[-1])
    assert kinds == {
        ("tp", None): {"q", "k", "v", "wi_0", "wi_1", "embedding",
                       "lm_head"},
        (None, "tp"): {"o", "wo"},
        (): {"rel_bias", "ln1", "ln2", "ln3", "enc_norm", "dec_norm"}}
    # Every flax path's spec is its port name's, transposed for a kernel.
    jparams = _jparams(0, False)
    jrules = jt5.partition_rules()
    flat = convert.flatten_tree(jparams)
    assert {convert._port_name(k) for k in flat} == set(names)
    for path, leaf in flat.items():
        want = tuple(jrules.spec_for(path))
        if path.endswith("/kernel"):
            want = tuple(reversed(want + (None,) * (2 - len(want))))
        got = tuple(rules.spec_for(convert._port_name(path)))
        assert got == want, path
    # No rule lets "o" take "wo" or "q" take a name that ends in "q".
    assert tuple(rules.spec_for("dec.0.mlp.wo.weight")) == (None, "tp")
    assert tuple(rules.spec_for("x.seq.weight")) == ()


def _message(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


def test_reference_refusals_kept():
    cfg, jcfg = t5.T5Config.tiny(), jt5.T5Config.tiny()
    for port, ref in (
            (lambda: mp.validate_tp(cfg, TP),
             lambda: jmp.validate_tp(jcfg, TP)),
            (lambda: mp.mp_partition_rules(cfg, "megatron"),
             lambda: jmp.mp_partition_rules(jcfg, "megatron")),
            (lambda: mp.split_params(cfg, {}, TP, 0),
             lambda: jmp.split_params(jcfg, {}, TP, 0)),
            (lambda: mp.tp_decode_step(cfg),
             lambda: jmp.tp_decode_step(jcfg))):
        assert _message(port) == _message(ref)
    assert _message(lambda: mp.merge_params(cfg, [{}, {}]))[0] == \
        "NotImplementedError"


def test_split_model_refusals(runs):
    ranks, _ = runs
    for _, info in ranks:
        errs = info["errors"]
        for label in ("t5_generate", "decode_step"):
            assert errs[label][0] == "NotImplementedError", errs
            assert "tensor-parallel" in errs[label][1]
        for label in ("sp", "ep", "heads"):
            assert errs[label][0] == "ValueError", errs
        assert "num_heads=6" in errs["heads"][1]


def test_mp_rules_off_leaves_t5_split(runs):
    ranks, (grads, _, _) = runs
    want = {n: list(v.shape) for n, v in _split(grads["plain-fp32"],
                                                0).items()}
    for _, info in ranks:
        assert info["rules_off_shapes"] == want
        assert info["rules_off_same_grads"]
    assert want["embedding"][0] == 256 // TP
