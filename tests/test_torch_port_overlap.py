"""horovod_tpu_torch's ``DistributedOptimizer(overlap=True)``, error feedback
and ``gradient_predivide_factor`` == horovod_tpu's.

A tiny fp32 GPT-2 (``GPT2Config.tiny``, dense attention) is initialised by
the JAX package and carried to the port (``gpt2_params_from_jax``). On a
spawned two-rank gloo world of the port (half the batch a rank) it trains
3 SGD(0.1) steps with ``overlap=False`` and with ``overlap=True``; the JAX
package trains the same 3 steps with ``DistributedOptimizer(optax.sgd(0.1),
overlap=True)`` under ``hvd.spmd`` with the batch over its 8-device mesh.
The two port runs must give the same parameters bit for bit (the same
buckets reduced by the same lowering, issued in another order), and the
reference's within ``STEP_TOL``: three steps of gradients that agree within
the GPT-2 test's ``GRAD_TOL`` (rtol 1e-3, atol 1e-6), times the learning
rate.

The same world checks what the hooks do: every parameter's hook fires once
a step (GPT-2's tied embedding too), every bucket goes out during the
backward, last bucket first, with one negotiation round at the first step
and none after, and plans that differ between ranks raise on every rank;
a parameter that gets no gradient still lets its bucket go at ``step()``
(its reduced gradient is zeros, as in the reference);
``backward_passes_per_step=2`` and the join mask (``set_alive``) give what
``overlap=False`` gives; a wrapper rebuilt over the same parameters takes
their hooks over, and ``close()`` removes them. Error feedback: under
``Compression.int8`` the residual after a step equals the reference's
``_quantization_residual`` of this rank's gradient, bit for bit, with and
without overlap; over three steps of gradients given exactly, the
parameters and residuals are the reference's quantized algorithm with
error feedback (``rs_ag_int8``), within the tolerances of
``test_error_feedback_under_the_marker_trains_as_the_reference``.
``gradient_predivide_factor`` is held against the reference's torch
frontend (``horovod_tpu.torch``): Average of fp16-compressed gradients of
40000 on every rank overflows fp16 without it and is finite with the
factor set to the world's size: exact on the port's two ranks, within the
rounding of the reference's eight fp16 additions (8 half-ulps) there.
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
from horovod_tpu.optimizer import _quantization_residual

from horovod_tpu_torch.models.convert import gpt2_params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, STEPS, LR = 8, 32, 3, 0.1
STEP_TOL = dict(rtol=1e-4, atol=2e-6)


def _tokens(step):
    return np.random.default_rng(50 + step).integers(0, 256, (B, T)).astype(
        np.int32)


@pytest.fixture(scope="module")
def jax_params():
    cfg = JConfig.tiny(dtype=jnp.float32)
    params = JGPT2(cfg).init(jax.random.PRNGKey(3),
                             jnp.asarray(_tokens(0)))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_steps(jax_params):
    jm = JGPT2(JConfig.tiny(dtype=jnp.float32))
    opt = jhvd.DistributedOptimizer(optax.sgd(LR), overlap=True)
    params = jax.tree_util.tree_map(jnp.asarray, jax_params)
    state = opt.init(params)

    def step(p, s, tok):
        g = jax.grad(lambda p: jloss_fn(jm.apply({"params": p}, tok),
                                        tok))(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s

    sstep = jhvd.spmd(step, in_specs=(P(), P(), P("hvd")),
                      out_specs=(P(), P()))
    for i in range(STEPS):
        params, state = sstep(params, state, jnp.asarray(_tokens(i)))
    return gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray, params))


# Leaves of the error-feedback run: ragged tails, one whole block, mixed
# magnitudes (1e-3 to 1e2), so that blocks and scales differ per leaf.
EF_SIZES = (300, 7, 1000, 256)


def _ef_consts():
    """[rank][step][leaf] gradients of the error-feedback run."""
    rng = np.random.default_rng(7)
    return [[[(rng.standard_normal(n) * 10.0 ** rng.integers(-3, 3))
              .astype(np.float32) for n in EF_SIZES] for _ in range(STEPS)]
            for _ in range(2)]


_WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import collective as C
    from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config, loss_fn

    hvd.init(device="cpu")
    r = hvd.rank()
    data = np.load(sys.argv[2])
    half = data["t0"].shape[0] // 2
    out, info = {}, {}
    issued = []
    real_issue = C._in_step_bucket_async

    def recording(buf, *a, name=None, **k):
        issued.append(name)
        return real_issue(buf, *a, name=name, **k)
    C._in_step_bucket_async = recording

    def model():
        m = GPT2(GPT2Config.tiny(dtype=torch.float32))
        m.load_state_dict({k[2:]: torch.tensor(data[k]) for k in data.files
                           if k.startswith("p:")})
        return m

    def train(tag, steps=3, **kw):
        m = model()
        opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(),
                                                       lr=0.1),
                                       fusion_threshold_bytes=16384, **kw)
        rounds, firings, order = [], [], []
        for i in range(steps):
            tok = torch.tensor(data[f"t{i}"][r * half:(r + 1) * half])
            opt.zero_grad()
            n0 = sum(C.negotiation_stats().values())
            del issued[:]
            loss_fn(m(tok), tok).backward()
            order.append(list(issued))
            opt.step()
            rounds.append(sum(C.negotiation_stats().values()) - n0)
            if opt.last_overlap:
                firings.append(opt.last_overlap)
        for n, p in m.named_parameters():
            out[f"{tag}:{n}"] = p.detach().numpy()
        info[tag] = {"rounds": rounds, "firings": firings, "order": order,
                     "params": len(list(m.parameters()))}
        return m, opt

    train("plain")
    train("overlap", overlap=True)

    # backward_passes_per_step=2 and the join mask, with and without overlap.
    for tag, ov in (("bpps_plain", False), ("bpps_overlap", True)):
        m = model()
        opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(),
                                                       lr=0.1),
                                       backward_passes_per_step=2,
                                       overlap=ov,
                                       fusion_threshold_bytes=16384)
        for i in range(4):
            tok = torch.tensor(data[f"t{i % 3}"][r * half:(r + 1) * half])
            opt.zero_grad()
            alive = 0 if (i == 3 and r == 1) else 1
            opt.set_alive(alive)
            loss_fn(m(tok), tok).backward()
            opt.step(alive=alive)
        for n, p in m.named_parameters():
            out[f"{tag}:{n}"] = p.detach().numpy()

    # A parameter that gets no gradient, on one rank or on all.
    class WithUnused(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(4, 4)
            self.unused = torch.nn.Parameter(torch.ones(3))
            self.sometimes = torch.nn.Parameter(torch.ones(5))

        def forward(self, x):
            y = self.lin(x).sum()
            return y + self.sometimes.sum() if r == 0 else y
    torch.manual_seed(0)
    u = WithUnused()
    opt = hvd.DistributedOptimizer(torch.optim.SGD(u.parameters(), lr=1.0),
                                   overlap=True, fusion_threshold_bytes=64)
    opt.zero_grad()
    u(torch.ones(2, 4)).backward()
    opt.step()
    out["unused"] = u.unused.detach().numpy()
    out["unused_grad"] = u.unused.grad.numpy()
    out["sometimes_grad"] = u.sometimes.grad.numpy()
    info["unused"] = opt.last_overlap

    # Error feedback under the int8 marker: the residual after one step.
    for tag, ov in (("ef_plain", False), ("ef_overlap", True)):
        m = model()
        opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(),
                                                       lr=0.1),
                                       compression=hvd.Compression.int8,
                                       error_feedback=True, overlap=ov,
                                       fusion_threshold_bytes=16384)
        tok = torch.tensor(data["t0"][r * half:(r + 1) * half])
        opt.zero_grad()
        loss_fn(m(tok), tok).backward()
        if not ov:
            for n, p in m.named_parameters():
                out[f"{tag}:grad:{n}"] = p.grad.detach().numpy().copy()
        opt.step()
        res = opt.state_dict()["error_feedback"]
        for (n, _), t in zip(m.named_parameters(), res):
            out[f"{tag}:res:{n}"] = t.numpy().copy()
        hvd.reset_error_feedback(opt)
        assert all(float(t.abs().max()) == 0
                   for t in opt.state_dict()["error_feedback"])

    # Error feedback under the int8 marker over three steps, on gradients
    # the reference can be given exactly: d/dw sum(w * c) = c.
    n_leaves = len([k for k in data.files if k.startswith(f"c0_0_")])
    for tag, ov in (("efsteps_plain", False), ("efsteps_overlap", True)):
        ws = [torch.nn.Parameter(torch.zeros(data[f"c0_0_{j}"].size))
              for j in range(n_leaves)]
        opt = hvd.DistributedOptimizer(torch.optim.SGD(ws, lr=0.5),
                                       compression=hvd.Compression.int8,
                                       error_feedback=True, overlap=ov)
        for step in range(3):
            opt.zero_grad()
            sum((w * torch.tensor(data[f"c{r}_{step}_{j}"])).sum()
                for j, w in enumerate(ws)).backward()
            opt.step()
        for j, w in enumerate(ws):
            out[f"{tag}:{j}"] = w.detach().numpy()
            out[f"{tag}:res{j}"] = opt.state_dict()["error_feedback"][j] \
                .numpy()

    # The optimizer rebuilt over the same parameters, after a step and a
    # backward with no step: the new wrapper takes the hooks over, the
    # old one's fire no more, and once dropped it is freed.
    import gc
    import weakref
    m = model()

    def wrap():
        return hvd.DistributedOptimizer(
            torch.optim.SGD(m.parameters(), lr=0.1), overlap=True,
            fusion_threshold_bytes=16384)

    def backward(i):
        tok = torch.tensor(data[f"t{i}"][r * half:(r + 1) * half])
        loss_fn(m(tok), tok).backward()
    first = wrap()
    first.zero_grad()
    backward(0)
    first.step()
    first.zero_grad()
    backward(1)                  # no step: its buckets went out
    aborted = first._ov.firings
    first.zero_grad()
    second = wrap()
    for i in (1, 2):
        second.zero_grad()
        backward(i)
        second.step()
    info["rewrap"] = {"old_firings": [aborted, first._ov.firings],
                      "new": second.last_overlap}
    gone = weakref.ref(first)
    del first
    gc.collect()
    info["rewrap"]["old_freed"] = gone() is None
    for n, p in m.named_parameters():
        out[f"rewrap:{n}"] = p.detach().numpy().copy()
    # close(): no hook fires; step() still reduces every gradient.
    second.close()
    second.zero_grad()
    backward(0)
    info["rewrap"]["closed_quiet"] = second._ov is None
    second.step()
    info["rewrap"]["closed_step"] = second.last_overlap

    # gradient_predivide_factor: fp16 wire, 40000 on every rank.
    for tag, f in (("pre1", 1.0), ("pre2", 2.0)):
        w = torch.zeros(4, requires_grad=True)
        opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                       compression=hvd.Compression.fp16,
                                       gradient_predivide_factor=f)
        (w * 40000.0).sum().backward()
        opt.step()
        out[tag] = w.detach().numpy()
    # Plans that differ between ranks: every rank raises, before any
    # bucket goes out (the last collective of this world).
    odd = torch.nn.Parameter(torch.ones(4 + r))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([odd], lr=1.0),
                                   overlap=True)
    try:
        odd.sum().backward()
        out["mismatch_raised"] = np.array(False)
    except RuntimeError as e:
        out["mismatch_raised"] = np.array("mismatch" in str(e))
    np.savez(sys.argv[3] + f".rank{r}.npz", **out)
    with open(sys.argv[3] + f".rank{r}.json", "w") as fh:
        json.dump(info, fh)
    hvd.shutdown()
""")


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_params):
    import json
    tmp = tmp_path_factory.mktemp("overlap")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    data = tmp / "data.npz"
    sd = gpt2_params_from_jax(jax_params)
    np.savez(data, **{f"t{i}": _tokens(i) for i in range(STEPS)},
             **{f"p:{k}": v.numpy() for k, v in sd.items()},
             **{f"c{r}_{s}_{j}": c for r, steps in enumerate(_ef_consts())
                for s, leaves in enumerate(steps)
                for j, c in enumerate(leaves)})
    out = tmp / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--timeout", "280", str(script), REPO, str(data), str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=320)
    assert r.returncode == 0, r.stderr[-3000:]
    return [(dict(np.load(f"{out}.rank{i}.npz")),
             json.load(open(f"{out}.rank{i}.json"))) for i in range(2)]


def _params(res, tag):
    return {k.split(":", 1)[1]: v for k, v in res.items()
            if k.startswith(tag + ":")}


def test_overlap_gives_the_parameters_of_overlap_off(world):
    for res, _ in world:
        plain, ov = _params(res, "plain"), _params(res, "overlap")
        assert set(plain) == set(ov) and plain
        for name in plain:
            np.testing.assert_array_equal(ov[name], plain[name], name)


def test_overlap_matches_the_reference_after_three_steps(world, jax_steps):
    ov = _params(world[0][0], "overlap")
    assert set(ov) == set(jax_steps)
    for name, want in jax_steps.items():
        np.testing.assert_allclose(ov[name], want.numpy(), err_msg=name,
                                   **STEP_TOL)
    for name in ov:
        np.testing.assert_array_equal(ov[name],
                                      _params(world[1][0], "overlap")[name])


def test_hooks_fire_once_a_parameter_and_buckets_go_in_reverse(world):
    for _, info in world:
        ov = info["overlap"]
        for f in ov["firings"]:
            assert f["firings"] == ov["params"]
            assert f["issued_in_backward"] == f["buckets"] > 1
        for order in ov["order"]:
            idx = [int(n.rsplit("bucket", 1)[1]) for n in order]
            assert idx == sorted(idx, reverse=True) and idx[0] == len(idx) - 1
        # One round at the first step (the plan), none after; overlap off
        # takes one a step (its grouped allreduce).
        assert ov["rounds"] == [1, 0, 0]
        assert info["plain"]["rounds"] == [1, 1, 1]


def test_plans_that_differ_raise_on_every_rank(world):
    for res, _ in world:
        assert bool(res["mismatch_raised"])


def test_unused_parameter_still_lets_its_bucket_go(world):
    for r, (res, info) in enumerate(world):
        np.testing.assert_array_equal(res["unused_grad"], np.zeros(3))
        np.testing.assert_array_equal(res["unused"], np.ones(3))
        # Rank 0's gradient of ones, averaged with rank 1's zeros.
        np.testing.assert_array_equal(res["sometimes_grad"], np.full(5, 0.5))
        assert info["unused"]["buckets"] > 1


def test_backward_passes_per_step_and_join_mask_under_overlap(world):
    for res, _ in world:
        plain = _params(res, "bpps_plain")
        ov = _params(res, "bpps_overlap")
        for name in plain:
            np.testing.assert_array_equal(ov[name], plain[name], name)
        # The masked step moved the parameters (rank 0 alone was alive).
        assert any(not np.array_equal(plain[n], _params(res, "plain")[n])
                   for n in plain)


@pytest.mark.parametrize("tag", ["ef_plain", "ef_overlap"])
def test_error_feedback_residual_matches_the_reference(world, tag):
    for res, _ in world:
        grads = {k.split(":", 2)[2]: v for k, v in res.items()
                 if k.startswith("ef_plain:grad:")}
        want = _quantization_residual(
            {k: jnp.asarray(v) for k, v in grads.items()}, "int8")
        for name, g in grads.items():
            got = res[f"{tag}:res:{name}"]
            np.testing.assert_array_equal(got, np.asarray(want[name]), name)
            assert np.abs(got).max() <= np.abs(g).max() / 254 * 1.0001


@pytest.mark.parametrize("tag", ["efsteps_plain", "efsteps_overlap"])
def test_error_feedback_under_the_marker_trains_as_the_reference(world, tag):
    """The port's ``Compression.int8`` with error feedback quantizes each
    tensor as the reference's quantized algorithm does and carries the
    residual of the same geometry. The reference's error feedback reads
    only the algorithm and the wire (its residual stays zero under the
    marker alone), so the run with the same semantics there is
    ``allreduce_gradients(algorithm="rs_ag_int8", error_feedback=)`` over
    the process set of ranks 0 and 1: three SGD(0.5) steps of the same
    gradients. The reference's compiled step may contract a multiply and
    an add (one rounding fewer), so: the residuals lie within one ulp of
    twice the leaf's largest gradient (a bound on the compensated value);
    the reduced values take the tolerance of
    ``test_torch_port_quantized.py`` (a re-quantized value may move by one
    step, max-abs / 127), so every parameter lies within 0.5 x the sum
    over the steps of one step of the leaf, and 99 % within 1e-5 of the
    leaf's largest parameter."""
    from horovod_tpu.optimizer import allreduce_gradients
    from jax.sharding import PartitionSpec as P
    consts = _ef_consts()
    ps = jhvd.add_process_set([0, 1])
    try:
        step = jhvd.spmd(
            lambda g, e: allreduce_gradients(
                g, process_set=ps, algorithm="rs_ag_int8", error_feedback=e),
            in_specs=(P("hvd"), P("hvd")), out_specs=(P("hvd"), P("hvd")))
        res = {j: jnp.zeros((jhvd.size(), n), jnp.float32)
               for j, n in enumerate(EF_SIZES)}
        w = [np.zeros(n, np.float32) for n in EF_SIZES]
        bound = [0.0] * len(EF_SIZES)
        for s in range(STEPS):
            g = {j: jnp.asarray(np.stack(
                [consts[r][s][j] for r in range(2)]
                + [np.zeros(n, np.float32)] * (jhvd.size() - 2)))
                for j, n in enumerate(EF_SIZES)}
            out, res = step(g, res)
            for j in range(len(EF_SIZES)):
                o = np.asarray(out[j])[0]
                w[j] = w[j] - np.float32(0.5) * o
                bound[j] += 0.5 * float(np.abs(o).max()) / 127
    finally:
        jhvd.remove_process_set(ps)
    for r, (got, _) in enumerate(world):
        for j in range(len(EF_SIZES)):
            np.testing.assert_allclose(got[f"{tag}:{j}"], w[j], rtol=0,
                                       atol=bound[j], err_msg=str(j))
            close = np.abs(got[f"{tag}:{j}"] - w[j]) \
                <= 1e-5 * np.abs(w[j]).max()
            assert close.mean() >= 0.99, (j, close.mean())
            top = max(float(np.abs(consts[r][s][j]).max())
                      for s in range(STEPS))
            np.testing.assert_allclose(
                got[f"{tag}:res{j}"], np.asarray(res[j])[r], rtol=0,
                atol=float(np.spacing(np.float32(2 * top))), err_msg=str(j))
        assert any(np.abs(got[f"{tag}:res{j}"]).max() > 0
                   for j in range(len(EF_SIZES)))


def test_rebuilt_optimizer_takes_the_hooks_over(world):
    """A second ``overlap=True`` wrapper over the same parameters, built
    after a step and an aborted backward of the first, trains as one
    wrapper does (the parameters of overlap off after three steps, bit
    for bit); the first wrapper's hooks fire no more and, dropped, it is
    freed; after ``close()`` no hook fires and ``step()`` reduces every
    gradient at the step."""
    for res, info in world:
        plain = _params(res, "plain")
        again = _params(res, "rewrap")
        assert set(again) == set(plain)
        for name in plain:
            np.testing.assert_array_equal(again[name], plain[name], name)
        rw = info["rewrap"]
        n = info["overlap"]["params"]
        assert rw["old_firings"] == [n, n]
        assert rw["new"]["firings"] == n
        assert rw["new"]["issued_in_backward"] == rw["new"]["buckets"]
        assert rw["old_freed"] and rw["closed_quiet"]
        assert rw["closed_step"]["firings"] == 0
        assert rw["closed_step"]["issued_in_backward"] == 0


def test_gradient_predivide_factor_matches_the_torch_frontend(world):
    import horovod_tpu.torch as jtorch
    got = {}
    for f in (1.0, float(jhvd.size())):
        w = torch.zeros(4, requires_grad=True)
        opt = jtorch.DistributedOptimizer(
            torch.optim.SGD([w], lr=1.0),
            compression=jtorch.Compression.fp16,
            gradient_predivide_factor=f)
        (w * 40000.0).sum().backward()
        opt.step()
        got[f] = w.detach().numpy()
    # Without the factor the fp16 sum overflows in both packages.
    assert not np.isfinite(got[1.0]).all()
    for res, _ in world:
        assert not np.isfinite(res["pre1"]).all()
        np.testing.assert_array_equal(res["pre2"], np.full(4, -40000.0))
        # The reference's 8 fp16 contributions of 5000 are summed in fp16
        # one by one (25000 and up round to 16 and 32): 39968.
        np.testing.assert_allclose(res["pre2"], got[float(jhvd.size())],
                                   rtol=8 * 2 ** -11)


def test_predivide_factor_is_validated():
    import horovod_tpu_torch as hvd
    w = torch.zeros(2, requires_grad=True)
    with pytest.raises(ValueError, match="gradient_predivide_factor"):
        hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                 gradient_predivide_factor=0.0)
    with pytest.raises(ValueError, match="unknown allreduce algorithm"):
        hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                 algorithm="ring")


def test_error_feedback_defaults_on_for_a_quantized_algorithm(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import config
    w = torch.zeros(2, requires_grad=True)
    sgd = torch.optim.SGD([w], lr=1.0)
    assert hvd.DistributedOptimizer(sgd, algorithm="rs_ag_int8")._ef
    assert not hvd.DistributedOptimizer(sgd)._ef
    assert not hvd.DistributedOptimizer(
        sgd, algorithm="rs_ag_int8", error_feedback=False)._ef
    monkeypatch.setenv("HOROVOD_ALLREDUCE_ALGORITHM", "chunked_rs_ag_int8")
    config.refresh()
    try:
        assert hvd.DistributedOptimizer(sgd)._ef
    finally:
        monkeypatch.delenv("HOROVOD_ALLREDUCE_ALGORITHM")
        config.refresh()


@pytest.mark.parametrize("out_of_order", [True, False])
def test_bucket_filler_issues_full_buckets_in_reverse(out_of_order):
    """Six tensors in buckets of the reference's plan. A full bucket waits
    for every later bucket (the order is pinned, the reference's
    ``pin_order=True``): tensors that become ready out of order hold their
    buckets back; in the backward's order (last tensor first) each bucket
    goes as soon as it is full. ``rest`` hands out the others."""
    from horovod_tpu.fusion import fuse as jfuse
    from horovod_tpu_torch import fusion
    sizes = [100, 100, 300, 50, 700, 10]
    plan = fusion.make_plan(sizes, [torch.float32] * 6, 1024)
    # The plan is the reference's: the same buckets for the same tensors.
    jbuckets, _ = jfuse([jnp.zeros(n) for n in sizes], 1024)
    assert [sum(plan.padded_len(s) for s in segs) for segs in plan.buckets] \
        == [int(b.size) for b in jbuckets]
    # Buckets: [t0 t1] [t2a] [t2b t3] [t4a] [t4b] [t4c] [t5].
    assert plan.buckets == [[0, 1], [2], [3, 4], [5], [6], [7], [8]]
    f = fusion.BucketFiller(plan, reverse=True)
    if out_of_order:
        got = [f.mark(i) for i in (0, 1, 5, 4)] + [f.rest()]
        assert got == [[], [], [6], [5, 4, 3], [2, 1, 0]]
    else:
        got = [f.mark(i) for i in (5, 4, 3, 2, 1, 0)] + [f.rest()]
        assert got == [[6], [5, 4, 3], [], [2, 1], [], [0], []]
    f.reset()
    assert f.rest() == list(fusion.issue_order(len(plan.buckets), True))
