"""Collectives inside the training step, on a spawned four-rank gloo world.

* Cross-replica batch norm's moments are in-step allreduces, as the
  reference's ``pmean`` runs inside its jitted step: they take no
  negotiation round and count ``collective_traced_total``, and two ranks
  may use a set that the other two do not (batch-norm groups {0, 1} and
  {2, 3}). Each rank's output, input gradient and running statistics must
  equal the reference's ``TunableBatchNorm`` over its set's whole batch
  (the loss being the sum of the ranks' losses), within 1e-5 / 1e-6.
* ``HOROVOD_METRICS_GRAD_NORM=1``: ``DistributedOptimizer.step`` records the
  ``optimizer_grad_norm`` gauge, on the grouped path and on the ``alive``
  path (rank 3 out of data). The gauge must equal what the reference's
  ``_maybe_record_grad_norm`` records for the same reduced gradients
  (rtol 1e-6).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from horovod_tpu import config as jconfig
from horovod_tpu import metrics as jmetrics
from horovod_tpu import optimizer as jopt
from horovod_tpu.ops.batch_norm import TunableBatchNorm as JaxBN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
N, C = 6, 5


def _inputs():
    g = np.random.default_rng(23)
    return {"x": (g.standard_normal((4, N, C)) * 1.7 + 0.4).astype(
                np.float32),
            "w": g.standard_normal((4, N, C)).astype(np.float32),
            "g1": g.standard_normal((4, 7, 3)).astype(np.float32),
            "g2": g.standard_normal((4, 3)).astype(np.float32)}


_WORKER = textwrap.dedent("""
    import json
    import sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.batch_norm import TunableBatchNorm

    def count(name):
        return sum(s["value"] for s in
                   hvd.metrics()["counters"].get(name, []))

    def rounds():
        st = hvd.negotiation_stats()
        return st["full"] + st["fast"]

    hvd.init(device="cpu")
    r = hvd.rank()
    d = np.load(sys.argv[2])
    groups = [hvd.add_process_set([0, 1]), hvd.add_process_set([2, 3])]
    out, flags = {}, {}

    bn = TunableBatchNorm(d["x"].shape[2], process_set=groups[r // 2])
    x = torch.tensor(d["x"][r], requires_grad=True)
    r0, t0, c0 = (rounds(), count("collective_traced_total"),
                  count("collective_calls_total"))
    y = bn(x)
    (y * torch.tensor(d["w"][r])).sum().backward()
    flags["bn_rounds"] = rounds() - r0
    flags["bn_traced"] = count("collective_traced_total") - t0
    flags["bn_calls"] = count("collective_calls_total") - c0
    out["y"], out["dx"] = y.detach(), x.grad
    out["running_mean"] = bn.running_mean
    out["running_var"] = bn.running_var

    w1 = torch.nn.Parameter(torch.zeros(7, 3))
    w2 = torch.nn.Parameter(torch.zeros(3))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w1, w2], lr=0.1))
    for tag, alive in (("grouped", None), ("alive", int(r != 3))):
        w1.grad = torch.tensor(d["g1"][r])
        w2.grad = torch.tensor(d["g2"][r])
        opt.step(alive=alive)
        out["norm_" + tag] = torch.tensor(
            [hvd.metrics()["gauges"]["optimizer_grad_norm"][0]["value"]],
            dtype=torch.float64)
    np.savez(sys.argv[3] + f".rank{r}.npz",
             **{k: v.detach().double().numpy() for k, v in out.items()})
    with open(sys.argv[3] + f".rank{r}.json", "w") as f:
        json.dump(flags, f)
    hvd.shutdown()
""")


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("step_paths")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    data = tmp / "data.npz"
    np.savez(data, **_inputs())
    out = tmp / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               HOROVOD_METRICS_GRAD_NORM="1")
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "4",
         "--timeout", "240", str(script), REPO, str(data), str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ranks = []
    for i in range(4):
        with open(f"{out}.rank{i}.json") as f:
            flags = json.load(f)
        ranks.append((dict(np.load(f"{out}.rank{i}.npz")), flags))
    return ranks


def _reference_bn(group):
    """The reference's batch norm over ``group``'s whole batch, with the
    sum of the ranks' losses: (output, input gradient, running stats)."""
    d = _inputs()
    x = jnp.asarray(np.concatenate([d["x"][i] for i in group]))
    w = jnp.asarray(np.concatenate([d["w"][i] for i in group]))
    bn = JaxBN()
    v = bn.init(jax.random.PRNGKey(0), x)

    def loss(x):
        y, upd = bn.apply(v, x, mutable=["batch_stats"])
        return (y * w).sum(), (y, upd["batch_stats"])

    (_, (y, stats)), dx = jax.value_and_grad(loss, has_aux=True)(x)
    return np.asarray(y), np.asarray(dx), stats


@pytest.mark.parametrize("rank", range(4))
def test_bn_moments_take_no_round_on_disjoint_sets(four, rank):
    res, flags = four[rank]
    # Forward and backward: one in-step allreduce each, no round, no
    # eager count.
    assert flags == {"bn_rounds": 0, "bn_traced": 2, "bn_calls": 0}
    group = [0, 1] if rank < 2 else [2, 3]
    y, dx, stats = _reference_bn(group)
    rows = slice(N * group.index(rank), N * (group.index(rank) + 1))
    np.testing.assert_allclose(res["y"], y[rows], **TOL)
    np.testing.assert_allclose(res["dx"], dx[rows], **TOL)
    np.testing.assert_allclose(res["running_mean"], stats["mean"], **TOL)
    np.testing.assert_allclose(res["running_var"], stats["var"], **TOL)


def _reference_norm(monkeypatch, grads):
    """What the reference's gauge records for these reduced gradients."""
    cfg = dataclasses.replace(jconfig.get_config(), metrics_grad_norm=True)
    monkeypatch.setattr(jconfig, "get_config", lambda: cfg)
    jopt._maybe_record_grad_norm([jnp.asarray(g) for g in grads])
    return jmetrics.gauge("optimizer_grad_norm").value


@pytest.mark.parametrize("tag", ["grouped", "alive"])
def test_grad_norm_gauge_matches_reference(four, monkeypatch, tag):
    d = _inputs()
    live = range(4) if tag == "grouped" else range(3)
    grads = [np.mean([d[k][i] for i in live], axis=0) for k in ("g1", "g2")]
    want = _reference_norm(monkeypatch, grads)
    for res, _ in four:
        np.testing.assert_allclose(res["norm_" + tag][0], want, rtol=1e-6)
