"""horovod_tpu_torch's autotuner == horovod_tpu's (``autotune.py``).

In one process, the port's ``Autotuner`` and ``BayesianAutotuner`` and the
reference's are fed the same step times, each a function of the point the
tuner is at; they must propose the same sequence of points (thresholds,
compressions, algorithms, chunk counts, wires, topology schedules), reach
convergence at the same record and pick the same point. The Bayesian tuner
has no random state: its first three points are fixed and the rest come
from its Gaussian process, so the same times give the same points.

On a spawned two-rank gloo world (``python -m horovod_tpu_torch.runner``)
``HOROVOD_AUTOTUNE=1`` with ``HOROVOD_AUTOTUNE_MODE=bayes`` drives a small
model's ``DistributedOptimizer``; the ranks' step times differ on purpose,
so their local proposals would too: both must end on rank 0's pick, and
rank 0 alone writes the ``HOROVOD_AUTOTUNE_LOG`` line. A tuner passed as
``autotuner=`` that also tunes the algorithm and the wire has its picks
agreed the same way and threaded into the allreduce.
"""

import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

from horovod_tpu import autotune as R

from horovod_tpu_torch import autotune as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _time_of(point_threshold, extra=0.0):
    """A bowl in log2(threshold) with its floor near 24 MB."""
    return 0.1 + 0.01 * (math.log2(point_threshold) - 24.5) ** 2 + extra


def test_ladder_proposes_the_reference_sequence():
    a, b = P.Autotuner(samples_per_candidate=3), \
        R.Autotuner(samples_per_candidate=3)
    seq_a, seq_b = [], []
    for i in range(20):
        seq_a.append((a.current_threshold(), a.converged))
        seq_b.append((b.current_threshold(), b.converged))
        a.record(_time_of(a.current_threshold(), 0.001 * (i % 3)))
        b.record(_time_of(b.current_threshold(), 0.001 * (i % 3)))
    assert seq_a == seq_b
    assert a.converged and a.current_threshold() == b.current_threshold()


BAYES_CASES = {
    "threshold": {},
    "compression": {"tune_compression": True},
    "algorithm": {"tune_algorithm": True},
    "algorithm_wire": {"tune_algorithm": True, "tune_wire": True},
    "everything": {"tune_compression": True, "tune_algorithm": True,
                   "tune_wire": True, "tune_topology": True},
}


def _bayes_time(t):
    x = t.current_threshold()
    extra = 0.02 * (t.current_compression() == "fp16")
    extra += {"psum": 0.03, "rs_ag": 0.0}.get(t.current_algorithm(), 0.01)
    extra += 0.004 * math.log2(t.current_chunks())
    extra -= 0.015 * (t.current_wire() == "int8")
    return _time_of(x, extra)


@pytest.mark.parametrize("case", sorted(BAYES_CASES))
def test_bayesian_tuner_proposes_the_reference_sequence(case):
    kw = dict(probes=6, samples_per_probe=2, **BAYES_CASES[case])
    a, b = P.BayesianAutotuner(**kw), R.BayesianAutotuner(**kw)
    seq_a, seq_b = [], []
    for _ in range(6 * 2 + 2):
        seq_a.append((a.current_point(), a.pending_sync, a.converged))
        seq_b.append((b.current_point(), b.pending_sync, b.converged))
        a.record(_bayes_time(a))
        b.record(_bayes_time(b))
    assert seq_a == seq_b
    assert a.converged and b.converged
    got = (a.current_threshold(), a.current_compression(),
           a.current_algorithm(), a.current_chunks(), a.current_wire(),
           a.current_topology())
    want = (b.current_threshold(), b.current_compression(),
            b.current_algorithm(), b.current_chunks(), b.current_wire(),
            b.current_topology())
    assert got == want
    assert a.summary() == b.summary()


def test_set_current_point_and_offline_sweep_match():
    a, b = P.BayesianAutotuner(tune_algorithm=True), \
        R.BayesianAutotuner(tune_algorithm=True)
    for t in (a, b):
        t.set_current_point((0.25, 0, 2))       # a legacy, shorter point
    assert a.current_point() == b.current_point()
    assert a.current_algorithm() == b.current_algorithm() == "chunked_rs_ag"
    calls = []

    def factory(thr):
        def step():
            calls.append(thr)
        return step
    res = P.autotune_fusion_threshold(factory, [1 << 20, 1 << 22],
                                      steps_per_trial=2, warmup_steps=1)
    assert set(res.trials) == {1 << 20, 1 << 22}
    assert calls == [1 << 20] * 3 + [1 << 22] * 3
    assert res.best_threshold_bytes in res.trials
    assert "best fusion threshold" in res.summary()


_WORKER = textwrap.dedent("""
    import json, os, sys, time
    sys.path.insert(0, sys.argv[1])
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.autotune import BayesianAutotuner

    hvd.init(device="cpu")
    r = hvd.rank()
    out = {}

    def run(tag, **kw):
        torch.manual_seed(0)
        lin = torch.nn.Linear(64, 64)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(),
                                                       lr=0.01), **kw)
        for step in range(12):
            opt.zero_grad()
            lin(torch.ones(2, 64)).sum().backward()
            # Different local step times on the two ranks.
            time.sleep(0.002 * (1 + r) * (1 + step % 3))
            opt.step()
        t = opt._autotuner
        out[tag] = {"converged": t.converged,
                    "threshold": t.current_threshold(),
                    "point": list(t.current_point())}
        if hasattr(t, "_tune_alg") and t._tune_alg:
            out[tag].update(algorithm=t.current_algorithm(),
                            chunks=t.current_chunks(),
                            wire=t.current_wire())
        out[tag]["comm"] = list(opt._comm())
    run("env")
    run("picks", autotuner=BayesianAutotuner(
        probes=4, samples_per_probe=2, tune_algorithm=True, tune_wire=True))
    with open(sys.argv[2] + f".rank{r}.json", "w") as fh:
        json.dump(out, fh)
    hvd.shutdown()
""")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("autotune")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    log = tmp / "autotune.log"
    out = tmp / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1", HOROVOD_AUTOTUNE="1",
               HOROVOD_AUTOTUNE_MODE="bayes", HOROVOD_AUTOTUNE_PROBES="4",
               HOROVOD_AUTOTUNE_SAMPLES="2",
               HOROVOD_AUTOTUNE_LOG=str(log))
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--timeout", "240", str(script), REPO, str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ranks = [json.load(open(f"{out}.rank{i}.json")) for i in range(2)]
    lines = [json.loads(s) for s in log.read_text().splitlines()]
    return ranks, lines


def test_autotune_env_agrees_on_rank_zeros_pick_and_logs_once(world):
    ranks, lines = world
    assert ranks[0]["env"]["converged"] and ranks[1]["env"]["converged"]
    assert ranks[0]["env"]["threshold"] == ranks[1]["env"]["threshold"]
    assert ranks[0]["env"]["point"] == ranks[1]["env"]["point"]
    # One line from the env-made tuner, one from the tuner passed in: both
    # written by rank 0 only.
    assert len(lines) == 2
    assert lines[0] == {"converged_fusion_threshold_bytes":
                        ranks[0]["env"]["threshold"],
                        "converged_compression": "none"}


def test_algorithm_and_wire_picks_are_agreed_and_threaded(world):
    ranks, lines = world
    a, b = ranks[0]["picks"], ranks[1]["picks"]
    assert a["converged"] and b["converged"]
    for k in ("threshold", "algorithm", "chunks", "wire", "comm"):
        assert a[k] == b[k], k
    assert lines[1]["converged_algorithm"] == a["algorithm"]
    assert lines[1]["converged_chunks"] == a["chunks"]
    assert lines[1]["converged_wire"] == a["wire"]
    thr, alg, chunks, wire = a["comm"]
    assert thr == a["threshold"] and chunks == a["chunks"]
    assert wire == a["wire"]
    from horovod_tpu.overlap import compose_algorithm
    assert alg == compose_algorithm(a["algorithm"], a["wire"])
