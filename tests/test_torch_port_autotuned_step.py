"""horovod_tpu_torch's ``AutotunedStep`` == horovod_tpu's.

In one process, the port's and the reference's ``AutotunedStep`` drive
their own ``BayesianAutotuner`` (same arguments; the tuner has no random
state, so the same times give the same points) through steps whose time
is injected: ``time.perf_counter`` reads a clock that each built step
advances by a function of the threshold, algorithm, chunks and wire it was
built with. For builders of 1, 3 and 4 required arguments (and a 1-argument
builder with a defaulted extra) the sequence of builds with their
arguments, of thresholds and of convergence flags after each call must be
the reference's exactly: the untimed first call after each rebuild, one
rebuild per probe, the untimed path after convergence. Timed calls set the
``optimizer_step_seconds`` gauge (the last timed step) and the
``optimizer_step_latency_seconds`` histogram (one observation each), as
the reference's do.

On a spawned two-rank gloo world, each rank's injected times favour other
thresholds, so the ranks' local picks would differ: both must run, and
report, rank 0's point at every probe and at convergence.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import pytest

from horovod_tpu import autotune as jtune
from horovod_tpu import metrics as jmetrics
from horovod_tpu.optimizer import AutotunedStep as JStep

import horovod_tpu_torch as hvd
from horovod_tpu_torch import autotune as ptune

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 20


def _cost(thr, alg="auto", chunks=None, wire=None):
    t = 0.1 + 0.01 * (math.log2(thr) - 23.5) ** 2
    t += {"psum": 0.02, "rs_ag": 0.0}.get(alg, 0.01)
    t += 0.003 * math.log2(chunks or 1)
    return t - 0.01 * (wire == "int8")


def _builders(builds, clock, out):
    def step_for(*args):
        def step(x):
            clock[0] += _cost(*args)
            return out(x)
        return step

    def make1(thr):
        builds.append((thr,))
        return step_for(thr)

    def make1_default(thr, jit=True):
        builds.append((thr, jit))
        return step_for(thr)

    def make3(thr, alg, chunks):
        builds.append((thr, alg, chunks))
        return step_for(thr, alg, chunks)

    def make4(thr, alg, chunks, wire):
        builds.append((thr, alg, chunks, wire))
        return step_for(thr, alg, chunks, wire)

    return {"1": make1, "1_default": make1_default, "3": make3, "4": make4}


TUNER_KW = {"1": {}, "1_default": {}, "3": {"tune_algorithm": True},
            "4": {"tune_algorithm": True, "tune_wire": True}}


def _drive(cls, tuner_cls, arity, out, monkeypatch):
    builds, clock = [], [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    tuner = tuner_cls(probes=4, samples_per_probe=2, **TUNER_KW[arity])
    step = cls(_builders(builds, clock, out)[arity], tuner)
    seq = []
    for i in range(CALLS):
        step(i)
        seq.append((step.current_threshold(), step.converged))
    monkeypatch.undo()
    return builds, seq


@pytest.mark.parametrize("arity", sorted(TUNER_KW))
def test_builds_and_thresholds_equal_the_reference(arity, monkeypatch):
    hvd.reset_metrics()
    got = _drive(hvd.AutotunedStep, ptune.BayesianAutotuner, arity,
                 float, monkeypatch)
    port_snap = hvd.metrics()
    jmetrics.reset_metrics()
    want = _drive(JStep, jtune.BayesianAutotuner, arity, jnp.float32,
                  monkeypatch)
    ref_snap = jmetrics.snapshot()
    assert got == want
    builds, seq = got
    assert seq[-1][1] and not seq[0][1]
    # One build at the start, one a probe: 4 probes of 2 timed samples.
    assert len(builds) == 1 + 4
    gauge = port_snap["gauges"]["optimizer_step_seconds"][0]["value"]
    hist = port_snap["histograms"]["optimizer_step_latency_seconds"][0]
    ref_hist = ref_snap["histograms"]["optimizer_step_latency_seconds"][0]
    assert hist["count"] == ref_hist["count"] == 4 * 2
    assert math.isclose(hist["sum"], ref_hist["sum"], rel_tol=1e-12)
    assert math.isclose(
        gauge, ref_snap["gauges"]["optimizer_step_seconds"][0]["value"],
        rel_tol=1e-12)


def test_first_call_after_a_build_is_untimed(monkeypatch):
    hvd.reset_metrics()
    builds, clock = [], [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    tuner = ptune.BayesianAutotuner(probes=2, samples_per_probe=1)
    step = hvd.AutotunedStep(_builders(builds, clock, float)["1"], tuner)
    step(0)
    assert "optimizer_step_latency_seconds" not in hvd.metrics().get(
        "histograms", {})
    step(1)
    assert hvd.metrics()["histograms"][
        "optimizer_step_latency_seconds"][0]["count"] == 1


_WORKER = textwrap.dedent("""
    import json, math, sys, time
    sys.path.insert(0, sys.argv[1])
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.autotune import BayesianAutotuner

    hvd.init(device="cpu")
    r = hvd.rank()
    clock = [0.0]
    time.perf_counter = lambda: clock[0]
    centre = 21.0 if r == 0 else 27.0     # each rank favours its own

    def make(thr):
        def step(x):
            clock[0] += 0.1 + 0.01 * (math.log2(thr) - centre) ** 2
            return torch.zeros(())
        return step

    tuner = BayesianAutotuner(probes=5, samples_per_probe=2)
    step = hvd.AutotunedStep(make, tuner)
    seen = []
    for i in range(20):
        step(i)
        seen.append(step.current_threshold())
    local = min(zip(tuner._ys, tuner._xs))[1][0]
    out = {"seen": seen, "best": step.current_threshold(),
           "local_best": tuner._denorm(local), "converged": step.converged,
           "probes": [tuner._denorm(x[0]) for x in tuner._xs]}
    with open(sys.argv[2] + f".rank{r}.json", "w") as f:
        json.dump(out, f)
    hvd.shutdown()
""")


def test_two_ranks_agree_on_rank_zeros_point(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    out = tmp_path / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--timeout", "120", str(script), REPO, str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    ranks = [json.load(open(f"{out}.rank{i}.json")) for i in range(2)]
    assert all(x["converged"] for x in ranks)
    assert ranks[0]["seen"] == ranks[1]["seen"]
    assert ranks[0]["probes"] == ranks[1]["probes"]
    assert ranks[0]["best"] == ranks[1]["best"] == ranks[0]["local_best"]
    # Rank 1's own timings pick another point.
    assert ranks[1]["local_best"] != ranks[0]["local_best"]
