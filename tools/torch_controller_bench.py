#!/usr/bin/env python3
"""The port's controller across ranks: ``python3 tools/torch_controller_bench.py
--np N [--device cuda|cpu]``.

Spawns an N-rank world of ``horovod_tpu_torch`` (NCCL, one card a rank, or
gloo on the CPU with ``--device cpu``) under ``HOROVOD_TIMELINE`` and, on
every rank:

1. two named allreduces (the timeline's op ids must line up on every
   shard);
2. the negotiation round's host time, fast path (a cached signature) and
   full path (a new signature each round), and the bare allgather of the
   round's 8 int32 on the control group beside them: median microseconds
   of 200 calls each;
3. an allreduce of 2^20 fp32 elements, 20 times while every rank is active
   and, on the last rank, 20 times while the others are joined and service
   it (median milliseconds, host clock around the call and a read of one
   element);
4. the reference's join-service scenario on the ranks' tensors
   (``tests/test_multiprocess.py``, ``join_service``), widened to N ranks:
   ranks 0..N-2 join after 3 steps, the last rank runs 6; the averages
   must be (N+1)/2·(s+1) while all are active and N·(s+1) after, Sum and
   Max must see neutral contributions, ``join()`` must return N-1, and an
   Average after the join must be (N-1)/2;
5. a mismatch (rank 0 allreduces, the others allgather): every rank must
   raise, with no data-plane call (``torch.distributed`` work on a group
   other than the control group) issued in that op.

With ``--late-rank R --late-ms M``, rank R sleeps M ms before one named
allreduce (``late/planted``, after a ``sync`` allreduce), right after the
two named ones. The shards are then merged
(``trace_merge.merge_timelines``) and checked: the ops every rank issues
in one order (the named ones and, with the plant, ``sync`` and
``late/planted``) carry the same op ids and phases on every rank's track,
and with the plant R is that op's ``last_rank`` and is blamed at least M
ms. The merge's seconds, its events, the planted op's spread, the
spreads of the other ops every rank issues in one order and the largest
spread of the join scenario's ops (ranks join at different steps there by
design) are printed. ``chip_smoke.py``
phase 17 (d) runs ``--np 2 --late-rank 1 --late-ms 50`` with two cards.

Prints one JSON line: the checks, the times, each shard's op ids and the
merge. Exit code 0 when every check holds. ``chip_smoke.py`` phase 6 runs
it with ``--np 2`` where the machine has two cards;
``tests/test_torch_port_card.py`` runs it on two and four cards.

``--model gpt2_medium|resnet50 [--steps K]`` instead trains a model on the
N-rank NCCL world through the controller, each rank on its own batch:
GPT-2 medium at B 8 T 1024 with the flash kernels and AdamW, or ResNet-50
at B 128 224² bf16 channels_last with SGD-momentum and cross-replica batch
norm over the world (``bn_cross_replica``, the reference's
``axis_name`` BN). Each rank reports the median wall time of steps
2..K, and per step the negotiation rounds, the host seconds inside them
(``negotiation_seconds``: the round itself plus the wait for the last
rank to arrive), the in-step allreduces (``collective_traced_total``) and
the eager ones (``collective_calls_total``). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM = 2          # named allreduces before everything else
REPS = 200        # negotiation rounds timed per path
JOIN_REPS = 20    # serviced allreduces timed


def _median_us(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


def worker(device: str, out_dir: str, late_rank=None,
           late_ms: float = 50.0) -> None:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import collective as C

    hvd.init(device=device)
    r, n = hvd.rank(), hvd.size()
    dev = hvd.device()
    res = {"rank": r, "checks": {}}
    checks = res["checks"]

    # Data-plane calls: torch.distributed work on any group but the
    # controller's.
    issued = [0]
    control = hvd.core.control_group()
    for fname in ("all_reduce", "broadcast", "all_gather",
                  "all_to_all_single", "reduce_scatter", "barrier",
                  "batch_isend_irecv", "isend", "irecv"):
        orig = getattr(dist, fname)

        def counted(*a, _orig=orig, **kw):
            if kw.get("group") is not control:
                issued[0] += 1
            return _orig(*a, **kw)
        setattr(dist, fname, counted)

    for i in range(WARM):
        hvd.allreduce(torch.full((3,), float(r), device=dev), name=f"warm{i}")
    if late_rank is not None:
        # Both ranks leave sync's negotiation round together; the planted
        # rank then arrives late_ms after the others at late/planted.
        hvd.allreduce(torch.ones(1, device=dev), name="sync")
        if r == late_rank:
            time.sleep(late_ms / 1e3)
        hvd.allreduce(torch.ones(8, device=dev), name="late/planted")

    row = np.zeros(8, np.int32)
    res["control_allgather_us"] = _median_us(
        lambda: C._host_allgather_i32(row), REPS)
    C._negotiate("bench", ("fast",))
    res["negotiation_fast_us"] = _median_us(
        lambda: C._negotiate("bench", ("fast",)), REPS)
    seq = iter(range(REPS))
    res["negotiation_full_us"] = _median_us(
        lambda: C._negotiate("bench", ("full", next(seq))), REPS)

    big = torch.ones(2 ** 20, device=dev)

    def step_ms():
        t0 = time.perf_counter()
        hvd.allreduce(big, name="big")[0].item()
        return (time.perf_counter() - t0) * 1e3

    res["allreduce_all_active_ms"] = statistics.median(
        step_ms() for _ in range(JOIN_REPS))

    last = n - 1
    for step in range(3 if r < last else 6):
        avg = hvd.allreduce(
            torch.full((4,), float((r + 1) * (step + 1)), device=dev))
        want = float(((n + 1) / 2 if step < 3 else n) * (step + 1))
        checks[f"avg_step{step}"] = bool(torch.allclose(
            avg.cpu(), torch.full((4,), want)))
    if r == last:
        tot = hvd.allreduce(torch.full((2,), 5.0, device=dev), op=hvd.Sum)
        checks["sum_neutral"] = bool(torch.all(tot.cpu() == 5.0))
        mx = hvd.allreduce(torch.full((2,), -7.0, device=dev), op=hvd.Max)
        checks["max_neutral"] = bool(torch.all(mx.cpu() == -7.0))
        res["allreduce_serviced_ms"] = statistics.median(
            step_ms() for _ in range(JOIN_REPS))
    checks["join_returns_last"] = hvd.join() == last
    post = hvd.allreduce(torch.full((2,), float(r), device=dev))
    checks["post_join_average"] = bool(torch.allclose(
        post.cpu(), torch.full((2,), (n - 1) / 2)))

    before = issued[0]
    try:
        if r == 0:
            hvd.allreduce(torch.ones(3, device=dev))
        else:
            hvd.allgather(torch.ones(3, device=dev))
        checks["mismatch_raises"] = False
    except RuntimeError as e:
        checks["mismatch_raises"] = "mismatch across processes" in str(e)
    checks["mismatch_issued_no_work"] = issued[0] == before
    if device == "cuda":
        torch.cuda.synchronize()
    hvd.shutdown()
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(res, f)


def _totals(snap) -> dict:
    def count(name):
        return sum(x["value"] for x in snap["counters"].get(name, []))
    return {"rounds": count("negotiation_rounds_total"),
            "negotiation_s": sum(x["sum"] for x in snap["histograms"].get(
                "negotiation_seconds", [])),
            "in_step": count("collective_traced_total"),
            "eager": count("collective_calls_total")}


def model_worker(name: str, steps: int, out_dir: str) -> None:
    sys.path.insert(0, REPO)
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics

    hvd.init(device="cuda")
    r, dev = hvd.rank(), hvd.device()
    g = torch.Generator(device=dev).manual_seed(0)
    data = torch.Generator(device=dev).manual_seed(1 + r)
    with torch.device(dev):
        if name == "gpt2_medium":
            from horovod_tpu_torch.models import get_model
            from horovod_tpu_torch.models.gpt2 import loss_fn
            model = get_model("gpt2_medium", attention="flash", generator=g)
            x = torch.randint(0, model.cfg.vocab_size, (8, 1024),
                              generator=data)

            def loss():
                return loss_fn(model(x), x)
            inner = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                      weight_decay=1e-4, eps=1e-8)
        else:
            from horovod_tpu_torch.models.resnet import ResNet50
            model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                             generator=g,
                             bn_cross_replica=hvd.global_process_set())
            model = model.to(memory_format=torch.channels_last)
            x = torch.randn(128, 3, 224, 224, generator=data).to(
                memory_format=torch.channels_last)
            y = torch.randint(0, 1000, (128,), generator=data)

            def loss():
                return F.cross_entropy(model(x), y)
            inner = torch.optim.SGD(model.parameters(), lr=0.1,
                                    momentum=0.9)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(inner)
    wall, per_step, losses = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        before = _totals(metrics.snapshot())
        t0 = time.perf_counter()
        opt.zero_grad()
        value = loss()
        value.backward()
        opt.step()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        after = _totals(metrics.snapshot())
        per_step.append({k: after[k] - before[k] for k in after})
        losses.append(value.item())
    steady = per_step[1:]
    step_ms = statistics.median(wall[1:])
    neg_ms = statistics.median(x["negotiation_s"] * 1e3 for x in steady)
    res = {"rank": r, "step_ms": step_ms, "negotiation_ms": neg_ms,
           "negotiation_share": neg_ms / step_ms,
           "rounds": [x["rounds"] for x in steady],
           "in_step": [x["in_step"] for x in steady],
           "eager": [x["eager"] for x in steady], "losses": losses}
    hvd.shutdown()
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(res, f)


def run_model(nranks: int, name: str, steps: int,
              timeout: float = 600.0) -> dict:
    """Spawn the world for ``--model``, return every rank's report."""
    from horovod_tpu_torch.ops import _build
    _build.build()          # once, before the ranks load the kernels
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
             str(nranks), "--timeout", str(int(timeout)),
             os.path.abspath(__file__), "--model-worker", name, str(steps),
             tmp],
            cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
            capture_output=True, text=True, timeout=timeout + 60)
        if proc.returncode != 0:
            raise RuntimeError(f"{name} world failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        ranks = []
        for i in range(nranks):
            with open(os.path.join(tmp, f"rank{i}.json")) as f:
                ranks.append(json.load(f))
    import math
    ok = all(all(map(math.isfinite, x["losses"])) for x in ranks)
    return {"model": name, "ranks": nranks, "ok": ok, "per_rank": ranks}


def merge_shards(base: str, nranks: int, late_rank=None,
                 late_ms: float = 50.0) -> tuple:
    """Merge the world's shards; returns ``(checks, summary)``."""
    sys.path.insert(0, REPO)
    from horovod_tpu_torch.trace_merge import merge_timelines
    t0 = time.perf_counter()
    doc = merge_timelines(base, feed_metrics=False)
    merge_s = time.perf_counter() - t0
    rep = doc["stragglerReport"]
    # The ops every rank issues in one order (the join scenario and the
    # mismatch that follow them differ between ranks by design).
    common = {f"warm{i}" for i in range(WARM)} | {"sync", "late/planted"}
    tracks: dict = {}
    for e in doc["traceEvents"]:
        args = e.get("args") or {}
        if e.get("cat") == "phase" and args.get("tensor") in common:
            tracks.setdefault(e["pid"], []).append((args["op_id"],
                                                    e["name"]))
    checks = {"merge_ranks": rep["ranks"] == list(range(nranks)),
              "merge_op_ids_line_up": len(tracks) == nranks and all(
                  sorted(t) == sorted(tracks[0]) for t in tracks.values())}
    spreads = {c["tensor"]: c["spread_seconds"] for c in rep["collectives"]}
    scenario = sorted(v for k, v in spreads.items() if k not in common)
    summary = {"merge_seconds": merge_s, "events": len(doc["traceEvents"]),
               "collectives": len(rep["collectives"]),
               "blame_seconds_by_rank": rep["blame_seconds_by_rank"],
               "scenario_spreads_max_seconds": scenario[-1] if scenario
               else None,
               "overlap_efficiency": rep["overlap"]["overlap_efficiency"],
               "warnings": rep.get("warnings", [])}
    if late_rank is not None:
        planted = next((c for c in rep["collectives"]
                        if c["tensor"] == "late/planted"), None)
        blame = rep["blame_seconds_by_rank"].get(str(late_rank), 0.0)
        checks["late_rank_is_last"] = planted is not None and \
            planted["last_rank"] == late_rank
        checks["late_rank_blamed"] = blame >= late_ms / 1e3
        # the planted op itself, not the blame summed over every op
        checks["planted_spread_reaches_delay"] = planted is not None and \
            planted["spread_seconds"] >= 0.9 * late_ms / 1e3
        others = sorted(v for k, v in spreads.items()
                        if k in common and k != "late/planted")
        summary.update(
            late_rank=late_rank, late_ms=late_ms,
            planted_spread_seconds=planted and planted["spread_seconds"],
            planted_last_rank=planted and planted["last_rank"],
            late_rank_blame_seconds=blame,
            other_spreads_seconds=others,
            other_spread_median_seconds=(statistics.median(others)
                                         if others else None))
    return checks, summary


def run(nranks: int, device: str = "cuda", timeout: float = 300.0,
        late_rank=None, late_ms: float = 50.0) -> dict:
    """Spawn the world, check and merge the shards, return the summary."""
    late = [] if late_rank is None else ["--late-rank", str(late_rank),
                                         "--late-ms", str(late_ms)]
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, HOROVOD_TIMELINE=os.path.join(tmp, "t.json"),
                   OMP_NUM_THREADS="1")
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
             str(nranks), "--timeout", str(int(timeout)),
             os.path.abspath(__file__), "--worker", device, tmp] + late,
            cwd=REPO, env=env, capture_output=True, text=True,
            timeout=timeout + 60)
        if proc.returncode != 0:
            raise RuntimeError(f"controller world failed "
                               f"({proc.returncode}):\n{proc.stderr[-4000:]}")
        ranks, shards = [], []
        for i in range(nranks):
            with open(os.path.join(tmp, f"rank{i}.json")) as f:
                ranks.append(json.load(f))
            with open(os.path.join(tmp, f"t.rank{i}.json")) as f:
                evs = json.load(f)["traceEvents"]
            shards.append(sorted(
                (e["args"]["op_id"], e["name"]) for e in evs
                if e.get("cat") == "phase"
                and str(e["args"].get("tensor", "")).startswith("warm")))
        merge_checks, merge = merge_shards(os.path.join(tmp, "t.json"),
                                           nranks, late_rank, late_ms)
    checks = {f"rank{x['rank']}_{k}": v for x in ranks
              for k, v in x["checks"].items()}
    checks.update(merge_checks)
    checks["shards_line_up"] = all(s == shards[0] for s in shards)
    checks["shard_op_ids"] = shards[0] == sorted(
        (i + 1, p) for i in range(WARM)
        for p in ("NEGOTIATE", "QUEUE", "EXEC"))
    out = {"ranks": nranks, "device": device, "ok": all(checks.values()),
           "failed": sorted(k for k, v in checks.items() if not v)}
    for key in ("control_allgather_us", "negotiation_fast_us",
                "negotiation_full_us", "allreduce_all_active_ms"):
        out[key] = [x[key] for x in ranks]
    out["allreduce_serviced_ms"] = ranks[-1]["allreduce_serviced_ms"]
    out["merge"] = merge
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--np", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--model", choices=("gpt2_medium", "resnet50"))
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--late-rank", type=int, default=None,
                    help="rank that arrives late at late/planted")
    ap.add_argument("--late-ms", type=float, default=50.0,
                    help="how late, in milliseconds (default 50)")
    ap.add_argument("--worker", nargs=2, metavar=("DEVICE", "OUT_DIR"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--model-worker", nargs=3,
                    metavar=("MODEL", "STEPS", "OUT_DIR"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(*args.worker, late_rank=args.late_rank, late_ms=args.late_ms)
        return 0
    if args.model_worker:
        name, steps, out_dir = args.model_worker
        model_worker(name, int(steps), out_dir)
        return 0
    if args.model:
        sys.path.insert(0, REPO)
        out = run_model(args.np, args.model, args.steps)
    else:
        if args.late_rank is not None and \
                not 0 <= args.late_rank < args.np:
            ap.error(f"--late-rank {args.late_rank} is not a rank of "
                     f"--np {args.np}")
        out = run(args.np, args.device, late_rank=args.late_rank,
                  late_ms=args.late_ms)
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
