#!/usr/bin/env python3
"""The port's allreduce algorithms across ranks:
``python3 tools/torch_collective_bench.py --np N [--model gpt2_medium|resnet50]
[--device cuda|cpu]``.

Spawns an N-rank world of ``horovod_tpu_torch`` (NCCL, one card a rank, or
gloo on the CPU with ``--device cpu``, a rehearsal at small sizes).

**Collectives** (default): fp32 buffers of 1 MB to 1 GB (``--sizes`` in
MB), each reduced by every algorithm x wire of ``overlap.py`` that the
world can run (``auto`` under each wire; ``psum``, ``rs_ag``,
``chunked_rs_ag`` and ``swing`` under ``fp32`` and ``bf16``; the
quantized forms; the ``_2d`` forms when the topology has two dims) as one
bucket, through the in-step path the gradient buckets take
(``collective._in_step_bucket_async``: the lowering and its telemetry,
no negotiation round). For each: the median device time of one call over
``--reps`` calls queued back to back behind a device sleep (CUDA events;
host clock on the CPU), algbw = bytes / time and busbw = algbw x 2(n-1)/n,
the largest error against ``psum``'s result on the same inputs relative
to its largest value, the wire bytes a call from the
``allreduce_wire_bytes_total`` counters and the algorithm it resolved to.
``chunked_rs_ag``'s legs are timed once more as this tool issues them
itself, on one communicator and with the all-gather legs on a second
communicator over the same ranks (:func:`_chunked_two_comms`): NCCL runs
one communicator's work in issue order, so only on two can chunk i's
all-gather overlap chunk i+1's reduce-scatter.

**Models** (``--model``): GPT-2 medium (B 8, T 1024, bf16, flash, AdamW)
or ResNet-50 (B 128, 224², bf16, channels_last, SGD-momentum), each rank
on its own seeded batch, trained ``--steps`` steps under
``DistributedOptimizer`` three ways: overlap off, ``overlap=True``, and
``overlap=True`` with ``Compression.int8`` and error feedback. Per way and
rank: the median over steps 2..K of the step's wall time, the backward's
and ``step()``'s device time (CUDA events around each: ``step()`` holds
the wait for the buckets and the optimizer), the negotiation rounds a
step and, under overlap, the buckets issued during the backward.

Prints one JSON line; every number carries the card's name and power
limit (``nvidia-smi``). Exit code 0 when every rank finished and every
error is within its bound (``psum``-exact forms 1e-5, bf16 2e-2, int8 and
fp8 three half-steps of the largest value a contribution).
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
SIZES_MB = (1, 4, 16, 64, 256, 1024)
SLEEP_CYCLES = 20_000_000        # ~10 ms of device sleep before each run


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def _combos(topology):
    from horovod_tpu_torch import overlap
    out = [("auto", w) for w in overlap.WIRES]
    for alg in ("psum", "rs_ag", "chunked_rs_ag", "swing"):
        out += [(alg, "fp32"), (alg, "bf16")]
    out += [(a, "fp32") for a in ("rs_ag_int8", "chunked_rs_ag_int8",
                                  "rs_ag_fp8", "chunked_rs_ag_fp8")]
    if len([d for d in topology if d > 1]) >= 2:
        out += [(a, "fp32") for a in ("rs_ag_2d", "chunked_rs_ag_2d",
                                      "rs_ag_2d_int8",
                                      "chunked_rs_ag_2d_int8")]
    return out


def _bound(alg, wire, n, top):
    from horovod_tpu_torch import overlap
    qw = overlap.parse_algorithm(alg)[1]
    if qw is not None:
        return 3.0 * n * top / (127 if qw == "int8" else 8)
    if wire in overlap.QUANT_WIRES and alg == "auto":
        return 3.0 * n * top / (127 if wire == "int8" else 8)
    return 2e-2 * n * top if wire == "bf16" else 1e-5 * n * top


def _chunked_two_comms(x, group, ag_group, n: int, chunks: int):
    """``overlap.chunked_rs_ag``'s legs, the all-gathers on ``ag_group``
    (``group`` itself for the one-communicator baseline): every chunk's
    reduce-scatter, then each chunk's all-gather after its own
    reduce-scatter. Returns the reduced buffer."""
    import torch
    import torch.distributed as dist
    from horovod_tpu_torch import overlap
    from horovod_tpu_torch.ops import quantized as q
    m = x.numel()
    per, chunks = overlap._split_sizes(m, n, chunks)
    x = overlap._pad_to(x, per * chunks)
    rs, parts = [], []
    for i in range(chunks):
        out = x.new_empty(per // n)
        rs.append(overlap._RS_SINGLE(out, x[i * per:(i + 1) * per],
                                     group=group, async_op=True))
        parts.append(out)
    gathered, works = [], []
    for w, part in zip(rs, parts):
        if ag_group is not group or dist.get_backend(group) != "nccl":
            w.wait()
        full = x.new_empty(per)
        works.append(q.ALL_GATHER_SINGLE(full, part, group=ag_group,
                                         async_op=True))
        gathered.append(full)
    for w in works:
        w.wait()
    return (gathered[0] if chunks == 1 else torch.cat(gathered))[:m]


def collectives_worker(device: str, sizes_mb, reps: int, out_dir: str):
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import collective as C
    from horovod_tpu_torch import metrics, overlap
    from horovod_tpu_torch.compression import Compression

    hvd.init(device=device)
    r, n, dev = hvd.rank(), hvd.size(), hvd.device()
    ps = hvd.global_process_set()
    cuda = dev.type == "cuda"
    second = dist.new_group(list(range(n)))      # for the two-comm run

    def timed(fn):
        """Median ms of one fn() over ``reps`` back-to-back calls."""
        fn()                                     # warm (NCCL set-up)
        if cuda:
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(SLEEP_CYCLES)
                e0.record()
                for _ in range(reps):
                    fn()
                e1.record()
                torch.cuda.synchronize()
                times.append(e0.elapsed_time(e1) / reps)
            return statistics.median(times)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    rows = []
    g = torch.Generator(device=dev).manual_seed(100 + r)
    for mb in sizes_mb:
        m = int(mb * 2 ** 20) // 4
        x = torch.randn(m, generator=g, device=dev)
        ref = x.clone()
        C._in_step_bucket_async(ref, C.Sum, ps, 1.0, 1.0, Compression.none,
                                "psum", 4, "fp32").synchronize()
        top = float(ref.abs().max())
        top_x = float(hvd.allreduce(x.abs().max(), op=hvd.Max))
        buf = torch.empty_like(x)
        for alg, wire in _combos(hvd.topology()):
            def call():
                buf.copy_(x)
                return C._in_step_bucket_async(
                    buf, C.Sum, ps, 1.0, 1.0, Compression.none, alg,
                    overlap.DEFAULT_CHUNKS, wire).synchronize()
            metrics.reset_metrics()
            err = float((call() - ref).abs().max())
            snap = metrics.snapshot()
            wire_bytes = sum(s["value"] for s in snap["counters"].get(
                "allreduce_wire_bytes_total", []))
            resolved = [s["labels"]["algorithm"] for s in
                        snap["counters"].get("allreduce_algorithm_total", [])]
            ms = timed(call)
            rows.append({"mb": mb, "algorithm": alg, "wire": wire,
                         "resolved": resolved[0] if resolved else None,
                         "ms": ms, "algbw_gbs": m * 4 / ms / 1e6,
                         "busbw_gbs": m * 4 / ms / 1e6 * 2 * (n - 1) / n,
                         "err": err, "rel_err": err / top,
                         "ok": err <= _bound(alg, wire, n, top_x),
                         "wire_bytes": wire_bytes})
        for tag, ag in (("chunked_rs_ag_1comm", ps.group),
                        ("chunked_rs_ag_2comm", second)):
            def direct():
                return _chunked_two_comms(x, ps.group, ag, n,
                                          overlap.DEFAULT_CHUNKS)
            err = float((direct() - ref).abs().max())
            ms = timed(direct)
            rows.append({"mb": mb, "algorithm": tag, "wire": "fp32",
                         "resolved": "chunked_rs_ag", "ms": ms,
                         "algbw_gbs": m * 4 / ms / 1e6,
                         "busbw_gbs": m * 4 / ms / 1e6 * 2 * (n - 1) / n,
                         "err": err, "rel_err": err / top,
                         "ok": err <= 1e-5 * n * top_x,
                         "wire_bytes": None})
        del x, ref, buf
        if cuda:
            torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump({"rank": r, "topology": list(hvd.topology()),
                   "rows": rows}, f)
    hvd.shutdown()


def _totals(snap) -> dict:
    def count(name, **labels):
        return sum(x["value"] for x in snap["counters"].get(name, [])
                   if all(x["labels"].get(k) == v
                          for k, v in labels.items()))
    return {"rounds": count("negotiation_rounds_total"),
            "in_backward": count("overlap_buckets_total",
                                 issued="backward"),
            "at_step": count("overlap_buckets_total", issued="step")}


def model_worker(name: str, steps: int, device: str, out_dir: str) -> None:
    sys.path.insert(0, REPO)
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics

    hvd.init(device=device)
    r, dev = hvd.rank(), hvd.device()
    cuda = dev.type == "cuda"
    tiny = not cuda                  # the CPU rehearsal: small shapes

    def build():
        g = torch.Generator(device=dev).manual_seed(0)
        data = torch.Generator(device=dev).manual_seed(1 + r)
        with torch.device(dev):
            if name == "gpt2_medium":
                from horovod_tpu_torch.models import get_model
                from horovod_tpu_torch.models.gpt2 import loss_fn
                kw = dict(num_layers=2, d_model=64, num_heads=4,
                          vocab_size=256, attention="dense",
                          dtype=torch.float32) if tiny else \
                    dict(attention="flash")
                model = get_model("gpt2" if tiny else "gpt2_medium",
                                  generator=g, **kw)
                b, t = (2, 32) if tiny else (8, 1024)
                x = torch.randint(0, model.cfg.vocab_size, (b, t),
                                  generator=data)

                def loss():
                    return loss_fn(model(x), x)
                inner = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                          weight_decay=1e-4, eps=1e-8)
            else:
                from horovod_tpu_torch.models.resnet import ResNet18, ResNet50
                if tiny:
                    model = ResNet18(num_classes=10, dtype=torch.float32,
                                     generator=g)
                    b, hw, classes = 2, 32, 10
                else:
                    model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                                     generator=g)
                    b, hw, classes = 128, 224, 1000
                model = model.to(memory_format=torch.channels_last)
                x = torch.randn(b, 3, hw, hw, generator=data).to(
                    memory_format=torch.channels_last)
                y = torch.randint(0, classes, (b,), generator=data)

                def loss():
                    return F.cross_entropy(model(x), y)
                inner = torch.optim.SGD(model.parameters(), lr=0.1,
                                        momentum=0.9)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        return model, loss, inner

    ways = {"off": {}, "overlap": {"overlap": True},
            "int8": {"overlap": True,
                     "compression": hvd.Compression.int8,
                     "error_feedback": True}}
    res = {"rank": r}
    for way, kw in ways.items():
        model, loss, inner = build()
        opt = hvd.DistributedOptimizer(inner, **kw)
        wall, bwd, stp, per_step, losses = [], [], [], [], []
        for _ in range(steps):
            if cuda:
                torch.cuda.synchronize()
            before = _totals(metrics.snapshot())
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
                if cuda else None
            t0 = time.perf_counter()
            opt.zero_grad()
            value = loss()
            if cuda:
                ev[0].record()
            value.backward()
            if cuda:
                ev[1].record()
            opt.step()
            if cuda:
                ev[2].record()
                torch.cuda.synchronize()
                bwd.append(ev[0].elapsed_time(ev[1]))
                stp.append(ev[1].elapsed_time(ev[2]))
            wall.append((time.perf_counter() - t0) * 1e3)
            after = _totals(metrics.snapshot())
            per_step.append({k: after[k] - before[k] for k in after})
            losses.append(value.item())
        steady = per_step[1:]
        res[way] = {
            "step_ms": statistics.median(wall[1:]),
            "backward_ms": statistics.median(bwd[1:]) if bwd else None,
            "step_call_ms": statistics.median(stp[1:]) if stp else None,
            "rounds": [x["rounds"] for x in steady],
            "buckets_in_backward": [x["in_backward"] for x in steady],
            "buckets_at_step": [x["at_step"] for x in steady],
            "losses": losses}
        del model, opt, inner
        if cuda:
            torch.cuda.empty_cache()
    hvd.shutdown()
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(res, f)


def _spawn(nranks: int, args, timeout: float):
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
             str(nranks), "--timeout", str(int(timeout)),
             os.path.abspath(__file__)] + list(args) + [tmp],
            cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
            capture_output=True, text=True, timeout=timeout + 60)
        if proc.returncode != 0:
            raise RuntimeError(f"world failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        ranks = []
        for i in range(nranks):
            with open(os.path.join(tmp, f"rank{i}.json")) as f:
                ranks.append(json.load(f))
    return ranks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--np", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--model", choices=("gpt2_medium", "resnet50"))
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--sizes", default=",".join(map(str, SIZES_MB)),
                    help="buffer sizes in MB, comma-separated")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--worker", nargs=4, help=argparse.SUPPRESS)
    ap.add_argument("--model-worker", nargs=4, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        dev, sizes, reps, out = args.worker
        collectives_worker(dev, [float(s) for s in sizes.split(",")],
                           int(reps), out)
        return 0
    if args.model_worker:
        name, steps, dev, out = args.model_worker
        model_worker(name, int(steps), dev, out)
        return 0
    if args.device == "cuda" and args.model == "gpt2_medium":
        sys.path.insert(0, REPO)
        from horovod_tpu_torch.ops import _build
        _build.build()          # once, before the ranks load the kernels
    t0 = time.perf_counter()
    if args.model:
        ranks = _spawn(args.np, ["--model-worker", args.model,
                                 str(args.steps), args.device],
                       args.timeout)
        import math
        ok = all(all(map(math.isfinite, x[w]["losses"]))
                 for x in ranks for w in ("off", "overlap", "int8"))
        out = {"model": args.model, "per_rank": ranks}
    else:
        ranks = _spawn(args.np, ["--worker", args.device, args.sizes,
                                 str(args.reps)], args.timeout)
        ok = all(row["ok"] for x in ranks for row in x["rows"])
        out = {"topology": ranks[0]["topology"], "rank0": ranks[0]["rows"],
               "failed": sorted({(row["mb"], row["algorithm"], row["wire"])
                                 for x in ranks for row in x["rows"]
                                 if not row["ok"]})}
    out.update(ranks=args.np, device=args.device, ok=ok,
               card=_card() if args.device == "cuda" else None,
               seconds=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
