#!/usr/bin/env python3
"""The other mesh axes across cards: ``python3 tools/torch_mesh_bench.py
--mesh dp1xsp2xtp2,dp2xsp2xtp1,dp1xep2xtp2 [--device cuda|cpu]
[--steps 5] [--band 1e-3]``. Each mesh is ``dpAx(sp|ep)BxtpC`` over A·B·C
ranks, laid out by ``make_mesh`` as the reference lays out its devices.

* ``sp`` meshes run the reference's dp x sp x tp step
  (``__graft_entry__.py:66-103``) on GPT-2 medium (``attention="flash"``,
  bf16 compute, fp32 parameters, "dots" remat, seed 0) at B 2, T 8192, as
  ``tools/torch_ring_bench.py --mode gpt2`` trains it: each rank holds
  its tp part (``mp.tensor_parallel(model, tp, sp=)``), feeds its striped
  shard of its dp row's tokens to the flash ring over its sp line, and
  takes ``mp.vocab_parallel_loss(..., sp=, layout="striped")``; the
  optimizer averages over the dp x sp plane.
* ``ep`` meshes run the dp x ep x tp step (``:105-136``) on the
  Mixtral-style Llama-340M of ``chip_smoke.py`` phase 9 (24 layers, d
  1024, 16 heads over 4 kv heads, 8 experts, top-2, SwiGLU, capacity
  1.25, "dots" remat) at B 4, T 2048: E/ep experts a rank
  (``tensor_parallel(..., ep=)``), the tokens replicated over ep and tp,
  the loss ``vocab_parallel_loss`` + 1e-2 times the mean aux loss, the
  optimizer over the dp line.

``--steps`` AdamW steps (lr 1e-4, weight decay 1e-4, eps 1e-8) on one
fixed batch; the same model and batch run on one rank first (a mesh of 1
x 1 x 1, one card). ``--device cpu`` rehearses on gloo with two-layer d-64
models (T 128 and 64).

Checks (exit code 0 when every one holds): every step's loss, averaged
over the dp rows, within ``--band`` of the one rank's, the ranks of a row
equal, the one rank's losses finite and falling; each rank's parameter
bytes those of its part (the tp splits of ``split_params``' rules, E/ep
experts); each flash kernel's launches a step those of the path (one a
non-skipped ring hop and layer; the ep path's forward twice under
"dots").

Per rank it reports ms a step (median of steps 1 on, wall clock behind
``torch.cuda.synchronize()``), tokens/s of the whole job, peak memory,
parameter and expert bytes and their share of the whole model's. On the
card also the step's split (device ms of the forward with the loss, the
backward and the optimizer between CUDA events, and the host's ms to
issue the forward and the backward), one more step under
``torch.profiler`` (the device's busy ms, the NCCL kernels' ms, the top
kernels; ``tools/torch_tp_bench.py``'s ``_profiled_step``), and the
cards' names and power limits (``nvidia-smi``) in its JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERTS = ("w_in", "w_out", "w_gate", "b_in", "b_out")


def parse(spec):
    """``"dp1xsp2xtp2"`` -> ("sp", (1, 2, 2))."""
    m = re.fullmatch(r"dp(\d+)x(sp|ep)(\d+)xtp(\d+)", spec)
    if not m:
        raise SystemExit(f"--mesh {spec!r}: expected dpAxspBxtpC or "
                         "dpAxepBxtpC")
    return m.group(2), tuple(int(m.group(i)) for i in (1, 3, 4))


def _build(kind, device, dev):
    """(model, (B, T)) of the mesh kind: GPT-2 medium at 2 x 8192 or the
    Mixtral-style Llama-340M at 4 x 2048 on the card; tiny ones on the
    CPU."""
    import torch
    from horovod_tpu_torch.models import get_model
    g = torch.Generator(device=dev).manual_seed(0)
    tiny = dict(num_layers=2, num_heads=4, d_model=64) \
        if device == "cpu" else {}
    with torch.device(dev):
        if kind == "sp":
            t = 8192 if device == "cuda" else 128
            if device == "cpu":
                tiny.update(vocab_size=512, dtype=torch.float32)
            return get_model(
                "gpt2" if device == "cpu" else "gpt2_medium",
                max_seq_len=t, attention="flash", use_ring_attention=True,
                ring_layout="striped", remat=True, remat_policy="dots",
                generator=g, **tiny), (2, t)
        if device == "cpu":
            tiny.update(num_kv_heads=2, d_ff=128, dtype=torch.float32)
        else:
            tiny = dict(num_layers=24, num_heads=16, num_kv_heads=4,
                        d_model=1024, d_ff=2816)
        t = 2048 if device == "cuda" else 64
        return get_model("llama", vocab_size=32000, max_seq_len=2048,
                         attention="flash", num_experts=8,
                         moe_router="top2", expert_capacity_factor=1.25,
                         remat=True, remat_policy="dots", generator=g,
                         **tiny), (4, t)


def worker(device, spec, steps, out_dir):
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    from horovod_tpu_torch.parallel import make_mesh, mp

    kind, dims = parse(spec)
    hvd.init(device=device)
    r, dev = hvd.rank(), hvd.device()
    cuda = device == "cuda"
    axes = ("dp", kind, "tp")
    mesh = make_mesh(dict(zip(axes, dims)))
    at = mesh.coords(r)
    tp_set = mesh.process_set("tp")
    model, (b, t) = _build(kind, device, dev)
    cfg = model.cfg
    whole = mp.param_bytes(model.state_dict())
    whole_experts = mp.param_bytes({
        k: v for k, v in model.state_dict().items()
        if k.split(".")[-1] in EXPERTS})
    tokens = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, t)), device=dev)
    rows = b // dims[0]
    batch = tokens[at["dp"] * rows:(at["dp"] + 1) * rows]
    # The bytes of this rank's part: the tp splits of the Megatron rules,
    # then E/ep of each expert weight.
    rules = mp.mp_partition_rules(cfg, "megatron")
    n_ep = dims[1] if kind == "ep" else 1
    part = 0
    for k, v in model.state_dict().items():
        nb = v.numel() * v.element_size()
        if dims[2] > 1 and mp._kind(rules, k) != "whole":
            nb //= dims[2]
        if k.split(".")[-1] in EXPERTS:
            nb //= n_ep
        part += nb
    if kind == "sp":
        model = mp.tensor_parallel(model, tp_set, sp=mesh.process_set("sp"))
        tok = batch[:, at["sp"]::dims[1]].contiguous()
        plane = mesh.process_set(("dp", "sp"))

        def loss_of():
            return mp.vocab_parallel_loss(model(tok), tok, tp_set,
                                          sp=model.sp, layout="striped")
        # Every hop of the striped ring runs its kernels, the forward's
        # twice under "dots".
        want = {k: cfg.num_layers * dims[1] * (2 if k == "flash_fwd" else 1)
                for k in fa.KERNELS}
    else:
        model = mp.tensor_parallel(model, tp_set, ep=mesh.process_set("ep"))
        tok = batch
        plane = mesh.process_set("dp")

        def loss_of():
            logits, aux = model(tok, return_aux=True)
            return mp.vocab_parallel_loss(logits, tok, tp_set) \
                + 1e-2 * aux.mean()
        want = {k: cfg.num_layers * (2 if k == "flash_fwd" else 1)
                for k in fa.KERNELS}
    held = mp.param_bytes(model.state_dict())
    experts = mp.param_bytes({
        k: v for k, v in model.state_dict().items()
        if k.split(".")[-1] in EXPERTS})
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8),
        process_set=plane)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    losses, wall, grew, split = [], [], [], []
    dp_set = mesh.process_set("dp")

    def step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)] \
            if cuda else None
        t0 = time.perf_counter()
        if cuda:
            ev[0].record()
        opt.zero_grad()
        loss = loss_of()
        t1 = time.perf_counter()
        if cuda:
            ev[1].record()
        loss.backward()
        t2 = time.perf_counter()
        if cuda:
            ev[2].record()
        opt.step()
        if cuda:
            ev[3].record()
        sync()
        wall.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            split.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
                         + [(t1 - t0) * 1e3, (t2 - t1) * 1e3])
        return loss

    for _ in range(steps):
        before = dict(fa.launches)
        loss = step()
        grew.append({k: fa.launches[k] - before[k] for k in fa.KERNELS})
        losses.append(hvd.allreduce(loss.detach().reshape(1).float(),
                                    op=hvd.Average,
                                    process_set=dp_set).item())
    step_ms = statistics.median(wall[1:]) if len(wall) > 1 else wall[0]
    split_ms = None if not split else dict(zip(
        ("forward", "backward", "optimizer", "host_forward",
         "host_backward"),
        (statistics.median(x[i] for x in split[1:] or split)
         for i in range(5))))
    profile = None
    if cuda:
        sys.path.insert(0, os.path.join(REPO, "tools"))
        from torch_tp_bench import _profiled_step
        profile = _profiled_step(step)
        profile["step_ms"] = wall.pop()
    out = {"rank": r, "mesh": spec, "coords": at, "losses": losses,
           "wall_ms": wall, "step_ms": step_ms,
           "tokens_per_s": b * t / step_ms * 1e3,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30
           if cuda else 0.0,
           "param_bytes": held, "param_bytes_ratio": held / whole,
           "expert_bytes": experts,
           "expert_bytes_ratio": experts / whole_experts
           if whole_experts else None,
           "launches_per_step": grew, "split_ms": split_ms,
           "profile": profile,
           "launches_ok": not cuda or all(x == want for x in grew)}
    out["param_bytes_ok"] = held == part and \
        experts * n_ep == whole_experts
    hvd.shutdown()
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as fh:
        json.dump(out, fh)


def _world(spec, device, steps, timeout):
    """Every rank's report of one spawned world on ``spec``."""
    _, dims = parse(spec)
    n = dims[0] * dims[1] * dims[2]
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
             str(n), "--timeout", str(int(timeout)),
             os.path.abspath(__file__), "--worker", device, spec,
             str(steps), "--out-dir", tmp],
            cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
            capture_output=True, text=True, timeout=timeout + 60)
        if proc.returncode != 0:
            raise RuntimeError(f"{spec} world failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        return [json.load(open(os.path.join(tmp, f"rank{i}.json")))
                for i in range(n)]


def _cards():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi failed: {e}"]


def run(specs, device, steps, band, timeout=1200.0):
    ones, jobs = {}, []
    for spec in specs:
        kind, dims = parse(spec)
        if kind not in ones:
            ones[kind] = _world(f"dp1x{kind}1xtp1", device, steps,
                                timeout)[0]
        one = ones[kind]
        per = _world(spec, device, steps, timeout)
        ref = one["losses"]
        diff = max(abs(a - w) for x in per
                   for a, w in zip(x["losses"], ref))
        row = dims[1] * dims[2]
        checks = {
            "one_rank_falls": all(map(math.isfinite, ref))
            and ref[-1] < ref[0],
            "within_band": diff <= band,
            "rows_agree": all(x["losses"] == per[(i // row) * row]["losses"]
                              for i, x in enumerate(per)),
            "param_bytes_are_the_part": all(x["param_bytes_ok"]
                                            for x in per),
            "launches": one["launches_ok"] and all(x["launches_ok"]
                                                   for x in per),
        }
        keep = ("losses", "step_ms", "tokens_per_s", "peak_gib",
                "param_bytes", "param_bytes_ratio", "expert_bytes",
                "expert_bytes_ratio", "wall_ms", "launches_per_step",
                "split_ms", "profile")
        jobs.append({"mesh": spec, "max_loss_diff": diff, "checks": checks,
                     "ok": all(checks.values()),
                     "one_rank": {k: one[k] for k in keep},
                     "per_rank": [{k: x[k] for k in keep + ("rank",
                                                            "coords")}
                                  for x in per]})
    return {"device": device, "steps": steps, "band": band,
            "cards": _cards() if device == "cuda" else None, "jobs": jobs,
            "ok": all(j["ok"] for j in jobs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default="dp1xsp2xtp2,dp2xsp2xtp1,dp1xep2xtp2",
                    help="comma-separated dpAx(sp|ep)BxtpC meshes")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--band", type=float, default=1e-3)
    ap.add_argument("--worker", nargs=3, help=argparse.SUPPRESS)
    ap.add_argument("--out-dir", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        device, spec, steps = args.worker
        worker(device, spec, int(steps), args.out_dir)
        return 0
    sys.path.insert(0, REPO)
    if args.device == "cuda":
        from horovod_tpu_torch.ops import _build
        _build.build()      # once, before the ranks load the kernels
    out = run(args.mesh.split(","), args.device, args.steps, args.band)
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
