#!/usr/bin/env python3
"""Pipelines across cards: ``python3 tools/torch_pp_bench.py --np N
[--device cuda|cpu] [--steps 3] [--band 1e-3]``.

GPT-2 medium (``attention="flash"``, bf16 compute, fp32 parameters, seed
0; a four-layer d-64 GPT-2 at 64 tokens with ``--device cpu``, a gloo
rehearsal) staged over real pp lines (``models/gpt2_pipeline.py``), each
rank its stage's block, the hops over NCCL: ``--np 2`` runs pp 2 with
GPipe and 1F1B, ``--np 4`` pp 4 with both and pp 2 x tp 2 with both, each
at M = 4(S - 1) microbatches of 2 x 1024 tokens (seed 0). A run is
``--steps`` loss-and-gradient steps on the same weights (no update). One
rank first runs the unstaged model on the same tokens with gradient
accumulation over the same microbatches: its loss and ms a step.

Per run and rank it reports the loss against the one card's, the
parameter bytes it holds (its block and ``rest``) and their share of the
whole model's, its peak memory, ms a step (median of steps 1 on, wall
clock behind ``torch.cuda.synchronize()`` and a barrier), the flash
kernels' launches a step, the most microbatches in flight under 1F1B, and
the bubble: the predicted (S - 1) / (M + S - 1) beside the measured 1 -
work / step, where work is the rank's own forward and backward of its M
microbatches (its blocks; the head on the last stage, the embedding on
the first; its tp sums under tp) timed alone, without the pipeline. On
the last stage of a GPipe run it also times, alone, the head's forward
and backward over the whole batch at once (``head_whole_batch_ms``), as
GPipe's loss runs it between the last forward tick and the first
backward tick while the other stages wait.

Checks (exit code 0 when every one holds): every rank's loss within
``--band`` of the one card's, the same loss on every rank of a run, each
flash kernel launched K x M times a step on each rank (K blocks a stage),
and stage s of a 1F1B run holding at most min(2(S - 1 - s) + 1, M)
microbatches. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MB = 2


def _runs(n):
    """(name, pp, tp, schedule) of each run at ``n`` ranks."""
    out = [(f"pp{n}_{s}", n, 1, s) for s in ("gpipe", "1f1b")]
    if n == 4:
        out += [(f"pp2_tp2_{s}", 2, 2, s) for s in ("gpipe", "1f1b")]
    return out


def _setup(device):
    """(a function that makes the model on a device, one that makes the
    (M, MB, T) tokens of M microbatches) for ``device``."""
    import numpy as np
    import torch
    from horovod_tpu_torch.models import get_model
    from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config
    t = 1024 if device == "cuda" else 64

    def build(dev):
        if device == "cuda":
            with torch.device(dev):
                return get_model("gpt2_medium", attention="flash",
                                 generator=torch.Generator(
                                     device=dev).manual_seed(0))
        return GPT2(GPT2Config(vocab_size=512, max_seq_len=t, num_layers=4,
                               num_heads=4, d_model=64, attention="flash"),
                    generator=torch.Generator().manual_seed(0))

    def tokens(m, vocab, dev):
        rng = np.random.default_rng(0)
        return torch.tensor(rng.integers(0, vocab, (m, MB, t)), device=dev)

    return build, tokens


def _sync(cuda):
    import torch
    if cuda:
        torch.cuda.synchronize()


def one_worker(device, steps, n, out_dir):
    """The unstaged model on one rank: each run's accumulated loss and ms
    a step."""
    sys.path.insert(0, REPO)
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.gpt2 import loss_fn
    hvd.init(device=device)
    dev, cuda = hvd.device(), device == "cuda"
    build, tokens = _setup(device)
    model = build(dev)
    out = {}
    for m in sorted({4 * (pp - 1) for _, pp, _, _ in _runs(n)}):
        tok = tokens(m, model.cfg.vocab_size, dev)
        ms, loss = [], None
        for _ in range(steps):
            model.zero_grad(set_to_none=True)
            _sync(cuda)
            t0 = time.perf_counter()
            loss = 0.0
            for i in range(m):
                li = loss_fn(model(tok[i]), tok[i]) / m
                li.backward()
                loss += li.item()
            _sync(cuda)
            ms.append((time.perf_counter() - t0) * 1e3)
        out[str(m)] = {"loss": loss, "step_ms": statistics.median(ms[1:])}
    with open(os.path.join(out_dir, "rank0.json"), "w") as fh:
        json.dump(out, fh)
    hvd.shutdown()


def _work_ms(cfg, stage_fn, local, rest, tok, stage, last, cuda, dev):
    """The stage's own forward and backward of its microbatches, alone:
    ms (median of 3)."""
    import torch
    from horovod_tpu_torch.models import gpt2_pipeline as gp
    blocks = {k: v.squeeze(0).detach().requires_grad_()
              for k, v in local.items()}
    g = torch.Generator(device=dev).manual_seed(stage)
    m, mb, t = tok.shape
    x = torch.randn((mb, t, cfg.d_model), generator=g, device=dev) \
        .to(cfg.dtype)
    ms = []
    for _ in range(3):
        _sync(cuda)
        t0 = time.perf_counter()
        for i in range(m):
            h = gp._embed(cfg, rest, tok[i]) if stage == 0 else x
            h = h.detach().requires_grad_()
            y = stage_fn(blocks, h)
            if last:
                loss = gp._head_loss(cfg, rest, y, tok[i])
                torch.autograd.grad(loss, [h] + list(blocks.values()))
            else:
                torch.autograd.grad(y, [h] + list(blocks.values()), y)
        _sync(cuda)
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def _head_whole_ms(cfg, rest, tok, cuda, dev):
    """GPipe's loss alone: the fp32 ``ln_f`` and tied head's forward and
    backward over all M microbatches at once, ms (median of 3)."""
    import torch
    from horovod_tpu_torch.models import gpt2_pipeline as gp
    m, mb, t = tok.shape
    leaves = {k: v.detach().requires_grad_() for k, v in rest.items()}
    g = torch.Generator(device=dev).manual_seed(m)
    y = torch.randn((m * mb, t, cfg.d_model), generator=g, device=dev) \
        .to(cfg.dtype).requires_grad_()
    ms = []
    for _ in range(3):
        _sync(cuda)
        t0 = time.perf_counter()
        loss = gp._head_loss(cfg, leaves, y, tok.reshape(m * mb, t))
        torch.autograd.grad(loss, [y] + list(leaves.values()),
                            allow_unused=True)
        del loss
        _sync(cuda)
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def pp_worker(device, steps, n, out_dir):
    """Every run of ``_runs(n)`` on this rank."""
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt2_pipeline as gp
    from horovod_tpu_torch.parallel import make_mesh, shard_pytree
    from horovod_tpu_torch.parallel.mp import param_bytes
    from horovod_tpu_torch.parallel.sharding import P, PartitionRules
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    hvd.init(device=device)
    r, dev, cuda = hvd.rank(), hvd.device(), device == "cuda"
    build, tokens = _setup(device)
    meshes, out = {}, {}
    for name, pp, tp, schedule in _runs(n):
        axes = {"pp": pp, "tp": tp} if tp > 1 else {"pp": pp}
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = make_mesh(axes)
        mesh = meshes[key]
        coords = mesh.coords(r)
        model = build(dev)
        cfg = model.cfg
        whole = param_bytes(dict(model.named_parameters()))
        state = {k: v.detach() for k, v in model.state_dict().items()}
        del model
        if tp > 1:
            blocks, rest = gp.make_pp_tp_params(state, pp, cfg.num_heads)
            rules = gp.block_specs_tp()
        else:
            blocks, rest = gp.stack_block_params(state, pp)
            rules = PartitionRules([(r"", P("pp"))])
        local = shard_pytree(blocks, mesh, rules)
        del state, blocks
        pp_set = mesh.process_set("pp")
        tp_set = mesh.process_set("tp") if tp > 1 else None
        m = 4 * (pp - 1)
        tok = tokens(m, cfg.vocab_size, dev)
        if tp > 1:
            make = (gp.gpt2_pp_tp_loss_and_grad if schedule == "gpipe"
                    else gp.gpt2_pp_tp_1f1b_loss_and_grad)
            step = make(cfg, pp_set, tp_set)
        else:
            make = (gp.gpt2_pp_loss_and_grad if schedule == "gpipe"
                    else gp.gpt2_pp_1f1b_loss_and_grad)
            step = make(cfg, pp_set)
        _sync(cuda)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ms, losses, grew = [], [], []
        for _ in range(steps):
            _sync(cuda)
            dist.barrier()
            before = dict(fa.launches)
            t0 = time.perf_counter()
            loss, gb, gr = step(local, rest, tok)
            losses.append(float(loss))
            _sync(cuda)
            ms.append((time.perf_counter() - t0) * 1e3)
            grew.append({k: fa.launches[k] - before[k] for k in fa.KERNELS})
            del gb, gr
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None
        stage, last = coords["pp"], coords["pp"] == pp - 1
        stage_fn = gp._stage_fn(cfg, gp._tensor_parallel(tp_set)
                                if tp > 1 else None)
        dist.barrier()
        work = _work_ms(cfg, stage_fn, local, rest, tok, stage, last, cuda,
                        dev)
        head = (_head_whole_ms(cfg, rest, tok, cuda, dev)
                if last and schedule == "gpipe" else None)
        step_ms = statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
        k = cfg.num_layers // pp
        core = getattr(step, "core", None)
        out[name] = {
            "pp": pp, "tp": tp, "schedule": schedule, "m": m, "stage": stage,
            "losses": losses, "step_ms": step_ms, "work_ms": work,
            "bubble_measured": 1.0 - work / step_ms,
            "bubble_predicted": (pp - 1) / (m + pp - 1),
            "head_whole_batch_ms": head,
            "peak_gib": peak,
            "param_bytes": param_bytes(local) + param_bytes(rest),
            "param_bytes_ratio": (param_bytes(local) + param_bytes(rest))
            / whole,
            "launches_per_step": grew[-1],
            # The CPU runs the kernels' plain versions, which count none.
            "launches_ok": all(g == {x: k * m if cuda else 0
                                     for x in fa.KERNELS} for g in grew),
            "in_flight": core.peak_in_flight if core else None,
            "in_flight_bound": min(2 * (pp - 1 - stage) + 1, m)}
        del local, rest
        if cuda:
            torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as fh:
        json.dump(out, fh)
    hvd.shutdown()


def _world(nranks, args, timeout):
    """Every rank's report of one spawned world running ``args``."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
             str(nranks), "--timeout", str(int(timeout)),
             os.path.abspath(__file__)] + args + ["--out-dir", tmp],
            cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
            capture_output=True, text=True, timeout=timeout + 60)
        if proc.returncode != 0:
            raise RuntimeError(f"{args} world failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        return [json.load(open(os.path.join(tmp, f"rank{i}.json")))
                for i in range(nranks)]


def run(n, device, steps, band, timeout=900.0):
    one = _world(1, ["--worker", "one", device, str(steps), str(n)],
                 timeout)[0]
    per = _world(n, ["--worker", "pp", device, str(steps), str(n)], timeout)
    runs, ok = {}, True
    for name, pp, tp, schedule in _runs(n):
        ranks = [x[name] for x in per]
        ref = one[str(ranks[0]["m"])]
        diff = max(abs(l - ref["loss"]) for x in ranks for l in x["losses"])
        checks = {
            "within_band": diff <= band,
            "same_loss_on_every_rank": len({l for x in ranks
                                            for l in x["losses"]}) == 1,
            "launches": all(x["launches_ok"] for x in ranks),
            "in_flight": schedule == "gpipe" or all(
                x["in_flight"] <= x["in_flight_bound"] for x in ranks),
            "finite": all(math.isfinite(l) for x in ranks
                          for l in x["losses"]),
        }
        ok = ok and all(checks.values())
        runs[name] = {"pp": pp, "tp": tp, "schedule": schedule,
                      "m": ranks[0]["m"], "mb": MB,
                      "one_card_loss": ref["loss"],
                      "one_card_step_ms": ref["step_ms"],
                      "max_loss_diff": diff, "checks": checks,
                      "per_rank": ranks}
    return {"ranks": n, "device": device, "steps": steps, "band": band,
            "ok": ok, "runs": runs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--np", type=int, default=2, choices=(2, 4))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--band", type=float, default=1e-3)
    ap.add_argument("--worker", nargs=4, help=argparse.SUPPRESS)
    ap.add_argument("--out-dir", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        role, device, steps, n = args.worker
        (one_worker if role == "one" else pp_worker)(
            device, int(steps), int(n), args.out_dir)
        return 0
    sys.path.insert(0, REPO)
    if args.device == "cuda":
        from horovod_tpu_torch.ops import _build
        _build.build()      # once, before the ranks load the kernels
    out = run(args.np, args.device, args.steps, args.band)
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
