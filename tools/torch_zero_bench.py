#!/usr/bin/env python3
"""ZeRO-1 across cards: ``python3 tools/torch_zero_bench.py --np N
[--device cuda|cpu] [--steps 5] [--band 1e-3]``.

GPT-2 medium (``attention="flash"``, bf16 compute, fp32 parameters, seed
0; a two-layer d-64 GPT-2 with ``--device cpu``, a gloo rehearsal) trains
``--steps`` steps of ``sharded_adamw(1e-4, weight_decay=1e-4, eps=1e-8)``
on one fixed global batch of 8 x 1024 tokens (``chip_smoke.py`` phase 3's
rows), twice: on N ranks (NCCL, one card a rank), each rank taking its
``ShardedBatchIterator`` share of the batch (rows r, r + N, ...), its
loss and gradients from ``hvd.value_and_grad`` over
``torch.func.functional_call``; and on one rank over the whole batch.
Checks:

* every step's loss on N ranks lies within ``--band`` of the one rank's
  (the same mean over the same tokens, summed in another order), the
  ranks agree, the losses are finite and falling;
* each rank's moments hold ceil(L/N) elements (L parameter elements), and
  each kernel launches ``num_layers`` times a step;
* the N-rank job's last state, saved through ``ShardedCheckpointManager``
  (``checkpoint_sharded.save_state`` of a ``TensorState``: each rank
  writes its row), restores on one rank (N -> 1) equal, bit for bit, to
  the N ranks' rows gathered (``reshard_opt_state``).

Per rank it reports ms a step (median of steps 1 on, wall clock behind
``torch.cuda.synchronize()``), peak memory and the moments' bytes. Prints
one JSON line; exit code 0 when every check holds. ``chip_smoke.py``
phase 11 (e) runs it with ``--np 2`` where the machine has two cards.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T = 8, 1024


def _digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def worker(device, steps, out_dir, ckpt_dir):
    sys.path.insert(0, REPO)
    import torch
    from torch.func import functional_call
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint_sharded as cs
    from horovod_tpu_torch.data import ShardedBatchIterator
    from horovod_tpu_torch.elastic import TensorState
    from horovod_tpu_torch.models import get_model
    from horovod_tpu_torch.models.gpt2 import loss_fn
    from horovod_tpu_torch.ops import flash_attention as fa

    hvd.init(device=device)
    r, n, dev = hvd.rank(), hvd.size(), hvd.device()
    name, width = ("gpt2_medium", {}) if device == "cuda" else (
        "gpt2", dict(num_layers=2, num_heads=4, d_model=64, vocab_size=512,
                     max_seq_len=T, dtype=torch.float32))
    with torch.device(dev):
        model = get_model(name, attention="flash", generator=torch.Generator(
            device=dev).manual_seed(0), **width)
    cfg = model.cfg
    tokens = torch.randint(0, cfg.vocab_size, (B, T),
                           generator=torch.Generator().manual_seed(0))
    batches = ShardedBatchIterator([tokens.numpy()], B // n, shuffle=False)
    params = dict(model.named_parameters())
    length = sum(p.numel() for p in params.values())

    def f(p, t):
        return loss_fn(functional_call(model, p, (t,)), t)

    opt = hvd.sharded_adamw(1e-4, weight_decay=1e-4, eps=1e-8)
    state = opt.init(params)
    vg = hvd.value_and_grad(f)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, wall, grew = [], [], []
    for epoch in range(steps):
        batches.set_epoch(epoch)
        (rows,), _ = next(iter(batches))
        tok = torch.from_numpy(rows).to(dev)
        before = dict(fa.launches)
        t0 = time.perf_counter()
        value, grads = vg(params, tok)
        upd, state = opt.update(grads, state, params)
        with torch.no_grad():
            for k, p in params.items():
                p.add_(upd[k])
        if device == "cuda":
            torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        losses.append(value.item())
        grew.append({k: fa.launches[k] - before[k] for k in fa.KERNELS})
        del grads, upd
    out = {"rank": r, "ranks": n, "losses": losses, "wall_ms": wall,
           "step_ms": statistics.median(wall[1:]),
           "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                        if device == "cuda" else 0.0),
           "params": length, "mu_elements": int(state.mu.numel()),
           "moment_bytes": 2 * state.mu.numel() * state.mu.element_size(),
           "launches_per_step": grew,
           "launches_ok": device != "cuda" or all(
               x == {k: cfg.num_layers for k in fa.KERNELS} for x in grew)}
    if ckpt_dir:
        st = TensorState(params={k: p.detach() for k, p in params.items()},
                         opt_state=state)
        mgr = cs.ShardedCheckpointManager(ckpt_dir)
        cs.save_state(mgr, steps, st, wait=True)
        mgr.close()
        whole = cs.reshard_opt_state(state, 1, unpadded_len=length)
        out["gathered"] = {k: _digest(getattr(whole, k))
                           for k in ("step", "mu", "nu")}
    hvd.shutdown()
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as fh:
        json.dump(out, fh)


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
        ranks = []
        for i in range(nranks):
            with open(os.path.join(tmp, f"rank{i}.json")) as fh:
                ranks.append(json.load(fh))
    return ranks


def _restore_on_one(ckpt_dir, length):
    """The N-rank save restored for one rank: its row's digests."""
    sys.path.insert(0, REPO)
    from horovod_tpu_torch import checkpoint_sharded as cs
    res = cs.ShardedCheckpointManager(ckpt_dir).restore(num_shards=1)
    packed = {k.split("['opt_state']")[1].strip("[]'"): v
              for k, v in res.shards.items() if k.startswith("['opt_state']")}
    row = cs.unpack_opt_state(packed, rank=0)
    return {"step": _digest(row.step), "mu": _digest(row.mu),
            "nu": _digest(row.nu), "mu_elements": int(row.mu.numel()),
            "unpadded": length}


def run(nranks, device, steps, band, timeout=900.0):
    one = _world(1, ["--worker", device, str(steps), ""], timeout)[0]
    ckpt = tempfile.mkdtemp(prefix="zero_bench_")
    try:
        per = _world(nranks, ["--worker", device, str(steps), ckpt],
                     timeout)
        restored = _restore_on_one(ckpt, per[0]["params"])
    finally:
        import shutil
        shutil.rmtree(ckpt, ignore_errors=True)
    ref = one["losses"]
    diff = max(abs(a - w) for x in per for a, w in zip(x["losses"], ref))
    c = -(-per[0]["params"] // nranks)
    checks = {
        "one_rank_falls": all(map(math.isfinite, ref)) and ref[-1] < ref[0],
        "within_band": diff <= band,
        "ranks_agree": all(x["losses"] == per[0]["losses"] for x in per),
        "rows_ceil_l_over_n": all(x["mu_elements"] == c for x in per),
        "launches": one["launches_ok"] and all(x["launches_ok"]
                                               for x in per),
        "restore_n_to_1_bit_equal": restored["mu_elements"] ==
        per[0]["params"] and all(
            restored[k] == per[0]["gathered"][k] for k in ("step", "mu",
                                                          "nu")),
    }
    return {"ranks": nranks, "device": device, "steps": steps,
            "band": band, "max_loss_diff": diff, "checks": checks,
            "ok": all(checks.values()), "one_rank": one,
            "per_rank": [{k: v for k, v in x.items() if k != "gathered"}
                         for x in per]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--np", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--band", type=float, default=1e-3)
    ap.add_argument("--worker", nargs=3, help=argparse.SUPPRESS)
    ap.add_argument("--out-dir", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        device, steps, ckpt = args.worker
        worker(device, int(steps), args.out_dir, ckpt)
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
