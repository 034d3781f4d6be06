#!/usr/bin/env python3
"""One rank, or hot spare, of an elastic GPT-2 run of the port.

Launched by ``horovod_tpu_torch.runner.run_elastic`` (``chip_smoke.py``
phase 8, ``tests/test_torch_port_launcher.py``,
``tests/test_torch_port_card.py``)::

    run_elastic([sys.executable, "tools/torch_elastic_worker.py",
                 "--steps", "5"], np=1, spares=1,
                extra_env={"HOROVOD_FAULT_PLAN": "kill@rank=0,step=4"})

A spare waits in ``standby_if_spare()`` without touching a GPU. A rank
builds the model (``--model gpt2_medium``: ``chip_smoke.build_path``,
phase 3's GPT-2 medium, flash attention, bf16, seed 0, its slice of the
batch; ``--model tiny``: a two-layer fp32 GPT-2 at B 4, T 32), wraps it
in a ``TorchState`` and a ``ShardedCheckpointManager`` under the elastic
state dir, and when a manifest is published (a relaunch), rank 0 adopts
the newest one and ``sync()`` sends it to every rank. Then, under
``@hvd.elastic.run(checkpoint=mgr)``, each step calls
``faults.fault_point(step)``, trains, commits and saves the commit with
``save_state``. Rank 0 appends one JSON line a step to
``<state dir>/steps.jsonl`` (attempt, world, step, loss, each kernel's
launches in the step, step and ``save()`` times), flushed at once so a
killed attempt's lines survive, and one line of timings when the attempt
ends; a promoted spare appends whether it held a CUDA context in standby,
and a rank whose training raises appends the error before it re-raises.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

T_IMPORTED = time.time()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_TO_KEEP = 2     # published steps kept: the disk holds three saves
sys.path.insert(0, REPO)

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import elastic, faults, metrics  # noqa: E402
from horovod_tpu_torch import checkpoint_sharded as cs  # noqa: E402
fa = importlib.import_module(  # noqa: E402
    "horovod_tpu_torch.ops.flash_attention")


def log_line(path, record):
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
        f.flush()


def build_tiny(dev, rank, world):
    """A two-layer fp32 GPT-2 from seed 0; the global batch (B 4, T 32)
    split by rows over the ranks."""
    from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config, loss_fn
    model = GPT2(GPT2Config.tiny(dtype=torch.float32, attention="flash"),
                 torch.Generator().manual_seed(0)).to(dev)
    tokens = torch.randint(0, 256, (4, 32),
                           generator=torch.Generator().manual_seed(0))
    per = 4 // world
    inputs = tokens[rank * per:(rank + 1) * per].to(dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-3, weight_decay=1e-4, eps=1e-8))
    return model, opt, lambda: loss_fn(model(inputs), inputs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="gpt2_medium",
                    choices=("gpt2_medium", "tiny"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--max-pending", type=int, default=2,
                    help="saves in flight before save() waits")
    ap.add_argument("--wait-spares", type=int, default=0,
                    help="first attempt: wait until this many spares have "
                         "registered before the first step")
    args = ap.parse_args()
    sdir = elastic.state_dir()
    if not sdir:
        sys.exit("torch_elastic_worker.py runs under runner.run_elastic "
                 "(HVD_TPU_ELASTIC_STATE_DIR is not set)")
    log = os.path.join(sdir, "steps.jsonl")
    promo = elastic.standby_if_spare()
    t_promoted = time.time()
    if promo is not None:
        log_line(log, {"event": "promoted", "rank": promo["rank"],
                       "world": promo["world"],
                       "restart": promo["restart"],
                       "cuda_initialized_in_standby":
                           torch.cuda.is_initialized(),
                       "promoted_at": t_promoted})
    attempt = elastic.restart_count()
    hvd.init(device=args.device)
    t_init = time.time()
    rank, world, dev = hvd.rank(), hvd.size(), hvd.device()
    if args.model == "gpt2_medium":
        import chip_smoke
        per = 8 // world
        model, opt, loss_of, _ = chip_smoke.build_path(
            "gpt2_medium", dev, rows=slice(rank * per, (rank + 1) * per))
    else:
        model, opt, loss_of = build_tiny(dev, rank, world)
    t_built = time.time()
    state = elastic.TorchState(model=model, optimizer=opt, step=0)
    mgr = cs.ShardedCheckpointManager(os.path.join(sdir, "ckpt"),
                                      max_to_keep=MAX_TO_KEEP,
                                      max_pending=args.max_pending)
    restored = None
    seen = {}
    if mgr.latest_step() is not None:
        if rank == 0:
            seen = {"published": mgr.all_steps(),
                    "unpublished": sorted(
                        int(d[len("step-"):]) for d in os.listdir(mgr.directory)
                        if d.startswith("step-")
                        and int(d[len("step-"):]) not in mgr.all_steps())}
            restored = cs.adopt_state(mgr, state)
        state.sync()
    t_restored = time.time()
    if attempt == 0 and rank == 0 and args.wait_spares:
        deadline = time.monotonic() + 120
        while len(elastic.list_spares(sdir)) < args.wait_spares:
            if time.monotonic() > deadline:
                sys.exit("the spares never registered")
            time.sleep(0.05)
    cuda = dev.type == "cuda"
    fa.reset_launches()

    @elastic.run
    def train(state):
        while state.step < args.steps:
            s = state.step
            faults.fault_point(s)
            before = dict(fa.launches)
            t0 = time.perf_counter()
            opt.zero_grad()
            loss = loss_of()
            loss.backward()
            opt.step()
            if world > 1:
                loss = hvd.allreduce(loss.detach(), op=hvd.Average)
            value = loss.item()
            if cuda:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            state.step = s + 1
            state.commit()
            if cuda:
                torch.cuda.synchronize()
            t2 = time.perf_counter()
            cs.save_state(mgr, s, state)
            t3 = time.perf_counter()
            if rank == 0:
                log_line(log, {
                    "attempt": attempt, "rank": rank, "world": world,
                    "step": s, "loss": value,
                    "launches": {k: fa.launches[k] - before[k]
                                 for k in fa.KERNELS},
                    "step_s": t1 - t0, "commit_s": t2 - t1,
                    "save_hold_s": t3 - t2, "step_with_save_s": t3 - t0})

    try:
        train(state, checkpoint=mgr)
    except Exception as e:
        log_line(log, {"event": "error", "attempt": attempt, "rank": rank,
                       "step": state.step,
                       "error": f"{type(e).__name__}: {e}"[:500]})
        raise
    mgr.wait()
    t_written = time.time()
    snap = metrics.snapshot()

    def hist(name, **labels):
        for h in snap["histograms"].get(name, []):
            if all(h["labels"].get(k) == v for k, v in labels.items()):
                return {"count": h["count"], "sum": h["sum"]}
        return None

    def value(family, name, **labels):
        for g in snap[family].get(name, []):
            if all(g["labels"].get(k) == v for k, v in labels.items()):
                return g["value"]
        return None

    if rank == 0:
        log_line(log, {
            "event": "done", "attempt": attempt, "world": world,
            "restored_step": restored, "checkpoints_seen": seen,
            "promoted": promo is not None,
            "t_start": T_START, "t_imported": T_IMPORTED,
            "t_promoted": t_promoted, "t_init": t_init,
            "t_built": t_built, "t_restored": t_restored,
            "t_written": t_written,
            "failed_at": float(promo["failed_at"]) if promo and
            promo.get("failed_at") is not None else None,
            "elastic_recovery_seconds": value(
                "gauges", "elastic_recovery_seconds"),
            "checkpoint_save_seconds": hist("checkpoint_save_seconds",
                                            kind="shard"),
            "checkpoint_restore_seconds": hist(
                "checkpoint_restore_seconds", kind="shard"),
            "checkpoint_bytes_total": value(
                "counters", "checkpoint_bytes_total", kind="full")})
    mgr.close()
    hvd.shutdown()


if __name__ == "__main__":
    main()
