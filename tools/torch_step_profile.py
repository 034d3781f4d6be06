#!/usr/bin/env python3
"""Where a GPT-2 medium training step of horovod_tpu_torch spends its time on
one GPU: host or device.

    python3 tools/torch_step_profile.py [--root DIR]

Drives ``chip_smoke.py``'s main path (GPT-2 medium, 24 layers, d 1024, B 8,
T 1024, bf16, ``attention="flash"``, ``DistributedOptimizer(AdamW)`` on one
NCCL rank, random weights from seed 0) with the ``horovod_tpu_torch``
package found under ``--root`` (default: this checkout), so that two trees
can be measured by the same script in one run. Per section of the step
(forward with the loss, backward, allreduce + AdamW) it prints:

* over ``STEPS`` steps after two warm-up steps, the median device time
  between CUDA events and the median host time the section takes to queue
  its work (perf_counter around the calls, no synchronisation inside);
* over one more step under ``torch.profiler``, the device's busy time (the
  union of its kernels, copies and sets) per section, by the section whose
  host range launched them, and the time of the flash kernels among them.

The section's idle share is 1 - busy / (device time between its events).
A section whose host time reaches its device time while its idle share is
large is held back by the host. The last line is one JSON object with every
number. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

SECTIONS = ("forward", "backward", "optimizer")
STEPS = 8
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union_ms(intervals) -> float:
    """Length in ms of the union of (start_us, end_us) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def device_busy(trace: dict) -> dict:
    """Per section: device busy ms, of it the flash kernels' ms, and the
    number of device events, from a chrome trace of torch.profiler. A
    device event belongs to the section whose host range holds the runtime
    call that launched it (matched by correlation id)."""
    ev = trace.get("traceEvents", [])
    ranges = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in ev
              if e.get("cat") == "user_annotation" and e["name"] in SECTIONS}
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in ev
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    out = {s: {"busy": [], "flash": [], "n": 0} for s in SECTIONS}
    for e in ev:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        for s, (a, b) in ranges.items():
            if t is not None and a <= t <= b:
                iv = (e["ts"], e["ts"] + e["dur"])
                out[s]["busy"].append(iv)
                if "flash" in e["name"]:
                    out[s]["flash"].append(iv)
                out[s]["n"] += 1
    return {s: {"busy_ms": _union_ms(v["busy"]),
                "flash_ms": _union_ms(v["flash"]), "events": v["n"]}
            for s, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose horovod_tpu_torch is measured")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch
    if not torch.cuda.is_available():
        print("torch_step_profile: needs a CUDA card", file=sys.stderr)
        return 1
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config, loss_fn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    hvd.init()
    dev = hvd.device()
    cfg = GPT2Config.medium(attention="flash")
    B, T = 8, 1024
    model = GPT2(cfg, torch.Generator().manual_seed(0)).to(dev)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8))
    tokens = torch.randint(0, cfg.vocab_size, (B, T),
                           generator=torch.Generator().manual_seed(0)).to(dev)

    def step(record=None):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        host = []
        ev[0].record()
        for i, name in enumerate(SECTIONS):
            t0 = time.perf_counter()
            with (record(name) if record else contextlib.nullcontext()):
                if name == "forward":
                    opt.zero_grad()
                    loss = loss_fn(model(tokens), tokens)
                elif name == "backward":
                    loss.backward()
                else:
                    opt.step()
            host.append((time.perf_counter() - t0) * 1e3)
            ev[i + 1].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)], host

    for _ in range(2):
        step()
    dev_ms, host_ms = [], []
    for _ in range(STEPS):
        d, h = step()
        dev_ms.append(d)
        host_ms.append(h)
    med = {s: {"device_ms": statistics.median(d[i] for d in dev_ms),
               "host_ms": statistics.median(h[i] for h in host_ms),
               "device_ms_each": [d[i] for d in dev_ms]}
           for i, s in enumerate(SECTIONS)}

    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_dev, prof_host = step(record_function)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            busy = device_busy(json.load(f))
    finally:
        os.unlink(path)
    hvd.shutdown()

    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip().splitlines()
    print(f"{smi[0] if smi else 'nvidia-smi: no card'}; root {args.root}")
    for i, s in enumerate(SECTIONS):
        m, b = med[s], busy[s]
        idle = 1 - b["busy_ms"] / m["device_ms"] if m["device_ms"] else 0.0
        m.update(b, profiled_device_ms=prof_dev[i],
                 profiled_host_ms=prof_host[i], idle_share=idle)
        print(f"{s}: device {m['device_ms']:.1f} ms between events (each "
              f"step {', '.join(f'{x:.1f}' for x in m['device_ms_each'])}), "
              f"host {m['host_ms']:.1f} ms to queue it; profiled step: "
              f"device busy {b['busy_ms']:.1f} ms ({b['events']} events, "
              f"flash kernels {b['flash_ms']:.2f} ms), idle share "
              f"{idle:.3f}")
    print(json.dumps({"root": args.root, "sections": med}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
