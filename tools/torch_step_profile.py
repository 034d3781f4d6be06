#!/usr/bin/env python3
"""Where a training step of horovod_tpu_torch spends its time on one GPU:
host or device, and which kernels.

    python3 tools/torch_step_profile.py [--model gpt2_medium|resnet50|
                                        bert_large|vit_b16|llama_340m|
                                        gpt2_medium_dots|gpt2_medium_full|
                                        gpt2_long|gpt2_packed|llama_moe|
                                        t5_small] [--root DIR]

``gpt2_medium`` (default) drives ``chip_smoke.py``'s main path (GPT-2
medium, 24 layers, d 1024, B 8, T 1024, bf16, ``attention="flash"``,
``DistributedOptimizer(AdamW)``); ``resnet50`` its phase 4 (ResNet-50,
B 128, 224x224, bf16, ``channels_last``, local BN,
``DistributedOptimizer(SGD(0.1, momentum 0.9))``); ``bert_large``,
``vit_b16`` and ``llama_340m`` its phase 5 paths, and the others its
phase 9 paths (GPT-2 medium under ``remat_policy="dots"`` / ``"full"``,
at 4k tokens, packed; the Mixtral-style Llama; T5-small), built by
``chip_smoke.build_path`` of this checkout. All on one NCCL rank,
random weights and data from seed 0, with the ``horovod_tpu_torch``
package found under ``--root`` (default: this checkout), so that two trees
can be measured by the same script in one run. Per section of the step
(forward with the loss, backward, allreduce + the optimizer) it prints:

* over ``STEPS`` steps after two warm-up steps, the median device time
  between CUDA events and the median host time the section takes to queue
  its work (perf_counter around the calls, no synchronisation inside);
* over one more step under ``torch.profiler``, the device's busy time (the
  union of its kernels, copies and sets) per section, by the section whose
  host range launched them, and among them the time of the port's flash
  kernels (GPT-2) or of the convolution kernels (ResNet: cuDNN's and
  cuBLAS's GEMM-like kernels, by name).

The section's idle share is 1 - busy / (device time between its events).
A section whose host time reaches its device time while its idle share is
large is held back by the host. Then the profiled step's ten kernels with
the most device time. The last line is one JSON object with every number.
Needs one CUDA card.
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
# Kernel-name parts that mark a convolution or matrix product (cuDNN,
# cuBLAS, CUTLASS) in a ResNet step.
CONV_NAMES = ("conv", "gemm", "xmma", "fprop", "dgrad", "wgrad", "cudnn",
              "cutlass")


def is_conv(name: str) -> bool:
    n = name.lower()
    return any(k in n for k in CONV_NAMES)


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


def device_busy(trace: dict, marked=lambda name: "flash" in name) -> dict:
    """Per section: device busy ms, of it the ms of the kernels ``marked``
    picks (as ``marked_ms``), and the number of device events, from a chrome
    trace of torch.profiler. A device event belongs to the section whose
    host range holds the runtime call that launched it (matched by
    correlation id)."""
    ev = trace.get("traceEvents", [])
    ranges = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in ev
              if e.get("cat") == "user_annotation" and e["name"] in SECTIONS}
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in ev
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    out = {s: {"busy": [], "marked": [], "n": 0} for s in SECTIONS}
    for e in ev:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        for s, (a, b) in ranges.items():
            if t is not None and a <= t <= b:
                iv = (e["ts"], e["ts"] + e["dur"])
                out[s]["busy"].append(iv)
                if marked(e["name"]):
                    out[s]["marked"].append(iv)
                out[s]["n"] += 1
    return {s: {"busy_ms": _union_ms(v["busy"]),
                "marked_ms": _union_ms(v["marked"]), "events": v["n"]}
            for s, v in out.items()}


def top_kernels(trace: dict, n: int = 10) -> list:
    """The ``n`` kernel names with the most device ms in the trace:
    [(name, ms, launches)]."""
    tot: dict = {}
    for e in trace.get("traceEvents", []):
        if e.get("cat") == "kernel":
            ms, k = tot.get(e["name"], (0.0, 0))
            tot[e["name"]] = (ms + e["dur"] / 1e3, k + 1)
    return sorted(((k, ms, c) for k, (ms, c) in tot.items()),
                  key=lambda t: -t[1])[:n]


# chip_smoke.build_path's paths measured here, with the config fields that
# differ from the path's own (GPT-2 medium under remat, phase 9 (b)).
CHIP_SMOKE_PATHS = {
    "bert_large": ("bert_large", None), "vit_b16": ("vit_b16", None),
    "llama_340m": ("llama_340m", None),
    "gpt2_medium_dots": ("gpt2_medium", dict(remat=True,
                                             remat_policy="dots")),
    "gpt2_medium_full": ("gpt2_medium", dict(remat=True,
                                             remat_policy="full")),
    "gpt2_long": ("gpt2_long", None), "gpt2_packed": ("gpt2_packed", None),
    "llama_moe": ("llama_moe", None), "t5_small": ("t5_small", None),
}


def build(model_name: str, dev):
    """(model, optimizer, forward-and-loss closure) of one configuration."""
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    if model_name in CHIP_SMOKE_PATHS:
        sys.path.insert(1, str(Path(__file__).resolve().parents[1]))
        import chip_smoke
        name, cfg_extra = CHIP_SMOKE_PATHS[model_name]
        _, opt, loss, _ = chip_smoke.build_path(name, dev,
                                                cfg_extra=cfg_extra)
        return opt, loss
    if model_name == "gpt2_medium":
        from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config, loss_fn
        cfg = GPT2Config.medium(attention="flash")
        model = GPT2(cfg, torch.Generator().manual_seed(0)).to(dev)
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8))
        tokens = torch.randint(0, cfg.vocab_size, (8, 1024),
                               generator=torch.Generator().manual_seed(0))
        tokens = tokens.to(dev)
        return opt, lambda: loss_fn(model(tokens), tokens)
    from horovod_tpu_torch.models.resnet import ResNet50
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                         generator=g)
    model = model.to(memory_format=torch.channels_last)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1, momentum=0.9))
    x = torch.randn(128, 3, 224, 224, generator=g, device=dev).to(
        memory_format=torch.channels_last)
    y = torch.randint(0, 1000, (128,), generator=g, device=dev)
    return opt, lambda: F.cross_entropy(model(x), y)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="gpt2_medium",
                    choices=("gpt2_medium", "resnet50")
                    + tuple(CHIP_SMOKE_PATHS))
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose horovod_tpu_torch is measured")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch
    if not torch.cuda.is_available():
        print("torch_step_profile: needs a CUDA card", file=sys.stderr)
        return 1
    import horovod_tpu_torch as hvd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    hvd.init()
    dev = hvd.device()
    opt, forward = build(args.model, dev)

    def step(record=None):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        host = []
        ev[0].record()
        for i, name in enumerate(SECTIONS):
            t0 = time.perf_counter()
            with (record(name) if record else contextlib.nullcontext()):
                if name == "forward":
                    opt.zero_grad()
                    loss = forward()
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
            trace = json.load(f)
        busy = (device_busy(trace, is_conv) if args.model == "resnet50"
                else device_busy(trace))
        top = top_kernels(trace)
    finally:
        os.unlink(path)
    hvd.shutdown()

    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip().splitlines()
    print(f"{smi[0] if smi else 'nvidia-smi: no card'}; {args.model}; "
          f"root {args.root}")
    marked = "conv kernels" if args.model == "resnet50" else "flash kernels"
    for i, s in enumerate(SECTIONS):
        m, b = med[s], busy[s]
        idle = 1 - b["busy_ms"] / m["device_ms"] if m["device_ms"] else 0.0
        m.update(b, profiled_device_ms=prof_dev[i],
                 profiled_host_ms=prof_host[i], idle_share=idle)
        print(f"{s}: device {m['device_ms']:.1f} ms between events (each "
              f"step {', '.join(f'{x:.1f}' for x in m['device_ms_each'])}), "
              f"host {m['host_ms']:.1f} ms to queue it; profiled step: "
              f"device busy {b['busy_ms']:.1f} ms ({b['events']} events, "
              f"{marked} {b['marked_ms']:.2f} ms), idle share "
              f"{idle:.3f}")
    print("kernels with the most device time in the profiled step:")
    for name, ms, count in top:
        print(f"  {ms:8.2f} ms {count:5d}x  {name[:110]}")
    print(json.dumps({"root": args.root, "model": args.model,
                      "sections": med, "top_kernels": top}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
