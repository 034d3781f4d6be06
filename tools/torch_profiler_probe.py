#!/usr/bin/env python3
"""Whether a capture holds every kernel of the steps it spans, and
whether the process survives it, by the thread its session runs on.

This probe trains ``chip_smoke.py``'s GPT-2 medium (B 8, T 1024, bf16,
flash attention) on the card, runs a session of the training thread's own
over one step first (as ``hvd.profile`` does), then takes captures of
1.5 s while steps run. For each capture it counts the steps that ran
wholly inside the session's window and the flash kernels' events, by the
thread that launched them (each kernel's launch call carries the same
correlation id).

    python3 tools/torch_profiler_probe.py [--cases default,port]
                                          [--captures 8] [--processes 2]
                                          [--backtrace]

Cases, each in fresh processes:

* ``default``: sessions on a thread of their own, started by a
  watchdog-like thread, with torch.profiler's defaults;
* ``all_threads``: the same with ``profile_all_threads=True``;
* ``port``: ``hvd.profile`` over one step, then ``trigger_profile`` from a
  watchdog-like thread: the training thread's polls (its
  ``DistributedOptimizer.step``) start and stop the session;
* ``main``: sessions the training thread starts and stops itself.

Prints one JSON line per process first (the torch version, and whether
torch's own stop synchronizes the device before it disables the
profiler), one per capture (``complete``: every flash kernel at least 24
times each step inside the window; ``per_step_flash``: each step's flash
kernels, found by their launch calls' times, and ``short_steps``: the
places among the steps inside the window of those short of 24, so a
short capture says whether its first or last steps lost kernels, and
``lost``: for each short step, its launch calls that left no device
activity and whether they are a tail cut or a drop inside the stream; in
the
``main`` case ``stop_s`` / ``export_s``: how long the training thread's
own stop and export took), one per case (captures, complete ones, each
process's exit code: -11 is a segfault) and a failed process's stderr. Traces go to a temporary directory and are deleted once
counted. Needs a CUDA card and nvcc (the flash kernels are built at first
use).
"""

import argparse
import json
import os
import subprocess
import sys
import time

WORKER = r'''
import collections, glob, importlib, json, os, shutil, sys, tempfile
import threading, time
case, captures, repo = sys.argv[1], int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, repo)
os.chdir(repo)
os.environ["HOROVOD_PROFILE_MAX_CAPTURES"] = str(captures)
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke
import horovod_tpu_torch as hvd
from horovod_tpu_torch import profiler
from horovod_tpu_torch.models.gpt2 import loss_fn
fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
ACTS = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
import inspect
print(json.dumps(dict(case=case, torch=torch.__version__,
                      sync_in_exit="synchronize" in inspect.getsource(
                          torch.autograd.profiler.profile.__exit__))),
      flush=True)
tmp = tempfile.mkdtemp(prefix="torch_profiler_probe_")
hvd.init()
model, opt, _, info = chip_smoke.build_path("gpt2_medium", hvd.device())
tokens = info["inputs"]


def step():
    opt.zero_grad()
    loss = loss_fn(model(tokens), tokens)
    loss.backward()
    opt.step()
    return loss.item()


def side_session(path, done):
    kw = {}
    if case == "all_threads":
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    p = profile(activities=ACTS, **kw)
    p.start()
    time.sleep(1.5)
    p.stop()
    p.export_chrome_trace(path)
    done.set()


def count(path, steps):
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    w0 = doc["baseTimeNanoseconds"] + int(
        [e["ts"] for e in evs if e.get("cat") == "Trace"][0] * 1e3)
    w1 = doc["baseTimeNanoseconds"] + int(
        [e["ts"] for e in evs if e.get("name") == "Record Window End"][0]
        * 1e3)
    inside_idx = [i for i, (a, z) in enumerate(steps)
                  if a >= w0 and z <= w1]
    inside = len(inside_idx)
    launcher, launched_at, launch_name = {}, {}, {}
    launches = collections.Counter()
    for e in evs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launcher[c] = str(e.get("tid"))
                launched_at[c] = doc["baseTimeNanoseconds"] + e["ts"] * 1e3
                launch_name[c] = e.get("name", "")
                launches[str(e.get("tid"))] += 1
    # device activity of each launch call (kernel, copy or set)
    landed = {(e.get("args") or {}).get("correlation") for e in evs
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    kernels = collections.Counter()
    flash = collections.Counter()
    by_thread = collections.Counter()
    per_step = {i: collections.Counter() for i in inside_idx}
    for e in evs:
        if e.get("cat") != "kernel":
            continue
        corr = (e.get("args") or {}).get("correlation")
        tid = launcher.get(corr, "?")
        kernels[tid] += 1
        for k in fa.KERNELS:
            if k + "_" in e["name"]:
                flash[k] += 1
                by_thread[f"{k}@{tid}"] += 1
                t = launched_at.get(corr)
                for i in inside_idx:
                    if t is not None and steps[i][0] <= t <= steps[i][1]:
                        per_step[i][k] += 1
    flash = {k: flash[k] for k in fa.KERNELS}
    rows = [[per_step[i][k] for k in fa.KERNELS] for i in inside_idx]
    short = [pos for pos, row in enumerate(rows) if any(
        n < info["launches"][k] for n, k in zip(row, fa.KERNELS))]
    # For each short step: its kernel launch calls in launch order, which
    # of them left no device activity, and whether every launch after the
    # first such one left none too (a tail cut) or later ones landed (a
    # drop inside the stream); times in ms from the window's start.
    lost = []
    for pos in short:
        a, z = steps[inside_idx[pos]]
        calls = sorted((t, c) for c, t in launched_at.items()
                       if a <= t <= z and "aunch" in launch_name[c])
        gone = [j for j, (_, c) in enumerate(calls) if c not in landed]
        lost.append(dict(
            step=pos, launch_calls=len(calls), without_activity=len(gone),
            first_lost_ms=(calls[gone[0]][0] - w0) / 1e6 if gone else None,
            last_call_ms=(calls[-1][0] - w0) / 1e6 if calls else None,
            tail_cut=bool(gone) and gone == list(range(gone[0],
                                                       len(calls))),
            landed_after=sum(1 for _, c in calls[gone[0] + 1:]
                             if c in landed) if gone else 0))
    # where the kernels lie in the window (ms from its start): a hole
    # shows as the widest gap between two kernels' starts
    ts = sorted(e["ts"] * 1e3 + doc["baseTimeNanoseconds"] for e in evs
                if e.get("cat") == "kernel")
    gap = max(((b - a, a) for a, b in zip(ts, ts[1:])), default=(0, w0))
    span = dict(window_ms=(w1 - w0) / 1e6,
                first_ms=(ts[0] - w0) / 1e6 if ts else None,
                last_ms=(ts[-1] - w0) / 1e6 if ts else None,
                widest_gap_ms=gap[0] / 1e6, gap_at_ms=(gap[1] - w0) / 1e6)
    return dict(steps_inside=inside, flash=flash, kernel_span=span,
                per_step_flash=rows, short_steps=short, lost=lost,
                flash_by_thread=dict(by_thread),
                kernels_by_thread=dict(kernels),
                launch_calls_by_thread=dict(launches),
                complete=inside >= 1 and all(
                    flash[k] >= info["launches"][k] * inside
                    for k in fa.KERNELS),
                bytes=os.path.getsize(path))


for _ in range(3):
    step()
if case == "port":
    with hvd.profile(os.path.join(tmp, "manual")):
        step()
else:
    p = profile(activities=ACTS)
    p.start()
    step()
    p.stop()
for i in range(captures):
    done = threading.Event()
    path = os.path.join(tmp, f"{case}{i}.json")
    box = {}

    def fire():                       # the watchdog's thread
        time.sleep(0.3)
        if case == "port":
            box["dir"] = profiler.trigger_profile(
                f"probe{i}", seconds=1.5, logdir=os.path.join(tmp, str(i)))
        else:
            threading.Thread(target=side_session, args=(path, done)).start()

    steps, n, timed = [], 0, {}
    if case == "main":
        # the training thread's own session over 1.5 s of steps
        p = profile(activities=ACTS)
        p.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 1.5:
            a = time.time_ns()
            step()
            steps.append((a, time.time_ns()))
            n += 1
        t0 = time.perf_counter()
        p.stop()
        t1 = time.perf_counter()
        p.export_chrome_trace(path)
        timed = dict(stop_s=t1 - t0, export_s=time.perf_counter() - t1)
        done.set()
    else:
        threading.Thread(target=fire).start()
    while n < 3 or not (done.is_set() or (
            "dir" in box and not profiler._PROFILE_ACTIVE)):
        a = time.time_ns()
        step()
        steps.append((a, time.time_ns()))
        n += 1
    if case == "port":
        path = glob.glob(os.path.join(box["dir"], "trace.*.json"))[0]
    print(json.dumps(dict(case=case, capture=i, steps=n, **timed,
                          **count(path, steps))), flush=True)
    os.remove(path)
shutil.rmtree(tmp)
'''


# Prints the native backtrace of a thread that faults (``--backtrace``).
SEGV_HANDLER = r"""
#define _GNU_SOURCE
#include <execinfo.h>
#include <signal.h>
#include <stdio.h>
#include <string.h>
#include <sys/syscall.h>
#include <unistd.h>
static void handler(int sig, siginfo_t *si, void *ctx) {
  void *buf[96];
  char msg[160];
  int n = snprintf(msg, sizeof msg, "\n=== native SIGSEGV in tid %ld at %p ===\n",
                   (long)syscall(SYS_gettid), si->si_addr);
  if (write(2, msg, n) < 0) {}
  backtrace_symbols_fd(buf, backtrace(buf, 96), 2);
  signal(sig, SIG_DFL);
  raise(sig);
}
__attribute__((constructor)) static void install(void) {
  struct sigaction sa;
  memset(&sa, 0, sizeof sa);
  sa.sa_sigaction = handler;
  sa.sa_flags = SA_SIGINFO;
  sigaction(SIGSEGV, &sa, 0);
}
"""


def _backtrace_env() -> dict:
    """The environment with a SIGSEGV handler preloaded (built with cc)."""
    import tempfile
    d = tempfile.mkdtemp(prefix="torch_profiler_probe_segv_")
    src, lib = os.path.join(d, "segv.c"), os.path.join(d, "segv.so")
    with open(src, "w") as f:
        f.write(SEGV_HANDLER)
    subprocess.run(["cc", "-O1", "-shared", "-fPIC", "-o", lib, src],
                   check=True)
    return dict(os.environ, LD_PRELOAD=lib)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", default="default,port")
    ap.add_argument("--captures", type=int, default=8)
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--backtrace", action="store_true",
                    help="print the native backtrace of a faulting thread")
    args = ap.parse_args()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    os.chdir(repo)
    import chip_smoke
    chip_smoke.phase_build()
    env = _backtrace_env() if args.backtrace else None
    rc = 0
    for case in args.cases.split(","):
        caps, complete, exits = 0, 0, []
        for _ in range(args.processes):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-c", WORKER, case,
                                str(args.captures), repo],
                               capture_output=True, text=True, timeout=1200,
                               env=env)
            exits.append(r.returncode)
            for line in r.stdout.splitlines():
                if line.startswith("{"):
                    print(line, flush=True)
                    row = json.loads(line)
                    if "capture" in row:
                        caps += 1
                        complete += row["complete"]
            if r.returncode != 0:
                rc = 1
                print(f"{case}: exit {r.returncode} after "
                      f"{time.perf_counter() - t0:.1f} s\n"
                      f"{r.stderr[-12000:]}", file=sys.stderr, flush=True)
        print(json.dumps({"case": case, "captures": caps,
                          "complete": complete, "exit_codes": exits}),
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
