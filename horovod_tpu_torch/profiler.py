"""Always-on performance introspection: program registry, roofline gauges,
recompile detection, memory accounting, triggered profiling, and the
``hvd.doctor()`` automated diagnosis.

Port of ``horovod_tpu/profiler.py``. The third observability layer on top
of metrics (aggregates) and the timeline (host spans):

* **Program registry** (:class:`ProgramRegistry` / :func:`instrument`):
  every step we own registers its cost (FLOPs, peak device memory) once
  per signature, and every honest step timing fed to :func:`observe_step`
  updates live ``program_mfu`` / ``program_hfu`` gauges. **hfu** divides
  the FLOPs the call executed (remat's recompute and the flash backward's
  recompute of P included) by the card's peak; **mfu** divides the
  analytic, remat-invariant model FLOPs by the same peak. The cost comes
  from :class:`CostCapture`, which runs the real call once: the dense
  products through ``torch.utils.flop_counter.FlopCounterMode``, the flash
  kernels (loaded through ``ctypes``, invisible to a dispatch mode) through
  a tally their wrappers feed while a capture runs (4·d, 6·d and 8·d FLOPs
  a visible (q, k) pair for the forward, dQ and dK/dV kernels), and the
  peak from ``torch.cuda.max_memory_allocated``. PyTorch counts no bytes,
  so ``bytes_accessed`` stays 0 and no ``hbm_bandwidth_utilization`` gauge
  is written.
* **Recompile detector** (:meth:`ProgramRegistry.note_trace`): fingerprints
  (shapes / dtypes / static args) at every call, counts
  ``recompiles_total{program}``, and **blames the argument whose signature
  changed** (``recompile_blame_total{program,argument}``). In eager
  PyTorch a new signature compiles nothing; it still marks shape churn (a
  new set of allocations, a new cost capture), and the counters keep the
  reference's names.
* **Memory accounting**: :func:`live_buffer_census` (the caching
  allocator's active blocks on the card, a walk over live tensors on the
  CPU), per-program ``program_peak_hbm_bytes`` gauges, and
  :func:`check_memory_pressure` -- ``memory_pressure`` events land in the
  metrics registry and the active timeline when a card's memory use
  crosses the high-water fraction.
* **Triggered profiling**: :func:`profile` (a ``torch.profiler`` capture
  of the ``with`` block, written as a Chrome trace) and
  :func:`trigger_profile` -- a bounded capture fired by the StallWatchdog
  under ``HOROVOD_PROFILE_ON_STALL=1`` (at most
  ``HOROVOD_PROFILE_MAX_CAPTURES`` captures of ``HOROVOD_PROFILE_SECONDS``
  each). Its session runs on the training thread -- the thread that ran
  the last step, the main thread until one has -- started and stopped by
  :func:`poll`, which each instrumented step and each
  ``DistributedOptimizer.step`` call.
* **Doctor** (:func:`doctor` / ``tools/torch_perf_doctor.py``): fuses the
  metrics snapshot, the merged cross-rank trace (straggler + overlap
  reports), and the program registry into a **ranked findings report**,
  each finding with a concrete knob suggestion. Its checks are the
  reference's, over the same snapshot dicts.

The peaks are NVIDIA's data-sheet figures for dense bf16 and HBM (an H100
SXM: 989 TFLOP/s, 3,350 GB/s; an H200: 989 TFLOP/s, 4,800 GB/s), which
assume the card's full 700 W power limit; a card set below it runs
slower under load, so its mfu reads low against them.
"""

from __future__ import annotations

import atexit
import gc
import hashlib
import importlib
import json
import logging
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

logger = logging.getLogger("horovod_tpu_torch")

__all__ = [
    "ProgramRecord", "ProgramRegistry", "registry",
    "peak_tflops", "hbm_gbps", "utilization", "cost_from", "describe",
    "instrument", "ProfiledStep", "CostCapture",
    "note_trace", "observe_step", "record_cost", "count_trace",
    "live_buffer_census", "check_memory_pressure",
    "profile", "trigger_profile", "maybe_trigger", "poll",
    "profile_capture_count",
    "doctor", "doctor_window", "format_report",
    "PEAK_TFLOPS_BF16", "HBM_GBPS",
]

# ---------------------------------------------------------------------------
# device peaks (the denominators of every utilization gauge)
# ---------------------------------------------------------------------------

#: dense bf16 peak TFLOP/s by device-name substring (FMA = 2 FLOPs, the
#: convention of ``FlopCounterMode``), NVIDIA's data sheets at 700 W.
PEAK_TFLOPS_BF16: Dict[str, float] = {
    "H100 80GB HBM3": 989.0, "H200": 989.0,
}

#: HBM bandwidth GB/s by device-name substring, the same sources.
HBM_GBPS: Dict[str, float] = {
    "H100 80GB HBM3": 3350.0, "H200": 4800.0,
}


def _local_cuda_devices() -> List[int]:
    """The CUDA devices this process drives: ``init``'s, else the current
    one once CUDA is in use; none on the CPU. (Asking another card would
    make a context on it.)"""
    from horovod_tpu_torch import core
    if core.is_initialized():
        dev = core.device()
        return [dev.index or 0] if dev.type == "cuda" else []
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return [torch.cuda.current_device()]
    return []


def _device_kind() -> str:
    """The name of the card ``init`` chose ("" on the CPU); before
    ``init``, of the current card, if any."""
    from horovod_tpu_torch import core
    if core.is_initialized():
        dev = core.device()
        return torch.cuda.get_device_name(dev) if dev.type == "cuda" else ""
    return torch.cuda.get_device_name() if torch.cuda.is_available() else ""


def _lookup(table: Dict[str, float], kind: str) -> Optional[float]:
    for k in sorted(table, key=len, reverse=True):   # most specific first
        if k in kind:
            return table[k]
    return None


def peak_tflops(device_kind: Optional[str] = None) -> Optional[float]:
    """Peak dense bf16 TFLOP/s of the local card, or None when unknown
    (the CPU, another card). ``HOROVOD_PEAK_TFLOPS`` overrides -- which is
    also how CPU tests exercise the utilization gauges."""
    env = os.environ.get("HOROVOD_PEAK_TFLOPS")
    if env:
        return float(env)
    kind = device_kind if device_kind is not None else _device_kind()
    return _lookup(PEAK_TFLOPS_BF16, kind)


def hbm_gbps(device_kind: Optional[str] = None) -> Optional[float]:
    """HBM bandwidth GB/s of the local card, or None when unknown.
    ``HOROVOD_HBM_GBPS`` overrides."""
    env = os.environ.get("HOROVOD_HBM_GBPS")
    if env:
        return float(env)
    kind = device_kind if device_kind is not None else _device_kind()
    return _lookup(HBM_GBPS, kind)


def utilization(flops: float, dt: float, model_flops: Optional[float] = None,
                peak: Optional[float] = None) -> Dict[str, Optional[float]]:
    """The accounting split, in exactly one place.

    ``flops`` is the executed FLOPs of a cost capture (counts recompute)
    → **hfu**; ``model_flops`` is the analytic remat-invariant count →
    **mfu**. When ``model_flops`` is None the two coincide by
    construction. Returns achieved/model TFLOP/s plus hfu/mfu fractions
    (None when the peak is unknown)."""
    if model_flops is None:
        model_flops = flops
    achieved = flops / dt / 1e12 if dt > 0 else 0.0
    model = model_flops / dt / 1e12 if dt > 0 else 0.0
    peak = peak if peak is not None else peak_tflops()
    return {
        "achieved_tflops": achieved,
        "model_tflops": model,
        "hfu": (achieved / peak) if peak else None,
        "mfu": (model / peak) if peak else None,
    }


# ---------------------------------------------------------------------------
# program registry
# ---------------------------------------------------------------------------

@dataclass
class ProgramRecord:
    """Everything the subsystem knows about one program (a step we own)."""

    name: str
    kind: str = "step"
    #: executed FLOPs per call (a cost capture; counts recompute)
    flops: float = 0.0
    #: device bytes accessed per call: PyTorch counts none, so 0
    bytes_accessed: float = 0.0
    #: peak device memory of the captured call
    peak_hbm_bytes: float = 0.0
    #: analytic remat-invariant model FLOPs (None => mfu uses ``flops``)
    model_flops: Optional[float] = None
    #: doctor threshold: mfu below 0.8x this is a finding
    expected_mfu: Optional[float] = None
    #: fingerprinted signatures: first sighting + every signature change
    compiles: int = 0
    recompiles: int = 0
    #: raw count of :meth:`ProgramRegistry.count_trace` calls
    traces: int = 0
    #: arguments blamed for the last recompile, with old -> new signatures
    last_blame: List[str] = field(default_factory=list)
    blame_detail: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    #: tuning-driven rebuilds (AutotunedStep) change signature BY DESIGN;
    #: the doctor skips expected churn instead of flagging it
    expected_recompiles: bool = False
    #: tensor-parallel degree: a cost counted over the whole program is
    #: divided by it to stay per card (what mfu compares against one
    #: card's peak)
    mp_degree: int = 1
    signature: Optional[Dict[str, str]] = None
    #: every signature ever seen: a REVISIT of a seen signature reads as
    #: steady, not as a recompile (alternating train/eval batch shapes)
    seen_signatures: set = field(default_factory=set)
    last_step_seconds: Optional[float] = None
    steps: int = 0
    meta: Dict[str, Any] = field(default_factory=dict)

    def snapshot(self) -> Dict[str, Any]:
        out = {
            "name": self.name, "kind": self.kind, "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "peak_hbm_bytes": self.peak_hbm_bytes,
            "model_flops": self.model_flops,
            "expected_mfu": self.expected_mfu,
            "compiles": self.compiles, "recompiles": self.recompiles,
            "traces": self.traces,
            "last_blame": list(self.last_blame),
            "blame_detail": {k: list(v) for k, v in
                             self.blame_detail.items()},
            "expected_recompiles": self.expected_recompiles,
            "mp_degree": self.mp_degree,
            "signatures_seen": len(self.seen_signatures),
            "last_step_seconds": self.last_step_seconds,
            "steps": self.steps, "meta": dict(self.meta),
        }
        if self.last_step_seconds:
            out["utilization"] = utilization(
                self.flops, self.last_step_seconds, self.model_flops)
        return out


def _module_digest(m: torch.nn.Module) -> str:
    descs = [f"{n}:{describe(p)}" for n, p in m.named_parameters()]
    digest = hashlib.sha1("|".join(descs).encode()).hexdigest()[:10]
    return f"module[{len(descs)} params]:{digest}"


def describe(v: Any) -> str:
    """Stable signature descriptor of one argument: ``dtype[shape]`` for
    tensors and arrays (``float32[8, 3]``), ``py<type>[]`` for python
    scalars (their VALUE is not the signature), a digest of the parameters'
    names, dtypes and shapes for an ``nn.Module`` (the counterpart of a
    params pytree), a bounded leaf digest for pytrees
    (``torch.utils._pytree``), and ``repr`` for anything else."""
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        try:
            return f"{str(v.dtype).replace('torch.', '')}{list(v.shape)}"
        except Exception:
            pass
    if isinstance(v, (bool, int, float, complex)):
        return f"py{type(v).__name__}[]"
    if isinstance(v, (str, bytes)) or v is None:
        return repr(v)[:80]
    if isinstance(v, torch.nn.Module):
        return _module_digest(v)
    from torch.utils import _pytree
    leaves, spec = _pytree.tree_flatten(v)
    if len(leaves) == 1 and leaves[0] is v:
        return repr(v)[:80]                 # not a container: a leaf
    if not leaves:
        return f"tree0:{str(spec)[:60]}"
    descs = [describe(x) for x in leaves]
    if len(descs) <= 4:
        return "(" + ",".join(descs) + ")"
    digest = hashlib.sha1(
        ("|".join(descs) + str(spec)).encode()).hexdigest()[:10]
    return f"tree[{len(descs)} leaves]:{digest}"


class ProgramRegistry:
    """Thread-safe name-keyed store of :class:`ProgramRecord` -- the
    process-global instance is :data:`registry`."""

    def __init__(self):
        self._lock = threading.RLock()
        self._programs: Dict[str, ProgramRecord] = {}
        self._steps_total = 0
        #: (program, key) of every :meth:`count_trace_once` in this init
        #: epoch
        self._traced: set = set()

    def program(self, name: str, kind: str = "step") -> ProgramRecord:
        with self._lock:
            rec = self._programs.get(name)
            if rec is None:
                rec = self._programs[name] = ProgramRecord(name=name,
                                                           kind=kind)
            return rec

    def get(self, name: str) -> Optional[ProgramRecord]:
        with self._lock:
            return self._programs.get(name)

    def reset(self) -> None:
        with self._lock:
            self._programs.clear()
            self._steps_total = 0
            self._traced.clear()

    def reanchor(self) -> None:
        """Forget every program's fingerprint, keeping its history
        (compile/recompile counters, cost, timings).

        Called by ``init()`` on a re-init (an elastic reset, a re-mesh):
        every step's first call runs again by design, and a hot spare
        adopting a dead rank's state starts from scratch; neither is churn
        the doctor should blame. The next ``note_trace`` of each program
        reads as a fresh ``compile``, so ``recompiles_total`` /
        ``recompile_blame_total`` only ever count drift *within* an init
        epoch."""
        with self._lock:
            for rec in self._programs.values():
                rec.signature = None
                rec.seen_signatures.clear()
            self._traced.clear()

    # -- fingerprinting -------------------------------------------------

    def note_trace(self, name: str, signature: Dict[str, str], *,
                   kind: str = "step",
                   expected: bool = False) -> Tuple[str, List[str]]:
        """Fingerprint one call. Returns ``(status, blamed)`` where status
        is ``"compile"`` (first sighting), ``"recompile"`` (a NEVER-seen
        signature -- ``blamed`` names the arguments that changed vs the
        previous call), or ``"steady"`` (same as last call, or a revisit
        of a signature seen before).

        A recompile bumps ``recompiles_total{program}`` and
        ``recompile_blame_total{program,argument}``, stores old → new
        signatures on the record, warns, and drops a ``recompile`` marker
        into the active timeline. ``expected=True`` tags churn that is by
        design (autotuner rebuilds) so the doctor doesn't flag it."""
        from horovod_tpu_torch import metrics as _metrics
        sig_key = tuple(sorted(signature.items()))
        with self._lock:
            rec = self.program(name, kind)
            if expected:
                rec.expected_recompiles = True
            if rec.signature is None:
                rec.signature = dict(signature)
                rec.seen_signatures.add(sig_key)
                rec.compiles += 1
                _metrics.counter("program_compiles_total",
                                 program=name).inc()
                return "compile", []
            if signature == rec.signature:
                return "steady", []
            if sig_key in rec.seen_signatures:
                rec.signature = dict(signature)
                return "steady", []
            rec.seen_signatures.add(sig_key)
            old = rec.signature
            blamed = sorted(k for k in set(old) | set(signature)
                            if old.get(k) != signature.get(k))
            rec.blame_detail = {
                k: (old.get(k, "<absent>"), signature.get(k, "<absent>"))
                for k in blamed}
            rec.last_blame = blamed
            rec.signature = dict(signature)
            rec.recompiles += 1
            rec.compiles += 1
        _metrics.counter("program_compiles_total", program=name).inc()
        _metrics.counter("recompiles_total", program=name).inc()
        if rec.expected_recompiles:
            # The by-design tag rides the exported snapshot too, so an
            # offline doctor (no live registry) skips healthy tuner churn.
            _metrics.counter("expected_recompiles_total", program=name).inc()
        for k in blamed:
            _metrics.counter("recompile_blame_total", program=name,
                             argument=k).inc()
        detail = "; ".join(
            f"{k}: {rec.blame_detail[k][0]} -> {rec.blame_detail[k][1]}"
            for k in blamed)
        if not expected:
            logger.warning(
                "horovod_tpu_torch: program %r recompiled (#%d) — changed "
                "argument(s): %s", name, rec.recompiles, detail)
        _timeline_marker("recompile", program=name, arguments=blamed,
                         detail=detail)
        return "recompile", blamed

    def count_trace(self, name: str, **meta) -> None:
        """Raw counter of a program's new signatures as its own call site
        sees them (an eager collective's first dispatch of a shape, a
        lowering's first issue of a bucket geometry), with what the site
        knows of it in ``meta``."""
        with self._lock:
            rec = self.program(name)
            rec.traces += 1
            if meta:
                rec.meta.update(meta)

    def count_trace_once(self, name: str, key, **meta) -> bool:
        """:meth:`count_trace` at the first ``key`` of program ``name`` in
        this init epoch (an eager collective's (shapes, dtypes, process
        set), a lowering's bucket geometry: the reference's compile-cache
        misses); a repeat adds nothing. :meth:`reanchor` starts the next
        epoch. Returns whether it counted."""
        with self._lock:
            if (name, key) in self._traced:
                return False
            self._traced.add((name, key))
            self.count_trace(name, **meta)
            return True

    # -- cost + timing ---------------------------------------------------

    def record_cost(self, name: str, cost, *,
                    model_flops: Optional[float] = None,
                    expected_mfu: Optional[float] = None,
                    kind: str = "step",
                    mp_degree: int = 1) -> ProgramRecord:
        """Attach a call's cost (a :class:`CostCapture` or a dict with
        ``flops`` / ``bytes_accessed`` / ``peak_hbm_bytes``, see
        :func:`cost_from`) to the record and publish the static gauges
        (``program_flops``, ``program_bytes_accessed``,
        ``program_peak_hbm_bytes``).

        ``mp_degree`` is the tensor-parallel degree of a cost counted over
        the whole program: each card executes 1/mp of it per step, so
        recorded flops/bytes (and ``model_flops``) are divided down so
        ``program_mfu`` / ``program_hfu`` stay honest against ONE card's
        peak."""
        from horovod_tpu_torch import metrics as _metrics
        cost = cost_from(cost)
        deg = max(1, int(mp_degree))
        with self._lock:
            rec = self.program(name, kind)
            rec.mp_degree = deg
            rec.flops = cost["flops"] / deg
            rec.bytes_accessed = cost["bytes_accessed"] / deg
            rec.peak_hbm_bytes = cost["peak_hbm_bytes"] / deg
            if model_flops is not None:
                rec.model_flops = float(model_flops) / deg
            if expected_mfu is not None:
                rec.expected_mfu = float(expected_mfu)
                # Exported so an OFFLINE doctor (fresh process, empty
                # registry) can still compare program_mfu to expectation.
                _metrics.gauge("program_expected_mfu", program=name).set(
                    rec.expected_mfu)
        _metrics.gauge("program_flops", program=name).set(rec.flops)
        _metrics.gauge("program_bytes_accessed", program=name).set(
            rec.bytes_accessed)
        _metrics.gauge("program_peak_hbm_bytes", program=name).set(
            rec.peak_hbm_bytes)
        return rec

    def observe_step(self, name: str, seconds: float) -> None:
        """Feed one honest (synced) step time; updates the live roofline
        gauges ``program_mfu`` / ``program_hfu`` (and
        ``hbm_bandwidth_utilization`` where a cost has bytes) for the
        program. Call sites that already pay a blocking sync
        (AutotunedStep tuning steps, ``timed`` instrumented steps, bench
        loops) feed this for free -- the profiler never forces its own
        sync into a hot path."""
        from horovod_tpu_torch import metrics as _metrics
        seconds = float(seconds)
        with self._lock:
            rec = self.program(name)
            rec.last_step_seconds = seconds
            rec.steps += 1
            self._steps_total += 1
            n = self._steps_total
            flops, model_flops = rec.flops, rec.model_flops
            nbytes = rec.bytes_accessed
        _metrics.histogram("program_step_seconds", program=name).observe(
            seconds)
        if seconds <= 0:
            return
        peak = peak_tflops()
        if peak and flops:
            u = utilization(flops, seconds, model_flops, peak=peak)
            _metrics.gauge("program_hfu", program=name).set(u["hfu"])
            _metrics.gauge("program_mfu", program=name).set(u["mfu"])
        bw = hbm_gbps()
        if bw and nbytes:
            _metrics.gauge("hbm_bandwidth_utilization", program=name).set(
                nbytes / seconds / 1e9 / bw)
        if n % 32 == 0:
            check_memory_pressure()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {name: rec.snapshot()
                    for name, rec in sorted(self._programs.items())}


#: the process-global program registry
registry = ProgramRegistry()


def note_trace(name: str, signature: Dict[str, str], **kw):
    return registry.note_trace(name, signature, **kw)


def observe_step(name: str, seconds: float) -> None:
    registry.observe_step(name, seconds)


def record_cost(name: str, cost, **kw) -> ProgramRecord:
    return registry.record_cost(name, cost, **kw)


def count_trace(name: str, **meta) -> None:
    registry.count_trace(name, **meta)


def count_trace_once(name: str, key, **meta) -> bool:
    return registry.count_trace_once(name, key, **meta)


# ---------------------------------------------------------------------------
# cost capture: one real call, counted
# ---------------------------------------------------------------------------

_CAPTURES_LOCK = threading.Lock()
_CAPTURES: List["CostCapture"] = []


def _flash_module():
    # ``horovod_tpu_torch.ops.flash_attention`` the module: the package
    # attribute of that name is the function.
    return importlib.import_module("horovod_tpu_torch.ops.flash_attention")


def _feed_captures(kernel: str, flops: int) -> None:
    with _CAPTURES_LOCK:
        for cap in _CAPTURES:
            cap.kernel_flops[kernel] = cap.kernel_flops.get(kernel, 0) + flops


class CostCapture:
    """The cost of one real call (``with CostCapture() as cap: out =
    step(...)``), never a second execution.

    * Dense products: ``FlopCounterMode`` (a dispatch mode; autograd
      carries it to the thread that runs a CUDA backward).
    * The flash kernels: their wrappers feed :attr:`kernel_flops` at each
      launch while any capture is open (``flash_attention.flop_tally``,
      process-global, so the backward's launches on autograd's device
      thread count), 4·d / 6·d / 8·d FLOPs a visible (q, k) pair.
    * Peak memory: the card's ``max_memory_allocated`` read before and
      after, never reset, so a caller's own window over the peak stays
      honest. :attr:`peak_exact` says whether the call raised the card's
      peak (then :attr:`peak` is the call's own); when it did not, the
      call stayed under an earlier peak and :attr:`peak` is that peak, an
      upper bound. 0 on the CPU.

    The call runs every aten op through Python, so it is much slower than
    a plain one: never time it.
    """

    def __init__(self):
        devs = _local_cuda_devices()
        self.device = torch.device("cuda", devs[0]) if devs else None
        self.dense_flops = 0
        self.kernel_flops: Dict[str, int] = {}
        self.peak = 0
        self.peak_exact = False
        self._mode = None

    def __enter__(self) -> "CostCapture":
        from torch.utils.flop_counter import FlopCounterMode
        if self.device is not None:
            self._p0 = torch.cuda.max_memory_allocated(self.device)
        fa = _flash_module()
        with _CAPTURES_LOCK:
            _CAPTURES.append(self)
            fa.flop_tally = _feed_captures
        self._mode = FlopCounterMode(display=False)
        try:
            self._mode.__enter__()
        except BaseException:
            self._detach(fa)
            raise
        return self

    def _detach(self, fa) -> None:
        with _CAPTURES_LOCK:
            _CAPTURES.remove(self)
            if not _CAPTURES:
                fa.flop_tally = None

    def __exit__(self, *exc) -> bool:
        try:
            self._mode.__exit__(*exc)
        finally:
            self._detach(_flash_module())
        self.dense_flops = int(self._mode.get_total_flops())
        if self.device is not None:
            torch.cuda.synchronize(self.device)
            self.peak = torch.cuda.max_memory_allocated(self.device)
            self.peak_exact = self.peak > self._p0
        return False

    @property
    def flops(self) -> int:
        return self.dense_flops + sum(self.kernel_flops.values())

    def cost(self) -> Dict[str, float]:
        return {"flops": float(self.flops), "bytes_accessed": 0.0,
                "peak_hbm_bytes": float(self.peak)}


def cost_from(cost) -> Dict[str, float]:
    """``{"flops", "bytes_accessed", "peak_hbm_bytes"}`` of a
    :class:`CostCapture` or of a dict holding any of those keys (missing
    ones read 0) -- the port's counterpart of the reference's reading of
    XLA's cost and memory analyses."""
    if isinstance(cost, CostCapture):
        cost = cost.cost()
    cost = cost or {}
    return {"flops": float(cost.get("flops", 0.0) or 0.0),
            "bytes_accessed": float(cost.get("bytes_accessed", 0.0) or 0.0),
            "peak_hbm_bytes": max(0.0, float(
                cost.get("peak_hbm_bytes", 0.0) or 0.0))}


def _cost_capture_enabled(default: bool = True) -> bool:
    """Cost capture runs one call per new signature under the capture.
    ``HOROVOD_PROFILER_COST`` forces it on (``1``) or off (``0``) for every
    call site; unset falls back to ``default`` -- True for instrumented
    steps. Same truthy set as ``config._env_bool``; the resolved tri-state
    is ``build_info()['profiler_cost']``. Read live (not from the cached
    Config) so the knob works before ``hvd.init`` and under test
    monkeypatching."""
    v = os.environ.get("HOROVOD_PROFILER_COST", "").strip().lower()
    if not v:
        return default
    return v in ("1", "true", "yes", "on")


# ---------------------------------------------------------------------------
# instrument(): a step with fingerprinting + cost capture built in
# ---------------------------------------------------------------------------

def _wait_for(out) -> None:
    """Wait for the card when any tensor of ``out`` lives on it."""
    from torch.utils import _pytree
    for x in _pytree.tree_leaves(out):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
            return


class ProfiledStep:
    """An eager step plus the registry contract: every call is
    fingerprinted (new signatures counted and blamed by argument name,
    from the function's signature), and each new signature's call runs
    under a :class:`CostCapture` whose cost lands in the registry.

    ``timed=True`` additionally waits for the output's card and feeds
    :func:`observe_step` -- but not on a capture call, which is slow by
    construction. ``static_argnums`` are described by ``repr`` (their
    value is the signature); ``donate_argnums`` is accepted and means
    nothing in eager PyTorch."""

    def __init__(self, fn: Callable, name: str, *,
                 model_flops: Optional[Any] = None,
                 expected_mfu: Optional[float] = None,
                 static_argnums: Tuple[int, ...] = (),
                 donate_argnums: Tuple[int, ...] = (),
                 capture_cost: Optional[bool] = None,
                 timed: bool = False, kind: str = "step"):
        import inspect
        self.fn = fn
        self.name = name
        self.kind = kind
        self.model_flops = model_flops
        self.expected_mfu = expected_mfu
        self.timed = timed
        self._static = tuple(static_argnums)
        self._capture = (_cost_capture_enabled() if capture_cost is None
                         else capture_cost)
        try:
            self._argnames = [p.name for p in
                              inspect.signature(fn).parameters.values()]
        except (TypeError, ValueError):
            self._argnames = []
        #: the :class:`CostCapture` of the last new signature, or None
        self.last_capture: Optional[CostCapture] = None
        registry.program(name, kind)

    def _signature(self, args, kwargs) -> Dict[str, str]:
        sig: Dict[str, str] = {}
        for i, a in enumerate(args):
            label = (self._argnames[i] if i < len(self._argnames)
                     else f"arg{i}")
            sig[label] = (repr(a)[:80] if i in self._static
                          else describe(a))
        for k, v in kwargs.items():
            sig[k] = describe(v)
        return sig

    def __call__(self, *args, **kwargs):
        poll(step=True)
        sig = self._signature(args, kwargs)
        status, _ = registry.note_trace(self.name, sig, kind=self.kind)
        if status != "steady" and self._capture:
            with CostCapture() as cap:
                out = self.fn(*args, **kwargs)
            mf = (self.model_flops(*args, **kwargs)
                  if callable(self.model_flops) else self.model_flops)
            registry.record_cost(self.name, cap, model_flops=mf,
                                 expected_mfu=self.expected_mfu,
                                 kind=self.kind)
            self.last_capture = cap
            return out
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        if self.timed:
            _wait_for(out)
            registry.observe_step(self.name, time.perf_counter() - t0)
        return out

    def record(self) -> ProgramRecord:
        return registry.program(self.name)


def instrument(fn: Optional[Callable] = None, *, name: Optional[str] = None,
               **kw) -> Any:
    """Wrap ``fn`` as a :class:`ProfiledStep` (usable as a decorator)::

        step = hvd.profiler.instrument(train_step, name="train",
                                       model_flops=analytic_flops,
                                       timed=True)
    """
    def wrap(f):
        return ProfiledStep(f, name or getattr(f, "__name__", "program"),
                            **kw)
    return wrap if fn is None else wrap(fn)


# ---------------------------------------------------------------------------
# memory accounting
# ---------------------------------------------------------------------------

def _platform(dev: torch.device) -> str:
    return "gpu" if dev.type == "cuda" else dev.type


def live_buffer_census() -> Dict[str, Dict[str, float]]:
    """Census of live device buffers by platform (``"gpu"``, ``"cpu"``):
    count and bytes. On the card, the caching allocator's active blocks
    (``memory_stats``: ``active.all.current`` / ``active_bytes``); on the
    CPU, a walk over live tensors (``gc``), each storage counted once
    however many tensors view it. Publishes
    ``device_live_buffer_bytes{platform}`` /
    ``device_live_buffer_count{platform}`` gauges and returns the dict."""
    from horovod_tpu_torch import metrics as _metrics
    out: Dict[str, Dict[str, float]] = {}
    for i in _local_cuda_devices():
        st = torch.cuda.memory_stats(i)
        d = out.setdefault("gpu", {"count": 0, "bytes": 0.0})
        d["count"] += int(st.get("active.all.current", 0))
        d["bytes"] += float(st.get("active_bytes.all.current", 0))
    seen = set()
    for obj in gc.get_objects():
        if not issubclass(type(obj), torch.Tensor) or \
                obj.device.type != "cpu":
            continue
        try:
            st = obj.untyped_storage()
            key = st.data_ptr()
            nbytes = st.nbytes()
        except (RuntimeError, NotImplementedError):
            continue                    # sparse and other storage-less kinds
        if key in seen or not nbytes:
            continue
        seen.add(key)
        d = out.setdefault("cpu", {"count": 0, "bytes": 0.0})
        d["count"] += 1
        d["bytes"] += float(nbytes)
    for plat, d in out.items():
        _metrics.gauge("device_live_buffer_bytes", platform=plat).set(
            d["bytes"])
        _metrics.gauge("device_live_buffer_count", platform=plat).set(
            d["count"])
    return out


#: device memory use above this fraction of the card's emits memory_pressure
MEMORY_PRESSURE_FRACTION = 0.92

_PRESSURE_LOCK = threading.Lock()
_PRESSURE_FIRED: set = set()


def check_memory_pressure(threshold: float = MEMORY_PRESSURE_FRACTION
                          ) -> Optional[float]:
    """Read each local card's memory (``torch.cuda.mem_get_info``: in use =
    total - free, limit = total; the CPU reports none, so None), publish
    ``device_hbm_bytes_in_use{device}`` / ``device_hbm_bytes_limit{device}``
    gauges, and emit ONE ``memory_pressure`` event (counter + timeline
    marker) per card the first time its use crosses ``threshold``. Returns
    the worst in-use fraction seen, or None when no card reports."""
    from horovod_tpu_torch import metrics as _metrics
    worst: Optional[float] = None
    for i in _local_cuda_devices():
        free, total = torch.cuda.mem_get_info(i)
        in_use, limit = float(total - free), float(total)
        _metrics.gauge("device_hbm_bytes_in_use", device=str(i)).set(in_use)
        if limit <= 0:
            continue
        _metrics.gauge("device_hbm_bytes_limit", device=str(i)).set(limit)
        frac = in_use / limit
        worst = frac if worst is None else max(worst, frac)
        if frac >= threshold:
            with _PRESSURE_LOCK:
                fresh = i not in _PRESSURE_FIRED
                _PRESSURE_FIRED.add(i)
            if fresh:
                _metrics.event("memory_pressure", device=i,
                               bytes_in_use=int(in_use),
                               bytes_limit=int(limit),
                               fraction=round(frac, 4))
    return worst


def _timeline_marker(name: str, **args) -> None:
    try:
        from horovod_tpu_torch import timeline as _tl
        t = _tl.get_timeline()
        if t is not None:
            t.marker(name, category="profiler", **args)
    except Exception:
        pass


# ---------------------------------------------------------------------------
# triggered profiling
# ---------------------------------------------------------------------------

_PROFILE_LOCK = threading.Lock()
_PROFILE_ACTIVE = False
#: "manual" (hvd.profile) or "trigger" (watchdog) while active
_PROFILE_SOURCE: Optional[str] = None
#: generation token: bumped per capture so a preempted trigger cannot
#: unflag a newer capture
_PROFILE_GEN = 0
_PROFILE_CAPTURES = 0
#: the triggered capture, pending or running, while one is active
_TRIGGER: Optional["_Triggered"] = None
#: the open manual capture: (session, generation)
_MANUAL: Optional[Tuple["_Session", int]] = None


def profile_capture_count() -> int:
    """How many triggered captures fired this process."""
    with _PROFILE_LOCK:
        return _PROFILE_CAPTURES


def _profile_dir(reason: str) -> str:
    from horovod_tpu_torch.config import get_config
    base = get_config().profile_dir
    safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in reason)
    return os.path.join(base, f"{safe}.{os.getpid()}.{int(time.time())}")


class _Session:
    """One ``torch.profiler`` session (CPU activity, and CUDA activity
    wherever a card is present), written on stop as a Chrome trace
    ``trace.<pid>.json`` in ``logdir``. Kineto keeps a session's state in
    the thread that started it, so one thread starts and stops it."""

    def __init__(self, logdir: str):
        from torch.profiler import ProfilerActivity
        self.logdir = logdir
        self.path = os.path.join(logdir, f"trace.{os.getpid()}.json")
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        os.makedirs(self.logdir, exist_ok=True)
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()
        self._prof.export_chrome_trace(self.path)


@dataclass
class _Triggered:
    """A triggered capture: pending until the training thread's next
    :func:`poll` starts its session, then running until a poll of the
    thread that started it, after its deadline (or a manual capture),
    stops it."""
    reason: str
    seconds: float
    logdir: str
    gen: int
    session: Optional[_Session] = None
    deadline: float = 0.0
    #: the thread that started the session: only it can stop it
    thread: Optional[threading.Thread] = None


#: the thread that ran the last step (``poll(step=True)``)
_TRAINING_THREAD: Optional[threading.Thread] = None


def _on_training_thread() -> bool:
    """Whether this thread trains: the one that ran the last step while
    it lives, else the main thread (a loop that polls without steps)."""
    t = _TRAINING_THREAD
    if t is None or not t.is_alive():
        t = threading.main_thread()
    return threading.current_thread() is t


def _owns_session(trig: "_Triggered") -> bool:
    return threading.current_thread() is trig.thread


def _start_trigger(trig: _Triggered) -> bool:
    """Start ``trig``'s session on this (the training) thread. A start that
    fails releases the flag and is not charged against the budget."""
    global _PROFILE_ACTIVE, _PROFILE_SOURCE, _PROFILE_CAPTURES, _TRIGGER
    from horovod_tpu_torch import metrics as _metrics
    session = _Session(trig.logdir)
    try:
        session.start()
    except Exception as e:
        with _PROFILE_LOCK:
            if _PROFILE_GEN == trig.gen:
                _PROFILE_ACTIVE = False
                _PROFILE_SOURCE = None
                _TRIGGER = None
            # a capture that never started must not burn budget -- a
            # transiently unwritable dir would otherwise disable
            # triggered profiling for the rest of the process
            _PROFILE_CAPTURES -= 1
        logger.error("triggered profile failed to start (%s): %r",
                     trig.reason, e)
        return False
    trig.session, trig.deadline = session, time.monotonic() + trig.seconds
    trig.thread = threading.current_thread()
    _metrics.event("profile_capture", reason=trig.reason, logdir=trig.logdir,
                   seconds=trig.seconds)
    logger.warning("horovod_tpu_torch: triggered profile capture (%s) -> %s "
                   "(%.1fs)", trig.reason, trig.logdir, trig.seconds)
    return True


def _stop_trigger(trig: _Triggered) -> None:
    """Stop ``trig``'s running session on this thread and write its
    trace."""
    global _PROFILE_ACTIVE, _PROFILE_SOURCE, _TRIGGER
    try:
        trig.session.stop()
    except Exception:
        logger.exception("triggered profile failed to stop (%s)",
                         trig.reason)
    with _PROFILE_LOCK:
        if _PROFILE_GEN == trig.gen:
            _PROFILE_ACTIVE = False
            _PROFILE_SOURCE = None
            _TRIGGER = None
    _timeline_marker("profile_stop", logdir=trig.logdir)


def poll(step: bool = False) -> None:
    """Start a pending triggered capture when called on the training
    thread, or stop a running one whose seconds are up when called on the
    thread that started it; elsewhere, and with no triggered capture
    active, it does nothing (a read or two).

    ``step=True`` says the caller runs a training step, which makes this
    thread the training thread: each instrumented step
    (:class:`ProfiledStep`) and each ``DistributedOptimizer.step`` poll so,
    on whatever thread trains (Ray actors and Lightning train off the main
    thread). Until a step has run, and once the thread that ran the last
    one has ended, the main thread is the training thread; a training
    loop of its own calls ``poll(step=True)`` once a step. A triggered
    capture's session lives on the training thread because on the H100 a
    session run on a thread of its own crashed the process inside CUPTI's
    own thread in about one capture of twelve, and at times recorded none
    of the kernels the training thread launched
    (tools/torch_profiler_probe.py); the training thread's own sessions
    did neither. So a stall's capture starts at the training thread's
    next step, and a thread that never gets there captures nothing."""
    global _TRAINING_THREAD
    if step:
        _TRAINING_THREAD = threading.current_thread()
    trig = _TRIGGER
    if trig is None:
        return
    if trig.session is None:
        if _on_training_thread():
            _start_trigger(trig)
    elif _owns_session(trig) and time.monotonic() >= trig.deadline:
        _stop_trigger(trig)


def _stop_trigger_at_exit() -> None:
    trig = _TRIGGER
    if trig is not None and trig.session is not None and \
            _owns_session(trig):
        _stop_trigger(trig)


atexit.register(_stop_trigger_at_exit)


def _begin_manual(logdir: Optional[str] = None) -> str:
    """Open the manual capture (``profile`` / ``timeline.start_profiler``);
    returns its directory."""
    global _PROFILE_ACTIVE, _PROFILE_SOURCE, _PROFILE_GEN, _TRIGGER, _MANUAL
    logdir = logdir or _profile_dir("manual")
    with _PROFILE_LOCK:
        if _PROFILE_ACTIVE and _PROFILE_SOURCE == "manual":
            raise RuntimeError("a profile capture is already active")
        trig = _TRIGGER if _PROFILE_ACTIVE else None
        if trig is not None and trig.session is not None and \
                not _owns_session(trig):
            raise RuntimeError("a triggered capture runs on the training "
                               "thread; only that thread can stop it")
        _TRIGGER = None
        _PROFILE_ACTIVE = True
        _PROFILE_SOURCE = "manual"
        _PROFILE_GEN += 1           # a pending trigger never starts
        gen = _PROFILE_GEN
    if trig is not None and trig.session is not None:
        logger.warning("horovod_tpu_torch: hvd.profile() preempted an "
                       "active triggered capture")
        try:                        # one session a process: it stops first
            trig.session.stop()
        except Exception:
            logger.exception("preempted profile failed to stop (%s)",
                             trig.reason)
        _timeline_marker("profile_stop", logdir=trig.logdir)
    session = _Session(logdir)
    try:
        _timeline_marker("profile_start", logdir=logdir)
        session.start()
    except BaseException:
        # A failed start (unwritable dir, another profiler session) must
        # not wedge the flag -- that would disable every future capture.
        with _PROFILE_LOCK:
            if _PROFILE_GEN == gen:
                _PROFILE_ACTIVE = False
                _PROFILE_SOURCE = None
        raise
    with _PROFILE_LOCK:
        _MANUAL = (session, gen)
    return logdir


def _end_manual() -> str:
    """Close the manual capture and write its trace; returns its
    directory."""
    global _PROFILE_ACTIVE, _PROFILE_SOURCE, _MANUAL
    with _PROFILE_LOCK:
        manual, _MANUAL = _MANUAL, None
    if manual is None:
        raise RuntimeError("no manual profile capture is active")
    session, gen = manual
    try:
        session.stop()
    finally:
        with _PROFILE_LOCK:
            if _PROFILE_GEN == gen:
                _PROFILE_ACTIVE = False
                _PROFILE_SOURCE = None
        _timeline_marker("profile_stop", logdir=session.logdir)
    return session.logdir


@contextmanager
def profile(logdir: Optional[str] = None):
    """``hvd.profile()``: capture a ``torch.profiler`` trace (host ops and,
    on a card, its kernels) of the body of the ``with`` block into
    ``logdir`` (default: a fresh subdirectory of ``HOROVOD_PROFILE_DIR``)
    as the Chrome trace ``trace.<pid>.json``. Yields the capture
    directory; timeline markers bracket the window so host and device
    traces correlate. Nesting manual captures raises; a BACKGROUND
    triggered capture that happens to be running is preempted (stopped
    early, its trace written) instead -- an asynchronous observability
    event must never crash the training script's own profile window."""
    logdir = _begin_manual(logdir)
    try:
        yield logdir
    finally:
        _end_manual()


def trigger_profile(reason: str, seconds: Optional[float] = None,
                    logdir: Optional[str] = None) -> Optional[str]:
    """Fire one bounded capture (the automatic path behind
    ``HOROVOD_PROFILE_ON_STALL=1``) of ``seconds`` (default
    ``HOROVOD_PROFILE_SECONDS``). At most ``HOROVOD_PROFILE_MAX_CAPTURES``
    captures per process, never two at once -- a stall storm must not turn
    into a disk-filling profile storm; a start that fails is not charged.
    Called on the training thread it starts the session now; from another
    thread (the watchdog's) it leaves it to the training thread's next
    :func:`poll`. Returns the capture directory, or None when
    refused."""
    from horovod_tpu_torch.config import get_config
    global _PROFILE_ACTIVE, _PROFILE_SOURCE, _PROFILE_GEN, _PROFILE_CAPTURES
    global _TRIGGER
    cfg = get_config()
    seconds = float(seconds if seconds is not None else cfg.profile_seconds)
    with _PROFILE_LOCK:
        if _PROFILE_ACTIVE or _PROFILE_CAPTURES >= cfg.profile_max_captures:
            return None
        _PROFILE_ACTIVE = True
        _PROFILE_SOURCE = "trigger"
        _PROFILE_GEN += 1
        _PROFILE_CAPTURES += 1
        logdir = logdir or _profile_dir(reason)
        _TRIGGER = trig = _Triggered(reason, seconds, logdir, _PROFILE_GEN)
    if _on_training_thread() and not _start_trigger(trig):
        return None
    return logdir


def maybe_trigger(reason: str) -> Optional[str]:
    """Gate a triggered capture on ``HOROVOD_PROFILE_ON_STALL`` -- the
    single hook the StallWatchdog calls."""
    try:
        from horovod_tpu_torch.config import get_config
        if not get_config().profile_on_stall:
            return None
        return trigger_profile(reason)
    except Exception:
        logger.warning("maybe_trigger(%s) failed", reason, exc_info=True)
        return None


# ---------------------------------------------------------------------------
# hvd.doctor(): ranked automated diagnosis
# ---------------------------------------------------------------------------

def _series(snap: Dict, group: str, name: str) -> List[Dict]:
    return snap.get(group, {}).get(name, []) or []


def _sum_counter(snap: Dict, name: str, **match) -> float:
    total = 0.0
    for s in _series(snap, "counters", name):
        if all(str(s.get("labels", {}).get(k)) == str(v)
               for k, v in match.items()):
            total += float(s.get("value", 0))
    return total


def _gauge_value(snap: Dict, name: str, **match) -> Optional[float]:
    for s in _series(snap, "gauges", name):
        if all(str(s.get("labels", {}).get(k)) == str(v)
               for k, v in match.items()):
            return float(s.get("value", 0))
    return None


def _hist_stats(snap: Dict, name: str, **match) -> Tuple[int, float]:
    count, total = 0, 0.0
    for s in _series(snap, "histograms", name):
        if all(str(s.get("labels", {}).get(k)) == str(v)
               for k, v in match.items()):
            count += int(s.get("count", 0))
            total += float(s.get("sum", 0.0))
    return count, total


def _load_snapshot(snapshot) -> Dict[str, Any]:
    if snapshot is None:
        from horovod_tpu_torch import metrics as _metrics
        return _metrics.snapshot()
    if isinstance(snapshot, str):
        with open(snapshot) as f:
            return json.load(f)
    return snapshot


def _load_reports(trace) -> Tuple[Optional[Dict[str, Any]],
                                  Optional[Dict[str, Any]]]:
    """Normalize the ``trace`` input to ``(straggler_report,
    request_report)``: accepts a merged-trace dict, a bare report dict, a
    merged-trace JSON path, or a shard base path / glob / directory
    (merged on the fly). Either element is None when the trace has no
    collective (resp. request) events."""
    if trace is None:
        return None, None
    if isinstance(trace, dict):
        if "stragglerReport" in trace or "requestReport" in trace:
            return trace.get("stragglerReport"), trace.get("requestReport")
        if "collectives" in trace:
            return trace, None
        if "requests" in trace:
            return None, trace
        return None, None
    if os.path.isfile(trace):
        try:
            with open(trace) as f:
                doc = json.load(f)
            if isinstance(doc, dict) and ("stragglerReport" in doc
                                          or "requestReport" in doc):
                return (doc.get("stragglerReport"),
                        doc.get("requestReport"))
        except ValueError:
            pass
    from horovod_tpu_torch.trace_merge import merge_timelines
    doc = merge_timelines(trace, feed_metrics=False)
    return doc.get("stragglerReport"), doc.get("requestReport")


def _load_report(trace) -> Optional[Dict[str, Any]]:
    """Straggler-report half of :func:`_load_reports` (back-compat)."""
    return _load_reports(trace)[0]


def _finding(category: str, severity: float, title: str, detail: str,
             suggestion: str, **evidence) -> Dict[str, Any]:
    return {"category": category, "severity": round(min(1.0, severity), 3),
            "title": title, "detail": detail, "suggestion": suggestion,
            "evidence": evidence}


def _check_stalls(snap) -> List[Dict]:
    n = _sum_counter(snap, "stall_events_total")
    if n <= 0:
        return []
    pend = snap.get("pending_collectives", [])
    names = ", ".join(p.get("tensor", "?") for p in pend[:3])
    return [_finding(
        "stall", 0.95, f"{int(n)} collective stall event(s)",
        f"the stall watchdog fired {int(n)} time(s)"
        + (f"; still pending: {names}" if names else ""),
        "a rank is stuck or dead: check the watchdog report's "
        "waiting_ranks / likely_late_processes, the merged trace blame "
        "rollup, and the host named there; elastic mode can evict it. "
        "HOROVOD_PROFILE_ON_STALL=1 captures a device trace at the next "
        "fire.", stall_events=int(n))]


def _check_straggler(report) -> List[Dict]:
    if not report:
        return []
    blame = {int(r): float(v)
             for r, v in (report.get("blame_seconds_by_rank") or {}).items()}
    if not blame:
        return []
    worst = max(blame, key=blame.get)
    worst_s = blame[worst]
    if worst_s < 0.02:
        return []
    n_ops = len(report.get("collectives", []))
    crit = float(report.get("critical_path_seconds", 0.0))
    out = [_finding(
        "straggler", 0.5 + min(0.4, worst_s),
        f"rank {worst} blamed for {worst_s * 1e3:.0f}ms of "
        f"collective wait",
        f"across {n_ops} correlated collectives, rank {worst} arrived "
        f"last often enough to be charged {worst_s:.3f}s of peer wait "
        f"(critical-path estimate {crit:.3f}s); per-rank blame: "
        f"{ {r: round(v, 3) for r, v in sorted(blame.items())} }",
        f"inspect the host of rank {worst} (input pipeline, CPU "
        "throttling, pre-step host work); negotiation_arrival_stats() "
        "names late processes live; persistent stragglers on an elastic "
        "mesh should be removed and re-admitted.",
        blamed_rank=worst, blame_seconds=worst_s)]
    return out


def _check_recompiles(snap, programs) -> List[Dict]:
    out = []
    # Fused multi-rank snapshots concatenate one identically-labeled
    # series per rank; a synchronized shape drift recompiles once PER
    # RANK, so take the per-series max, not the cross-rank sum (which
    # would report "recompiled 256x" for one recompile on a 256-rank job).
    per: Dict[str, List[float]] = {}
    for s in _series(snap, "counters", "recompiles_total"):
        prog = s.get("labels", {}).get("program", "?")
        per.setdefault(prog, []).append(float(s.get("value", 0)))
    expected_progs = {
        s.get("labels", {}).get("program", "?")
        for s in _series(snap, "counters", "expected_recompiles_total")
        if float(s.get("value", 0)) > 0}
    for prog, vals in sorted(per.items()):
        n, ranks = max(vals), len(vals)
        if n <= 0:
            continue
        rec = (programs or {}).get(prog, {})
        if rec.get("expected_recompiles") or prog in expected_progs:
            continue
        blamed = rec.get("last_blame") or sorted({
            b.get("labels", {}).get("argument", "?")
            for b in _series(snap, "counters", "recompile_blame_total")
            if b.get("labels", {}).get("program") == prog})
        detail_map = rec.get("blame_detail") or {}
        changes = "; ".join(f"{k}: {v[0]} -> {v[1]}"
                            for k, v in detail_map.items())
        across = f" on each of {ranks} rank(s)" if ranks > 1 else ""
        out.append(_finding(
            "recompile", 0.45 + min(0.35, 0.05 * n),
            f"program {prog!r} recompiled {int(n)}x{across} (blamed "
            f"argument: {', '.join(blamed) if blamed else 'unknown'})",
            f"the trace fingerprint of {prog!r} changed {int(n)} "
            f"time(s){across}" + (f" — {changes}" if changes else ""),
            "hold shapes/dtypes/static arguments constant across steps: "
            "pad ragged batches (horovod_tpu_torch.data's "
            "ShardedBatchIterator keeps them whole), pin serving "
            "geometry. Each new signature allocates its buffers afresh "
            "in the caching allocator and runs once under the cost "
            "capture (HOROVOD_PROFILER_COST).",
            program=prog, recompiles=int(n), ranks=ranks,
            blamed_arguments=blamed))
    return out


def _mfu_finding(name, mfu, hfu, expected, step_ms) -> Optional[Dict]:
    if mfu is None or not expected or mfu >= 0.8 * expected:
        return None
    at = f" at {step_ms:.1f}ms/step" if step_ms else ""
    return _finding(
        "low_mfu", 0.3 + 0.5 * (1.0 - mfu / expected),
        f"program {name!r} MFU {mfu:.1%} is below the "
        f"{expected:.0%} expectation",
        f"measured mfu={mfu:.3f}"
        + (f" (hfu={hfu:.3f})" if hfu is not None else "") + at
        + "; hfu >> mfu means remat recompute, hfu ~= mfu with both low "
        "means the step is memory- or latency-bound",
        "try remat_policy='dots' (saves the matmul outputs), a larger "
        "per-card batch, and read the step's kernels in a capture "
        "(hvd.profile()) to decide compute- vs bandwidth-bound before "
        "tuning further.",
        program=name, mfu=mfu, hfu=hfu, expected_mfu=expected)


def _check_mfu(programs, snap) -> List[Dict]:
    out = []
    seen = set()
    for name, rec in (programs or {}).items():
        seen.add(name)
        u = rec.get("utilization") or {}
        f = _mfu_finding(name, u.get("mfu"), u.get("hfu"),
                         rec.get("expected_mfu"),
                         (rec.get("last_step_seconds") or 0) * 1e3)
        if f:
            out.append(f)
    # Offline path: a fused snapshot carries the program_mfu /
    # program_expected_mfu gauges even though this process's registry
    # (``programs``) is empty.
    for s in _series(snap, "gauges", "program_mfu"):
        name = s.get("labels", {}).get("program", "?")
        if name in seen:
            continue
        seen.add(name)
        f = _mfu_finding(
            name, float(s.get("value", 0)),
            _gauge_value(snap, "program_hfu", program=name),
            _gauge_value(snap, "program_expected_mfu", program=name),
            None)
        if f:
            out.append(f)
    return out


def _check_fusion(snap) -> List[Dict]:
    count, total = _hist_stats(snap, "fusion_fill_ratio")
    if count < 3:
        return []
    mean = total / count
    if mean >= 0.5:
        return []
    return [_finding(
        "fusion_fill", 0.3 + 0.2 * (0.5 - mean) / 0.5,
        f"fusion buckets fill only {mean:.0%} of the threshold on average",
        f"{count} buckets averaged {mean:.2f} fill of "
        "HOROVOD_FUSION_THRESHOLD — collectives are paying per-dispatch "
        "latency for mostly-empty buffers",
        "lower HOROVOD_FUSION_THRESHOLD toward the observed bucket bytes, "
        "or let the tuner pick it (HOROVOD_AUTOTUNE=1 / hvd.AutotunedStep).",
        mean_fill_ratio=mean, buckets=count)]


def _check_overlap(snap, report=None) -> List[Dict]:
    eff = _gauge_value(snap, "overlap_efficiency_estimate", source="merge")
    if eff is None and report:
        # Offline path: merge_timelines(feed_metrics=False) never feeds
        # the gauge, but the report carries the same overlap section.
        # Require enough EXEC spans on some rank for "serialized" to be
        # meaningful — a 3-collective smoke is not an overlap signal.
        ov = report.get("overlap") or {}
        spans = max((int(r.get("exec_spans", 0))
                     for r in (ov.get("by_rank") or {}).values()),
                    default=0)
        if spans >= 4:
            eff = ov.get("overlap_efficiency")
    if eff is None or eff >= 0.15:
        return []
    big = _sum_counter(snap, "allreduce_algorithm_total",
                       algorithm="chunked_rs_ag")
    return [_finding(
        "low_overlap", 0.35 + 0.2 * (0.15 - eff) / 0.15,
        f"collective overlap efficiency is {eff:.0%}",
        "the merged trace shows collective EXEC spans almost fully "
        "serialized (overlap_efficiency_estimate{source=merge} = "
        f"{eff:.3f}); gradient sync is not hiding behind backward "
        "compute" + ("" if big else
                     " and no bucket used the chunked pipeline"),
        "set algorithm='chunked_rs_ag' (HOROVOD_ALLREDUCE_ALGORITHM) with "
        "HOROVOD_OVERLAP_CHUNKS=4..8 on large buckets, enable "
        "DistributedOptimizer(overlap=True) or hvd.grad(overlap=True), "
        "and HOROVOD_XLA_LATENCY_HIDING=1 on TPU.",
        overlap_efficiency=eff)]


#: cumulative (trace-time, per compiled bucket) unquantized allreduce
#: wire bytes above which the doctor suggests a quantized wire. One
#: compiled pass over a >=32MB gradient set is real bandwidth exposure;
#: tiny test meshes never get near it.
WIRE_SUGGEST_MIN_BYTES = 32 * 1024 * 1024


def _check_wire(snap) -> List[Dict]:
    """Wire-compression accounting for the allreduce path: report the
    achieved compression when a quantized wire is active, and suggest
    enabling one when heavy uncompressed traffic rides the wire."""
    per: Dict[str, float] = {}
    for s in _series(snap, "counters", "allreduce_wire_bytes_total"):
        w = s.get("labels", {}).get("wire", "?")
        per[w] = per.get(w, 0.0) + float(s.get("value", 0))
    if not per:
        return []
    quant = {w: v for w, v in per.items() if w in ("int8", "fp8") and v}
    plain = sum(v for w, v in per.items() if w not in ("int8", "fp8"))
    if quant:
        parts, ratios = [], []
        for w, v in sorted(quant.items()):
            r = _gauge_value(snap, "allreduce_compression_ratio", wire=w)
            ratios.append(r or 0.0)
            parts.append(f"{w}: {v / 1e6:.1f}MB on the wire"
                         + (f" ({r:.1f}x vs the bucket dtype)" if r
                            else ""))
        # Informational: achieved compression, ranked below real defects.
        return [_finding(
            "wire_compression", 0.05,
            f"quantized allreduce wire active "
            f"({max(ratios):.1f}x compression)",
            "allreduce buckets are riding the block-scaled 1-byte wire — "
            + "; ".join(parts)
            + (f"; {plain / 1e6:.1f}MB still uncompressed (small buckets "
               "resolve to exact psum under auto)" if plain else ""),
            "nothing to fix: pair with DistributedOptimizer("
            "error_feedback=True) for training, and watch the MNIST-"
            "parity-style convergence guardrail if you tighten formats.",
            wire_bytes_by_format={k: int(v) for k, v in per.items()})]
    if plain >= WIRE_SUGGEST_MIN_BYTES:
        return [_finding(
            "wire_uncompressed", 0.3,
            f"allreduce wire is uncompressed "
            f"({plain / 1e6:.0f}MB of fp32/bf16 payload per compiled "
            "pass)",
            "gradient synchronization is putting full-precision buckets "
            "on the interconnect; if steps are bandwidth-bound "
            "(overlap_efficiency low, busbw near the link ceiling) a "
            "block-quantized wire cuts those bytes ~4x for ~1.6% scale "
            "overhead",
            "set HOROVOD_ALLREDUCE_WIRE=int8 (or algorithm="
            "'chunked_rs_ag_int8') with DistributedOptimizer("
            "error_feedback=True); fp8 keeps relative precision inside "
            "outlier blocks. See docs/PERFORMANCE.md 'Quantized wire "
            "formats'.",
            plain_wire_bytes=int(plain))]
    return []


def _check_topology(snap) -> List[Dict]:
    """Topology/algorithm mismatch: heavy allreduce traffic riding a
    1-D ring schedule on a slice whose detected torus has >=2 usable
    dims leaves a whole mesh dimension's bandwidth on the table. Works
    offline from the exported ``config_topology`` gauges, same as
    :func:`_check_wire` works from the wire counters."""
    dims = []
    for s in _series(snap, "gauges", "config_topology"):
        try:
            d = int(s.get("labels", {}).get("dim", -1))
            v = int(s.get("value", 0))
        except (TypeError, ValueError):
            continue
        if v > 0:
            dims.append((d, v))
    torus = tuple(v for _, v in sorted(dims))
    usable = sum(1 for v in torus if v > 1)
    if usable < 2:
        return []
    from horovod_tpu_torch import overlap as _overlap
    ring = 0.0
    multi = 0.0
    for s in _series(snap, "counters", "allreduce_wire_bytes_total"):
        alg = s.get("labels", {}).get("algorithm", "")
        try:
            base, _ = _overlap.parse_algorithm(alg)
        except Exception:
            continue
        v = float(s.get("value", 0))
        if base in ("rs_ag", "chunked_rs_ag"):
            ring += v
        elif base.endswith("_2d") or base == "swing":
            multi += v
    if multi or ring < WIRE_SUGGEST_MIN_BYTES:
        return []
    topo = "x".join(str(v) for v in torus)
    return [_finding(
        "topology_ring", 0.3,
        f"1-D ring allreduce on a {topo} torus "
        f"({ring / 1e6:.0f}MB per compiled pass)",
        "the slice's detected torus has >=2 dims but every reduce-"
        "scatter/all-gather bucket is scheduled along a single ring; a "
        "two-phase torus-native lowering shrinks the second leg by the "
        "first dim's extent and roughly halves per-hop wire time on "
        "bandwidth-bound buckets",
        "set HOROVOD_ALLREDUCE_ALGORITHM=rs_ag_2d (or chunked_rs_ag_2d "
        "for >=32MB buckets; composes with wire=int8/fp8), or leave "
        "algorithm='auto' which picks the 2D lowering once the torus "
        "is detected. See docs/PERFORMANCE.md 'Topology-aware "
        "algorithms'.",
        topology=topo, ring_wire_bytes=int(ring))]


def _check_recovery(snap) -> List[Dict]:
    """Preemption-tolerance findings (docs/ELASTIC.md): report the
    measured recovery time of the last elastic re-init / relaunch (from
    the ``elastic_recovery_seconds`` gauge, anchored either at the
    launcher's failure stamp or the driver's interrupt — the live
    counterpart of the ``elastic_epoch`` trace anchors), and flag a
    checkpoint cadence slower than the preemption-notice budget: a save
    interval longer than the platform's warning window means a
    preemption loses work no notice handler could have saved."""
    out = []
    budget = _gauge_value(snap, "config_preemption_notice_seconds")
    if budget is None:
        from horovod_tpu_torch.config import get_config
        budget = get_config().preemption_notice_seconds
    rec_s = _gauge_value(snap, "elastic_recovery_seconds")
    if rec_s:
        restored = _gauge_value(snap, "checkpoint_restored_step")
        adoptions = _sum_counter(snap, "elastic_spare_promoted_total")
        sev = 0.15 if budget and rec_s <= 2 * budget else 0.55
        out.append(_finding(
            "recovery", sev,
            f"elastic recovery took {rec_s:.1f}s",
            f"the last membership change cost {rec_s:.1f}s from failure "
            f"to restored state"
            + (f" (resumed from published step {int(restored)})"
               if restored is not None else "")
            + (f"; {int(adoptions)} hot-spare promotion(s)"
               if adoptions else ""),
            "recovery = detection + relaunch/re-init + restore; shrink "
            "detection with HOROVOD_STALL_CHECK_TIME_SECONDS, keep "
            "restore cheap with sharded manifests "
            "(ShardedCheckpointManager), and provision hot spares "
            "(run_elastic(spares=N)) so the world never shrinks.",
            recovery_seconds=rec_s))
    # Min across kinds: per-step sharded publishes bound the durable-loss
    # window even when a full orbax save also runs hourly (and vice
    # versa) — the fastest flavor is the one a preemption falls back to.
    intervals = [float(s.get("value", 0)) for s in
                 _series(snap, "gauges", "checkpoint_interval_seconds")]
    interval = min([v for v in intervals if v > 0], default=None)
    if interval and budget and interval > budget:
        out.append(_finding(
            "checkpoint_cadence", 0.35 + min(0.4, 0.1 * interval / budget),
            f"checkpoint cadence {interval:.0f}s exceeds the "
            f"{budget:.0f}s preemption-notice budget",
            f"the last two published checkpoints are {interval:.1f}s "
            f"apart, but the platform only promises "
            f"{budget:.0f}s of warning (HOROVOD_PREEMPTION_NOTICE) — a "
            f"preemption in this window loses up to {interval:.0f}s of "
            "training no notice handler could flush in time",
            "checkpoint more often — the async sharded path "
            "(ShardedCheckpointManager.save) costs one D2H copy of 1/n "
            "of the optimizer state off the critical path, so per-step "
            "cadence is affordable; or raise HOROVOD_PREEMPTION_NOTICE "
            "if your platform genuinely warns earlier.",
            interval_seconds=interval, budget_seconds=budget))
    return out


def _fmt_breakdown(mean: Dict[str, float]) -> str:
    """``queue 12ms, prefill 3ms, ...`` — non-zero components only."""
    return ", ".join(f"{k} {v * 1e3:.1f}ms" for k, v in mean.items()
                     if v > 0) or "no components recorded"


def _check_requests(rreport) -> List[Dict]:
    """Tail-latency triage from the request-trace report
    (``merge_timelines`` attaches it when the merged trace has request
    spans): name WHERE the p99 TTFT went and which knob moves it."""
    if not rreport or not rreport.get("count"):
        return []
    mean = {k: float(v)
            for k, v in (rreport.get("breakdown_mean_s") or {}).items()}
    total = sum(mean.values())
    dom = rreport.get("dominant_component")
    p99 = float(rreport.get("ttft_p99_s") or 0.0)
    if not dom or total <= 0 or mean.get(dom, 0.0) < 0.3 * total:
        return []
    frac = mean[dom] / total
    n = int(rreport["count"])
    detail = (f"across {n} traced request(s), p99 TTFT is {p99 * 1e3:.1f}ms "
              f"and the mean breakdown is {_fmt_breakdown(mean)} — "
              f"{dom} dominates ({frac:.0%})")
    sev = 0.35 + min(0.3, frac - 0.3)
    out: List[Dict] = []
    if dom == "queue":
        out.append(_finding(
            "request_tail", sev,
            f"TTFT is queue-dominated ({mean[dom] * 1e3:.1f}ms mean wait)",
            detail,
            "requests wait for a decode lane before any work starts: add "
            "lanes (HOROVOD_SERVE_SLOTS) or replicas, or lower admitted "
            "concurrency so the queue drains.",
            dominant=dom, fraction=round(frac, 3),
            breakdown_mean_s=mean))
    elif dom == "push":
        out.append(_finding(
            "request_tail", sev,
            f"TTFT is push-lag-dominated ({mean[dom] * 1e3:.1f}ms mean)",
            detail,
            "tokens are generated but late leaving the server: check "
            "transport_stream_push_lag_seconds, the push pump's batch "
            "backlog, and the network path between replica and client.",
            dominant=dom, fraction=round(frac, 3),
            breakdown_mean_s=mean))
    elif dom == "hedge_wait":
        blame = {k: float(v) for k, v
                 in (rreport.get("replica_blame_s") or {}).items()}
        worst = rreport.get("dominant_replica") or (
            max(blame, key=blame.get) if blame else None)
        hedged = int(rreport.get("hedged") or 0)
        out.append(_finding(
            "request_tail", sev,
            "TTFT is dominated by retries/hedges waiting out a slow "
            "replica" + (f" ({worst})" if worst else ""),
            detail + (f"; {hedged} request(s) hedged; per-replica blame: "
                      f"{ {k: round(v, 3) for k, v in sorted(blame.items())} }"
                      if blame else ""),
            ("inspect replica "
             f"{worst or '<unknown>'}: its submit path is slow enough "
             "that hedges fire and win — check its queue depth, breaker "
             "state, and host; draining or restarting it moves the tail."),
            dominant=dom, fraction=round(frac, 3),
            slow_replica=worst, hedged=hedged))
    return out


def _check_serving(snap, rreport=None) -> List[Dict]:
    out = []
    submitted = _sum_counter(snap, "serve_requests_total",
                             status="submitted")
    expired = _sum_counter(snap, "serve_requests_total", status="expired")
    if submitted > 0 and expired > 0:
        frac = expired / submitted
        burn_detail = ("requests are missing their deadlines (queued "
                       "expiry or mid-flight EXPIRED)")
        if rreport and rreport.get("count"):
            burn_detail += ("; traced-request mean TTFT breakdown: "
                            + _fmt_breakdown(
                                {k: float(v) for k, v in
                                 (rreport.get("breakdown_mean_s")
                                  or {}).items()}))
        out.append(_finding(
            "serving_slo", 0.4 + min(0.5, frac),
            f"serving SLO burn: {int(expired)}/{int(submitted)} requests "
            f"expired ({frac:.0%})",
            burn_detail,
            "add decode lanes (HOROVOD_SERVE_SLOTS) or replicas, shrink "
            "HOROVOD_SERVE_PREFILL_CHUNK so long prompts stall decodes "
            "less, check serve_queue_wait_seconds for admission backlog, "
            "and size the KV pool (num_blocks) above peak "
            "serve_blocks_peak.",
            submitted=int(submitted), expired=int(expired)))
    rejected = _sum_counter(snap, "serve_requests_total", status="rejected")
    # No submitted > 0 gate here: an engine rejecting EVERYTHING has
    # submitted == 0 — the worst backpressure case must not read healthy.
    if rejected > 0 and rejected > 0.1 * (submitted + rejected):
        out.append(_finding(
            "serving_backpressure", 0.4,
            f"{int(rejected)} requests rejected at submit",
            "the request queue is bouncing work (backpressure or "
            "geometry rejections)",
            "raise HOROVOD_SERVE_QUEUE_LIMIT if rejections are "
            "backpressure; geometry rejections (max_len / KV pool) need "
            "a bigger engine or request-side truncation.",
            rejected=int(rejected)))
    return out


def _check_prefix(snap) -> List[Dict]:
    """Prefix-cache and speculative-decode health: a workload that keeps
    repeating prompt preambles (serve_prompt_overlap_rate, tracked even
    with the cache OFF) should be converting those repeats into
    prefix_cache_hit_rate; and a speculation lane whose drafts mostly
    get rejected is spending verify steps for nothing. Knob names match
    ``config.py``: HOROVOD_SERVE_PREFIX_CACHE, HOROVOD_SERVE_SPEC_K."""
    out = []
    overlap = {s.get("labels", {}).get("engine", "?"):
               float(s.get("value", 0))
               for s in _series(snap, "gauges", "serve_prompt_overlap_rate")}
    # The hit-rate gauge also carries scope="local"/"fleet" series
    # (disaggregated serving: grafted-in KV counts as a fleet hit);
    # this check reads the unscoped per-engine series only — the
    # always-on fleet series would otherwise clobber it with 0.0 on
    # engines whose local cache is off.
    hits = {s.get("labels", {}).get("engine", "?"):
            float(s.get("value", 0))
            for s in _series(snap, "gauges", "prefix_cache_hit_rate")
            if "scope" not in s.get("labels", {})}
    evics = {s.get("labels", {}).get("engine", "?"):
             float(s.get("value", 0))
             for s in _series(snap, "gauges", "prefix_cache_evictions")}
    for eng, ov in sorted(overlap.items()):
        if ov < 0.3:
            continue
        if eng not in hits:
            out.append(_finding(
                "prefix_cache", 0.45 + min(0.3, ov - 0.3),
                f"engine {eng}: {ov:.0%} of admitted prompts repeat a "
                f"seen preamble but the prefix cache is OFF",
                "the workload keeps re-sending the same prompt prefixes "
                "(system preambles, few-shot templates, chat history) "
                "and every repeat is prefilled from scratch — the "
                "biggest avoidable prefill cost in this profile",
                "set HOROVOD_SERVE_PREFIX_CACHE=1 (or prefix_cache=True "
                "on the engine): repeated preambles are then attached "
                "from the paged pool's radix index with copy-on-write "
                "protection instead of being recomputed.",
                engine=eng, overlap_rate=ov))
        elif hits[eng] < 0.5 * ov:
            out.append(_finding(
                "prefix_cache", 0.45,
                f"engine {eng}: prompt overlap {ov:.0%} but prefix hit "
                f"rate only {hits[eng]:.0%}",
                f"the cache is on but shareable prefixes are not being "
                f"found at admission — with "
                f"{int(evics.get(eng, 0))} LRU eviction(s), pool "
                "pressure is likely reclaiming cached preamble blocks "
                "before they are re-used (concurrent cold admissions "
                "also dilute the rate at startup)",
                "grow the KV pool (num_blocks, or cut its footprint "
                "with HOROVOD_SERVE_KV_QUANT) so index blocks survive "
                "between repeats, and check kv_blocks_shared stays > 0 "
                "under steady load.",
                engine=eng, overlap_rate=ov, hit_rate=hits[eng],
                evictions=int(evics.get(eng, 0))))
    proposed = _sum_counter(snap, "spec_tokens_proposed_total")
    accepted = _sum_counter(snap, "spec_tokens_accepted_total")
    if proposed >= 50 and accepted < 0.2 * proposed:
        rate = accepted / proposed
        out.append(_finding(
            "spec_decode", 0.4,
            f"speculative acceptance {rate:.0%} "
            f"({int(accepted)}/{int(proposed)} drafts)",
            "most drafted tokens are rejected by the verify chain — "
            "every rejected draft bought nothing, and the verify lane "
            "still paid its attention cost",
            "lower HOROVOD_SERVE_SPEC_K (shorter drafts abort sooner) "
            "or set it to 0 for this workload: the n-gram proposer only "
            "pays off on repetitive continuations (templates, code, "
            "retrieval-heavy text).",
            proposed=int(proposed), accepted=int(accepted)))
    return out


def _check_transport(snap) -> List[Dict]:
    """Serving-transport health: open circuit breakers (a replica being
    routed around RIGHT NOW), past breaker trips, and a retry rate high
    enough that the robustness stack is masking a sick network rather
    than riding out blips. Knob names in the suggestions are the ones
    ``config.py`` validates: HOROVOD_SERVE_RPC_TIMEOUT,
    HOROVOD_SERVE_MAX_RETRIES, HOROVOD_SERVE_HEDGE_MS."""
    out = []
    open_now = [s.get("labels", {}).get("replica", "?")
                for s in _series(snap, "gauges", "circuit_state")
                if float(s.get("value", 0)) >= 1.0]
    trips = _sum_counter(snap, "circuit_open_total")
    if open_now:
        out.append(_finding(
            "transport_breaker", 0.85,
            f"circuit open for replica(s): {', '.join(sorted(open_now))}",
            f"consecutive connect/timeout failures opened the breaker "
            f"({int(trips)} trip(s) total) — the dispatcher is routing "
            "around these replicas, so surviving capacity is carrying "
            "their load",
            "restart or investigate the dead replica(s); if they are "
            "merely slow, raise HOROVOD_SERVE_RPC_TIMEOUT or "
            "HOROVOD_SERVE_BREAKER_FAILURES so transient tail latency "
            "does not read as death.",
            open_replicas=sorted(open_now), trips=int(trips)))
    elif trips > 0:
        out.append(_finding(
            "transport_breaker", 0.5,
            f"{int(trips)} circuit-breaker trip(s) (all recovered)",
            "replicas went unreachable long enough to open their "
            "breakers during this run; requests failed over or were "
            "re-placed on survivors",
            "check the TRANSPORT timeline markers for which replicas "
            "tripped and when; correlate with FAULT markers or host "
            "restarts.",
            trips=int(trips)))
    rpcs = 0
    for s in _series(snap, "histograms", "transport_rpc_seconds"):
        rpcs += int(s.get("count", 0))
    retries = _sum_counter(snap, "transport_retries_total")
    if rpcs >= 20 and retries > 0.1 * rpcs:
        frac = retries / rpcs
        out.append(_finding(
            "transport_retries", 0.35 + min(0.45, frac),
            f"high transport retry rate: {int(retries)} retries over "
            f"{int(rpcs)} RPC attempts ({frac:.0%})",
            "client->replica RPCs are failing at the transport layer "
            "(connect/timeout) often enough that backoff-and-retry is "
            "doing load-bearing work — each retry burns deadline budget",
            "if replicas are healthy but slow, raise "
            "HOROVOD_SERVE_RPC_TIMEOUT; if the network is lossy, raise "
            "HOROVOD_SERVE_MAX_RETRIES (and consider hedging queued "
            "requests with HOROVOD_SERVE_HEDGE_MS) — but a sustained "
            "rate this high usually means a replica or link is sick.",
            retries=int(retries), rpc_attempts=int(rpcs)))
    polls = 0
    for s in _series(snap, "histograms", "transport_rpc_seconds"):
        if s.get("labels", {}).get("method") == "poll":
            polls += int(s.get("count", 0))
    pushed = 0.0
    for s in _series(snap, "counters", "transport_frames_total"):
        if s.get("labels", {}).get("opcode") == "token":
            pushed += float(s.get("value", 0))
    if polls >= 20 and pushed == 0:
        out.append(_finding(
            "transport_poll_mode", 0.45,
            f"{int(polls)} poll RPCs and zero pushed token frames",
            "clients are waiting for results by polling even though the "
            "v2 stream transport pushes tokens as they decode — every "
            "first token pays up to a poll interval of avoidable TTFT "
            "and every poll is a full RPC of wire overhead",
            "set HOROVOD_SERVE_TRANSPORT=stream (the default) on the "
            "client side, or drop transport='legacy' overrides — the "
            "listener answers both protocols on the same port, so the "
            "switch needs no server restart.",
            poll_rpcs=int(polls)))
    hedges = _sum_counter(snap, "transport_hedges_total")
    wins = _sum_counter(snap, "transport_hedge_wins_total")
    if hedges >= 5 and wins > 0.5 * hedges:
        out.append(_finding(
            "transport_hedging", 0.3,
            f"hedges winning {wins / hedges:.0%} of the time "
            f"({int(wins)}/{int(hedges)})",
            "duplicated requests beat their primary replica more often "
            "than not — the hedge delay fires mostly on genuinely slow "
            "replicas, i.e. load is imbalanced or a replica is degraded",
            "find the slow replica (transport_rpc_seconds by replica via "
            "the timeline, or engine serve_* gauges) rather than "
            "lowering HOROVOD_SERVE_HEDGE_MS further — hedging spends "
            "duplicate decode work to hide the problem.",
            hedges=int(hedges), wins=int(wins)))
    return out


def _check_fleet(snap) -> List[Dict]:
    """Fleet-supervisor health: quarantined replicas (a crash loop or a
    spent restart budget took capacity out ON PURPOSE), live serving
    capacity below the fleet target, and a restart rate high enough
    that the supervisor is churning instead of healing. Knob names in
    the suggestions are the ones ``config.py`` validates:
    HOROVOD_SERVE_FLEET_CRASH_LOOP_K / _CRASH_LOOP_WINDOW /
    _RESTART_BUDGET / _SPARES / _BACKOFF."""
    out = []
    by_state = {s.get("labels", {}).get("state", "?"):
                float(s.get("value", 0))
                for s in _series(snap, "gauges", "fleet_replicas")}
    target = 0.0
    for s in _series(snap, "gauges", "fleet_target_replicas"):
        target = max(target, float(s.get("value", 0)))
    quarantined = by_state.get("quarantined", 0.0)
    live = by_state.get("live", 0.0)
    if quarantined > 0:
        out.append(_finding(
            "fleet_quarantine", 0.9,
            f"{int(quarantined)} replica(s) quarantined",
            "the fleet supervisor stopped restarting these replicas — "
            "K deaths inside the crash-loop window or a spent restart "
            "budget means respawning was burning capacity, not "
            "restoring it; the crash is deterministic until someone "
            "fixes the cause",
            "read the FLEET timeline markers for the typed quarantine "
            "reason and the replica's exit history; after fixing the "
            "root cause, restart the fleet (quarantine is sticky by "
            "design). If the crashes were genuinely transient, raise "
            "HOROVOD_SERVE_FLEET_CRASH_LOOP_K / "
            "HOROVOD_SERVE_FLEET_CRASH_LOOP_WINDOW or "
            "HOROVOD_SERVE_FLEET_RESTART_BUDGET.",
            quarantined=int(quarantined)))
    if target > 0 and live < target:
        out.append(_finding(
            "fleet_capacity", 0.7,
            f"serving capacity below target: {int(live)}/{int(target)} "
            "replicas live",
            "dead or restarting replicas are not yet back; surviving "
            "replicas carry the missing share, so queue wait and TTFT "
            "degrade until the fleet heals",
            "if this persists, check for quarantines above; provision "
            "warm spares (HOROVOD_SERVE_FLEET_SPARES) so promotion — a "
            "membership write — replaces a dead rank instead of a cold "
            "process spawn.",
            live=int(live), target=int(target)))
    restarts = _sum_counter(snap, "fleet_restarts_total")
    if target > 0 and restarts >= max(5.0, 2.0 * target):
        out.append(_finding(
            "fleet_restart_burn", 0.5,
            f"{int(restarts)} replica restart(s) this run",
            "the supervisor is healing often enough that restart churn "
            "is itself a cost — each respawn re-compiles and re-warms "
            "an engine before the replica serves again",
            "correlate FLEET death markers (typed reasons: exit / "
            "unreachable / rolling) with host or network events; raise "
            "HOROVOD_SERVE_FLEET_BACKOFF to slow the churn if the "
            "environment is flaky, and keep warm spares so capacity "
            "holds while replicas rebuild.",
            restarts=int(restarts)))
    return out


def _check_roles(snap) -> List[Dict]:
    """Disaggregated-fleet role balance: with prefill and decode pools
    split (serving/disagg.py), capacity planned for one pool cannot
    help the other — a saturated prefill pool next to an idle decode
    pool (or the reverse) means the split itself is mis-sized, not the
    fleet. Quiet unless prefill-roled engines exist. Knob names match
    ``config.py``: HOROVOD_SERVE_ROLE, HOROVOD_SERVE_FLEET_PREFILL,
    HOROVOD_SERVE_FLEET_PREFILL_SPARES."""
    roles = {}
    for s in _series(snap, "gauges", "serve_role"):
        labels = s.get("labels", {})
        if float(s.get("value", 0)) >= 1.0:
            roles[labels.get("engine", "?")] = labels.get("role", "both")
    if "prefill" not in roles.values():
        return []                      # monolithic fleet: nothing to say
    active = {s.get("labels", {}).get("engine", "?"):
              float(s.get("value", 0))
              for s in _series(snap, "gauges", "serve_slots_active")}
    total = {s.get("labels", {}).get("engine", "?"):
             float(s.get("value", 0))
             for s in _series(snap, "gauges", "serve_slots_total")}
    queued = {s.get("labels", {}).get("engine", "?"):
              float(s.get("value", 0))
              for s in _series(snap, "gauges", "serve_queue_depth")}

    def _pool(role_pred):
        engines = [e for e, r in roles.items() if role_pred(r)]
        act = sum(active.get(e, 0.0) for e in engines)
        tot = sum(total.get(e, 0.0) for e in engines)
        return {"engines": engines,
                "util": (act / tot) if tot > 0 else 0.0,
                "queued": sum(queued.get(e, 0.0) for e in engines)}

    pre = _pool(lambda r: r == "prefill")
    dec = _pool(lambda r: r in ("decode", "both"))
    out = []
    pre_hot = pre["util"] >= 0.85 or pre["queued"] > 0
    dec_hot = dec["util"] >= 0.85 or dec["queued"] > 0
    pre_idle = pre["util"] <= 0.25 and pre["queued"] == 0
    dec_idle = dec["util"] <= 0.25 and dec["queued"] == 0
    if pre_hot and dec_idle and dec["engines"]:
        out.append(_finding(
            "role_imbalance", 0.55,
            f"prefill pool saturated ({pre['util']:.0%} slots, "
            f"{int(pre['queued'])} queued) while the decode pool idles "
            f"({dec['util']:.0%})",
            "new prompts queue for a prefill slot while decode "
            "replicas sit underused — TTFT degrades even though the "
            "fleet as a whole has capacity; the prefill/decode split "
            "is under-provisioned on the prefill side",
            "move a decode replica over (restart it with "
            "HOROVOD_SERVE_ROLE=prefill), or grow the pool at the "
            "fleet level: raise HOROVOD_SERVE_FLEET_PREFILL and keep "
            "a prefill-warmed spare (HOROVOD_SERVE_FLEET_PREFILL_"
            "SPARES) so the pool heals same-role.",
            prefill_util=pre["util"], decode_util=dec["util"],
            prefill_queued=int(pre["queued"])))
    elif dec_hot and pre_idle and pre["engines"]:
        out.append(_finding(
            "role_imbalance", 0.55,
            f"decode pool saturated ({dec['util']:.0%} slots, "
            f"{int(dec['queued'])} queued) while the prefill pool "
            f"idles ({pre['util']:.0%})",
            "migrated requests queue for a decode slot while prefill "
            "replicas sit underused — TPOT and queue wait degrade on "
            "the decode side; the split is over-provisioned on the "
            "prefill side",
            "move a prefill replica over (restart it with "
            "HOROVOD_SERVE_ROLE=decode), or lower "
            "HOROVOD_SERVE_FLEET_PREFILL so more of the fleet target "
            "decodes; shift spare budget with "
            "HOROVOD_SERVE_FLEET_PREFILL_SPARES to match.",
            prefill_util=pre["util"], decode_util=dec["util"],
            decode_queued=int(dec["queued"])))
    # A pool with zero LIVE members is worse than imbalance: every
    # request degrades to the monolithic path (no_prefill_pool) or,
    # with no decode pool, cannot finish at all.
    live_by_role = {}
    for s in _series(snap, "gauges", "fleet_role_replicas"):
        labels = s.get("labels", {})
        if labels.get("state") == "live":
            live_by_role[labels.get("role", "?")] = float(
                s.get("value", 0))
    if live_by_role:
        pre_live = live_by_role.get("prefill", 0.0)
        dec_live = (live_by_role.get("decode", 0.0)
                    + live_by_role.get("both", 0.0))
        if pre_live == 0 and dec_live > 0:
            out.append(_finding(
                "role_imbalance", 0.8,
                "prefill pool has no live replicas",
                "every new prompt now degrades to a monolithic "
                "prefill on the decode pool "
                "(serve_kv_migrations_total{outcome=no_prefill_pool}) "
                "— correct but with the TTFT isolation the split "
                "existed for gone",
                "check fleet quarantines for the dead prefill "
                "replicas and keep at least one prefill-warmed spare "
                "(HOROVOD_SERVE_FLEET_PREFILL_SPARES>=1) so the pool "
                "heals by promotion instead of a cold spawn.",
                prefill_live=int(pre_live), decode_live=int(dec_live)))
        elif dec_live == 0 and pre_live > 0:
            out.append(_finding(
                "role_imbalance", 0.9,
                "decode pool has no live replicas",
                "prefill replicas cannot finish a request on their "
                "own (prefill-role engines bounce non-prefill "
                "submits), so the fleet is effectively down for "
                "generation despite live capacity",
                "restart a prefill replica with "
                "HOROVOD_SERVE_ROLE=decode (or =both) immediately, "
                "then rebalance HOROVOD_SERVE_FLEET_PREFILL and the "
                "spare split.",
                prefill_live=int(pre_live), decode_live=int(dec_live)))
    return out


def _check_memory(snap) -> List[Dict]:
    n = _sum_counter(snap, "memory_pressure_total")
    if n <= 0:
        return []
    return [_finding(
        "memory_pressure", 0.85,
        f"{int(n)} device memory-pressure event(s)",
        "device HBM crossed the high-water fraction "
        f"({MEMORY_PRESSURE_FRACTION:.0%} of the limit); allocation "
        "failure / fragmentation thrash is next",
        "enable remat (remat_policy='full'), shard state (FSDP / "
        "sharded_adamw), quantize serving KV blocks "
        "(HOROVOD_SERVE_KV_QUANT=int8), or shrink the per-chip batch; "
        "program_peak_hbm_bytes{program=...} names the heavy programs.",
        events=int(n))]


def _check_sharding(snap) -> List[Dict]:
    """Params replicated while the workload is memory-bound: every
    other knob (remat, quant) trades compute or fidelity for memory —
    once a program peaks near the device limit, or a KV-quantized
    engine still rejects admissions, the honest fix is a mesh."""
    mp = _gauge_value(snap, "config_mesh_mp")
    if mp is not None and mp > 1:
        return []                       # already model-sharded
    dp = _gauge_value(snap, "config_mesh_dp") or 0.0
    world = int(dp * max(1.0, mp or 1.0))
    mesh = f"dp{world // 2}xmp2" if world >= 2 else "dp1xmp2"
    out = []
    limits = [float(s.get("value", 0)) for s in
              _series(snap, "gauges", "device_hbm_bytes_limit")]
    limit = max(limits) if limits else 0.0
    worst_prog, worst_peak = None, 0.0
    for s in _series(snap, "gauges", "program_peak_hbm_bytes"):
        v = float(s.get("value", 0))
        if v > worst_peak:
            worst_peak = v
            worst_prog = s.get("labels", {}).get("program", "?")
    if limit > 0 and worst_peak >= 0.85 * limit:
        out.append(_finding(
            "sharding", 0.7,
            f"params replicated while {worst_prog} peaks at "
            f"{worst_peak / limit:.0%} of device HBM",
            f"program_peak_hbm_bytes{{program={worst_prog}}} is within "
            f"15% of the device limit and the mesh is "
            f"data-parallel-only (config_mesh_mp <= 1): the next model "
            f"or batch bump OOMs",
            f"shard the model over the mesh: HOROVOD_MESH={mesh} "
            f"splits every attention/MLP weight (and the serving KV "
            f"pool) to 1/mp per chip with collective matmuls; see "
            f"docs/PARALLELISM.md",
            program=worst_prog, peak_hbm_bytes=worst_peak,
            device_hbm_bytes_limit=limit))
    for s in _series(snap, "gauges", "serve_kv_quant_enabled"):
        if float(s.get("value", 0)) < 1:
            continue
        eng = s.get("labels", {}).get("engine", "?")
        rej = _sum_counter(snap, "serve_requests_total", engine=eng,
                           status="rejected")
        cap = _gauge_value(snap, "serve_kv_pool_bytes_capacity",
                           engine=eng)
        if rej > 0 and cap:
            out.append(_finding(
                "sharding", 0.6,
                f"engine {eng} rejects admissions with KV quant "
                f"already on",
                f"{int(rej)} rejection(s) while the KV pool is already "
                f"quantized — the compression knob is spent, and the "
                f"mesh is data-parallel-only; only more chips' worth "
                f"of pool helps",
                f"split the KV pool over the mesh: HOROVOD_MESH={mesh} "
                f"gives each engine rank 1/mp of the kv heads (pool "
                f"bytes drop likewise); see docs/PARALLELISM.md",
                engine=eng, rejected=int(rej),
                kv_pool_bytes_capacity=cap))
    return out


def doctor(snapshot=None, trace=None, programs=None) -> Dict[str, Any]:
    """Automated performance diagnosis (``hvd.doctor()``).

    Fuses the metrics ``snapshot`` (live registry by default, or a
    flusher-written JSON path), the merged cross-rank ``trace`` (merged
    dict / report dict / merged-json path / shard base path — stragglers
    and overlap come from here), and the program registry ``programs``
    (live by default) into a **ranked** findings list, most severe first.
    Each finding carries a category, a severity in [0, 1], human-readable
    title/detail, machine-readable evidence, and a concrete knob
    suggestion. Returns ``{"findings": [...], "healthy": bool,
    "inputs": {...}}``; render with :func:`format_report`."""
    snap = _load_snapshot(snapshot)
    report, rreport = _load_reports(trace)
    progs = programs if programs is not None else registry.snapshot()

    findings: List[Dict[str, Any]] = []
    findings += _check_stalls(snap)
    findings += _check_straggler(report)
    findings += _check_requests(rreport)
    findings += _check_recompiles(snap, progs)
    findings += _check_memory(snap)
    findings += _check_sharding(snap)
    findings += _check_recovery(snap)
    findings += _check_serving(snap, rreport)
    findings += _check_prefix(snap)
    findings += _check_transport(snap)
    findings += _check_fleet(snap)
    findings += _check_roles(snap)
    findings += _check_mfu(progs, snap)
    findings += _check_overlap(snap, report)
    findings += _check_fusion(snap)
    findings += _check_wire(snap)
    findings += _check_topology(snap)
    findings.sort(key=lambda f: (-f["severity"], f["category"], f["title"]))
    for i, f in enumerate(findings):
        f["rank"] = i + 1
    return {
        "findings": findings,
        "healthy": not any(f["severity"] >= 0.5 for f in findings),
        "inputs": {
            "snapshot": "live" if snapshot is None else "provided",
            "trace": ("none" if report is None and rreport is None
                      else "provided"),
            "programs": sorted(progs or {}),
        },
    }


def doctor_window(store, window_s: float, *,
                  now: Optional[float] = None) -> Dict[str, Any]:
    """Windowed entry point: run every :func:`doctor` check over the last
    ``window_s`` seconds of a :class:`~horovod_tpu_torch.timeseries
    .TimeSeriesStore` instead of the cumulative live registry.

    The store's :meth:`window_snapshot` synthesizes a registry-shaped
    snapshot whose counters/histograms are reset-aware window deltas and
    whose gauges are the latest values, so the checks themselves run
    unchanged — a finding from here means "true *in this window*", which
    is what ``health.ContinuousDoctor`` feeds through fire/clear
    hysteresis. The program registry is deliberately excluded
    (``programs={}``): compile-time cost records are cumulative
    process-local state, not windowed fleet state."""
    snap = store.window_snapshot(window_s, now=now)
    report = doctor(snapshot=snap, trace=None, programs={})
    report["inputs"]["snapshot"] = f"window:{float(window_s):g}s"
    return report


def format_report(report: Dict[str, Any]) -> str:
    """Render a :func:`doctor` report as terminal-friendly text."""
    lines = []
    findings = report.get("findings", [])
    if not findings:
        lines.append("hvd.doctor(): no findings — nothing looks sick "
                     "from here.")
    else:
        lines.append(f"hvd.doctor(): {len(findings)} finding(s), most "
                     "severe first")
    for f in findings:
        lines.append(f"  #{f['rank']} [{f['severity']:.2f}] "
                     f"{f['category']}: {f['title']}")
        lines.append(f"      {f['detail']}")
        lines.append(f"      fix: {f['suggestion']}")
    return "\n".join(lines)
