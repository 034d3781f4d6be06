"""Eager collectives over ``torch.distributed``: NCCL on the GPU, gloo on
the CPU, under Horovod's controller.

Port of the eager half of ``horovod_tpu/collective.py`` with the torch
frontend's signatures (``horovod_tpu/torch/__init__.py``). Each rank passes
its own tensor and gets the result back (the reference simulates all ranks
in one process with ``tensor[r]`` as rank r's value; here every rank is a
process). Reductions keep the reference's semantics: ``prescale_factor`` and
``postscale_factor`` apply to Sum, Average and Adasum only, on the wire
dtype, around the reduction; Average divides the sum by the set's size
(floor division for integer tensors). Every allreduce, of one tensor or of
a group, packs its tensors into fusion buckets of at most
``fusion_threshold_bytes`` (``HOROVOD_FUSION_THRESHOLD`` by default), as the
reference's does, so a tensor above the threshold is reduced in aligned
chunks; Adasum (``adasum.py``) reduces each bucket as one vector, after
compression, so its coefficients are per bucket.

**The controller.** Every eager op runs as the reference's ``_eager_run``
does: it mints a span (``tracing.py``) whose op id every rank shares,
enters the pending-collective table the stall watchdog reads
(``metrics.py``), negotiates, then stages its buffers (the QUEUE phase:
compression, bucket packing) and issues its ``torch.distributed`` work
(the EXEC phase), each phase a timeline event (``timeline.py``) keyed by
the op id, and counts ``collective_calls_total``,
``collective_bytes_total`` and ``collective_dispatch_seconds``. EXEC is host
time: NCCL runs the work asynchronously on the device.

Negotiation (upstream ``controller.cc`` and ``response_cache.cc``) is the
reference's protocol byte for byte: every op folds ``seq|kind|sig_key`` into
a rolling 128-bit hash, and the ranks allgather an 8-int32 row (the hash,
``need_full``, ``joined`` and the previous round's wait) on the control
group (``core.control_group``: gloo, never NCCL); a rank that misses its
response cache, or a joined rank, makes every rank take the full round, an
object allgather of the signatures. A rank that issues collectives in
another order raises a readable mismatch error on every rank before any
NCCL work is issued, where it would otherwise deadlock NCCL. **Every rank of
the world takes part in every eager op's round**, process sets that do not
include it too: as with the reference, whose eager ops are world-wide
programs, every rank calls every eager collective. One grouped call is one
round. A world of one rank skips negotiation. The round blocks the calling
thread, so the ``*_async`` forms block on the control group while they
issue; the work they issue stays asynchronous. Collectives inside a training
step's forward or backward (cross-replica batch norm's moments) take no
round, as the reference's in-program collectives take none
(:func:`_in_step_allreduce`).

Every collective is issued as ``torch.distributed`` work with
``async_op=True`` on the caller's thread and wrapped in a :class:`Handle`;
the ``*_async`` forms return the handle, the others synchronize it at once.
``synchronize`` waits for the work and runs the finishing step (Average's
division, postscale, decompression, unpacking of fusion buckets, slicing
of ragged parts, the copy into the target of a ``*_async_``). There is no
dispatch thread: NCCL needs every rank to issue one group's collectives in
one order, and the caller's thread, checked by negotiation, gives it.
Adasum's rounds of point-to-point ops run when its handle is issued, not
when it is synchronized.

:func:`join` is Horovod's join for uneven data: a rank that has run out of
data calls it and, until every rank has, services the active ranks'
allreduces on the global set with the op's neutral element; their Average
divides by the number of active ranks.

A rank outside a subset process set gets what the reference gives it,
without communicating: its own tensor from allreduce, broadcast and
alltoall, zeros of the result's shape from allgather and reducescatter, and
zero rows with zero splits from an alltoall with splits. From
``ragged_allgather`` it gets zero rows: the reference's one-process
simulation hands such a rank the members' rows, which a rank outside the
group cannot receive.
"""

from __future__ import annotations

import hashlib
import time as _time
from collections import deque
from contextlib import nullcontext
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch import core as _core
from horovod_tpu_torch import fusion as _fusion
from horovod_tpu_torch import metrics as _metrics
from horovod_tpu_torch import overlap as _overlap
from horovod_tpu_torch import timeline as _tl
from horovod_tpu_torch import tracing as _tracing
from horovod_tpu_torch.adasum import (adasum_allreduce,
                                      hierarchical_adasum_allreduce)
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.config import get_config
from horovod_tpu_torch.ops import quantized as _quantized
from horovod_tpu_torch.process_set import ProcessSet, global_process_set

__all__ = ["ReduceOp", "Average", "Sum", "Min", "Max", "Product", "Adasum",
           "Handle", "allreduce", "allreduce_", "allreduce_async",
           "allreduce_async_", "grouped_allreduce",
           "grouped_allreduce_async", "broadcast", "broadcast_",
           "broadcast_async", "broadcast_async_", "allgather",
           "allgather_async", "grouped_allgather", "grouped_allgather_async",
           "ragged_allgather", "alltoall", "alltoall_async", "reducescatter",
           "reducescatter_async", "grouped_reducescatter",
           "grouped_reducescatter_async", "synchronize", "poll", "barrier",
           "broadcast_object", "allgather_object", "join",
           "negotiation_stats", "negotiation_arrival_stats",
           "negotiation_stall_report"]


class ReduceOp:
    """Reduction op ids, matching ``horovod.common.Average/Sum/...``."""
    Average = 0
    Sum = 1
    Min = 2
    Max = 3
    Product = 4
    Adasum = 5


Average = ReduceOp.Average
Sum = ReduceOp.Sum
Min = ReduceOp.Min
Max = ReduceOp.Max
Product = ReduceOp.Product
Adasum = ReduceOp.Adasum

_SCALING_OPS = (ReduceOp.Average, ReduceOp.Sum, ReduceOp.Adasum)

_DIST_OPS = {
    ReduceOp.Average: dist.ReduceOp.SUM,
    ReduceOp.Sum: dist.ReduceOp.SUM,
    ReduceOp.Min: dist.ReduceOp.MIN,
    ReduceOp.Max: dist.ReduceOp.MAX,
    ReduceOp.Product: dist.ReduceOp.PRODUCT,
}


class Handle:
    """An in-flight collective (upstream's handle into its op table).

    ``poll()`` is true once every piece of work has completed;
    ``synchronize()`` waits for them, runs the finishing step once and
    returns its result (again on later calls)."""

    __slots__ = ("_works", "_finish", "_result", "_done")

    def __init__(self, works: Sequence, finish: Callable[[], Any]):
        self._works = list(works)
        self._finish = finish
        self._result = None
        self._done = False

    def poll(self) -> bool:
        return self._done or all(w.is_completed() for w in self._works)

    def synchronize(self):
        if not self._done:
            for w in self._works:
                w.wait()
            self._result = self._finish()
            self._done = True
            self._works, self._finish = [], None
        return self._result

    def then(self, fn: Callable[[Any], Any]) -> "Handle":
        """A handle over the same work whose result is ``fn`` of this
        one's."""
        return Handle(self._works, lambda: fn(self.synchronize()))


def _ready(value) -> Handle:
    return Handle([], lambda: value)


def synchronize(handle: Handle):
    """Wait for an async collective and return its result
    (``hvd.synchronize``)."""
    return handle.synchronize()


def poll(handle: Handle) -> bool:
    """True once an async collective has completed (``hvd.poll``)."""
    return handle.poll()


def _resolve_ps(process_set: Optional[ProcessSet]) -> ProcessSet:
    return process_set if process_set is not None else global_process_set()


def _ps_key(ps: ProcessSet):
    """The set in an op's negotiated signature. The lines of one mesh axis
    share one key: each rank issues the op over its own line, and the
    lines run it side by side, as the reference's in-program collective
    over a mesh axis does."""
    if ps.line_key is not None:
        return ps.line_key
    return (ps.process_set_id,
            None if ps.ranks is None else tuple(ps.ranks))


def _dtype_name(dtype: torch.dtype) -> str:
    """The dtype as numpy and JAX spell it (``"float32"``, ``"bfloat16"``),
    so a signature folds the same bytes as the reference's."""
    return str(dtype).replace("torch.", "")


def _shapes(tensors) -> tuple:
    return tuple((tuple(t.shape), _dtype_name(t.dtype)) for t in tensors)


# ---------------------------------------------------------------------------
# negotiation (port of the reference's, horovod_tpu/collective.py:624-897)
# ---------------------------------------------------------------------------

# Monotonic op counter, rolling signature hash and response cache. The
# reference backs the cache with its native Coordinator when built; its
# Python set is the path ported here.
_OP_SEQ = 0
_NEG_HASH = b"\x00" * 16
_NEG_CACHE: set = set()
# Since-init round counts; the registry's negotiation_rounds_total mirrors
# the increments for the life of the process.
_NEG_STATS = {"full": 0, "fast": 0}
# Cross-rank arrival attribution: each round piggybacks this rank's wait at
# the PREVIOUS round's rendezvous ([wait_ms, op_seq]); after the allgather
# every rank knows every rank's wait for round k-1. The rank that waited
# least arrived last. Recent rounds in _ARRIVALS (the stall watchdog names
# late ranks from them).
_PREV_WAIT = [0, 0]
_ARRIVALS: deque = deque(maxlen=64)


def _reset_negotiation() -> None:
    """Restart the op sequence, response cache and span ids (init and
    shutdown: the submission history starts over)."""
    global _OP_SEQ, _NEG_HASH
    _OP_SEQ = 0
    _NEG_HASH = b"\x00" * 16
    _NEG_CACHE.clear()
    _NEG_STATS["full"] = _NEG_STATS["fast"] = 0
    _PREV_WAIT[0] = _PREV_WAIT[1] = 0
    _ARRIVALS.clear()
    _tracing.reset_spans()


def _host_allgather_i32(vec) -> np.ndarray:
    """One fixed-shape host round: every rank's 8 int32 values, row r =
    rank r, gathered on the control group (gloo)."""
    row = torch.as_tensor(np.asarray(vec, np.int32))
    n = _core.size()
    out = torch.empty(n * row.numel(), dtype=torch.int32)
    _quantized.ALL_GATHER_SINGLE(out, row, group=_core.control_group())
    return out.view(n, -1).numpy()


def negotiation_stats() -> dict:
    """{'full': n, 'fast': n}: content-negotiation rounds against cached
    hash-only rounds since init."""
    return dict(_NEG_STATS)


def negotiation_stall_report(timeout_s: float = 60.0):
    """[(op_signature, missing_rank_count)] of stuck negotiations. The
    reference reads them from its native coordinator; without it (the
    port has none yet) the report is empty, as the reference's is then."""
    return []


def negotiation_arrival_stats(last_n: int = 16) -> list:
    """Recent cross-rank arrival records, newest last: ``{"op_seq",
    "spread_s", "wait_s_by_process", "late_processes", "ts"}`` per
    negotiation round (the processes are ranks). Every round piggybacks each
    rank's wait at the previous round, so the rank that waited least, the
    straggler, is known one round later."""
    out = list(_ARRIVALS)
    return out[-int(last_n):] if last_n else out


def _harvest_arrivals(rows: np.ndarray) -> None:
    """Record the previous round's cross-rank waits from the piggyback
    columns (6 = wait_ms, 7 = that wait's op sequence number)."""
    active = rows[:, 5] == 0
    idx = np.nonzero(active)[0]
    if len(idx) < 2:
        return
    seqs = rows[idx, 7]
    # Only a coherent set is attributable: every active rank reporting the
    # SAME previous op (first rounds and join-restarts report seq 0).
    if (seqs <= 0).any() or len(set(seqs.tolist())) != 1:
        return
    waits_s = rows[idx, 6].astype(np.float64) / 1e3
    spread = float(waits_s.max() - waits_s.min())
    # Late = arrived within tolerance of the last arriver (who waited
    # least). Sub-resolution spreads are noise, not attribution.
    late = [] if spread < 0.002 else [
        int(r) for r, w in zip(idx, waits_s)
        if w <= waits_s.min() + max(0.002, spread * 0.1)]
    _ARRIVALS.append({
        "op_seq": int(seqs[0]), "spread_s": spread,
        "wait_s_by_process": {int(r): float(w)
                              for r, w in zip(idx, waits_s)},
        "late_processes": late,
        "ts": _time.monotonic(),
    })
    _metrics.histogram("collective_arrival_spread_seconds",
                       source="negotiation").observe(spread)


def _negotiate(kind: str, sig_key: tuple,
               service_desc: Optional[tuple] = None,
               span: Optional[_tracing.Span] = None) -> tuple:
    """One negotiation round for the op about to be issued (see the module
    docstring). ``sig_key`` holds plain Python values only (shapes, dtype
    names, the op's parameters, the process set's key). Joined ranks take
    part with their ``joined`` flag set and receive ``service_desc``, the
    descriptor they replay the op from. Returns the joined ranks (empty in
    the common case)."""
    if _core.size() <= 1:
        return ()
    t = _tl.get_timeline()
    t0 = _time.perf_counter()
    try:
        if span is not None:
            with _tracing.phase(span, "NEGOTIATE"):
                return _negotiate_inner(kind, sig_key, service_desc)
        if t is not None:
            with t.activity(f"negotiate:{kind}", category="negotiation"):
                return _negotiate_inner(kind, sig_key, service_desc)
        return _negotiate_inner(kind, sig_key, service_desc)
    finally:
        _metrics.histogram("negotiation_seconds").observe(
            _time.perf_counter() - t0)


def _negotiate_inner(kind: str, sig_key: tuple,
                     service_desc: Optional[tuple] = None) -> tuple:
    global _OP_SEQ, _NEG_HASH
    _OP_SEQ += 1
    cache_key = f"{kind}|{sig_key!r}"
    sig = f"{_OP_SEQ}|{cache_key}"
    _NEG_HASH = hashlib.sha256(_NEG_HASH + sig.encode()).digest()[:16]
    h = np.frombuffer(_NEG_HASH, np.int32)  # 4 x int32 = 128-bit hash

    need_full = 0 if cache_key in _NEG_CACHE else 1
    # Row layout (8 x int32 on every path): [hash x4, need_full, joined,
    # prev_wait_ms, prev_wait_seq].
    t_arrive = _time.perf_counter()
    rows = _host_allgather_i32(
        np.concatenate([h, [need_full, 0, _PREV_WAIT[0],
                            _PREV_WAIT[1]]]).astype(np.int32))
    _PREV_WAIT[0] = min(
        int((_time.perf_counter() - t_arrive) * 1e3), 2**31 - 1)
    _PREV_WAIT[1] = _OP_SEQ
    _harvest_arrivals(rows)
    joined = tuple(int(i) for i in np.nonzero(rows[:, 5])[0])
    active = [i for i in range(rows.shape[0]) if rows[i, 5] == 0]

    if rows[active, 4].any() or joined:
        _NEG_STATS["full"] += 1
        _metrics.counter("negotiation_rounds_total", path="full").inc()
        # Joined peers need the descriptor to replay the collective with
        # neutral contributions; attach it only when one is listening.
        payload = ("active", sig, service_desc if joined else None)
        objs = allgather_object(payload)
        act_sigs = [o[1] for o in objs if o[0] == "active"]
        if any(s != sig for s in act_sigs):
            table = "\n".join(f"  process {i}: {o[1] if len(o) > 1 else o}"
                              for i, o in enumerate(objs))
            raise RuntimeError(
                "eager collective mismatch across processes — every process "
                "must issue the same collectives in the same order "
                f"(reference: controller.cc negotiation).\n{table}")
        _NEG_CACHE.add(cache_key)
    else:
        _NEG_STATS["fast"] += 1
        _metrics.counter("negotiation_rounds_total", path="fast").inc()
        if not (rows[:, :4] == h).all():
            bad = [i for i in range(rows.shape[0])
                   if not (rows[i, :4] == h).all()]
            raise RuntimeError(
                "eager collective mismatch across processes — signature "
                f"hash diverged at op #{_OP_SEQ} (processes {bad} disagree "
                f"with local history; local op: {sig}). Every process must "
                "issue the same collectives in the same order (reference: "
                "controller.cc negotiation + response_cache.cc).")
    return joined


# ---------------------------------------------------------------------------
# one eager op under the controller (the reference's _eager_run)
# ---------------------------------------------------------------------------

def _run(kind: str, ps: ProcessSet, tensors: Sequence[torch.Tensor],
         sig_key: tuple, stage: Callable[[], Any],
         launch: Callable[[Any, tuple], Handle], name: Optional[str] = None,
         desc: Optional[tuple] = None, how: str = "eager") -> Handle:
    """Run one op: span, pending entry, negotiation on ``sig_key`` (see
    :func:`_sig`), then ``stage()`` in the QUEUE phase and ``launch(staged,
    joined)`` in the EXEC phase; returns ``launch``'s handle. ``desc`` is
    what a joined rank replays this op from. ``name`` (the public ops'
    ``name=``) labels the span, the timeline events and the stall report.

    ``how`` is ``"eager"`` for a public op; ``"replay"`` for a joined
    rank's replay, whose round already happened; ``"in_step"`` for a
    collective inside a training step's forward or backward (see
    :func:`_in_step_allreduce`): no round, a span from the negative
    sequence, and ``collective_traced_total`` in place of the eager
    counters."""
    in_step = how == "in_step"
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    span = _tracing.mint_span(kind, tensor=name,
                              process_set=ps.process_set_id, traced=in_step)
    pend = _metrics.collective_begin(kind, name=name, nbytes=nbytes,
                                     ranks=ps.ranks, op_id=span.op_id)
    t_begin = _time.perf_counter()
    try:
        with _tracing.active_span(span):
            joined: tuple = ()
            if how == "eager":
                joined = _negotiate(kind, sig_key, service_desc=desc,
                                    span=span)
                if joined:
                    _check_serviceable(kind, ps, joined, desc)
            t = _tl.get_timeline()
            epoch = _core.init_epoch()
            with (t.activity(kind, tensors=len(tensors), bytes=nbytes,
                             op_id=span.op_id, tensor=span.tensor)
                  if t is not None else nullcontext()):
                with _tracing.phase(span, "QUEUE", bytes=nbytes, epoch=epoch):
                    staged = stage()
                with _tracing.phase(span, "EXEC", epoch=epoch):
                    handle = launch(staged, joined)
        if in_step:
            _metrics.counter("collective_traced_total", kind=kind).inc()
            return handle
        # Dispatch latency: negotiation + staging + issue (host time; NCCL
        # runs the work asynchronously).
        dt = _time.perf_counter() - t_begin
        _metrics.counter("collective_calls_total", kind=kind).inc()
        _metrics.counter("collective_bytes_total", kind=kind).inc(nbytes)
        _metrics.histogram("collective_dispatch_seconds",
                           kind=kind).observe(dt)
        return handle
    finally:
        _metrics.collective_end(pend)


def _sig(tensors, *params) -> tuple:
    """An op's negotiation signature: the tensors' shapes and dtypes, then
    its parameters (the process set's key among them)."""
    return (_shapes(tensors), params)


def _check_serviceable(kind, ps, joined, desc) -> None:
    """Raise, on the active side and in the same round as the joined side,
    for what joined ranks cannot service."""
    if kind != "allreduce":
        raise RuntimeError(
            f"process(es) {list(joined)} have joined; eager "
            f"{kind} cannot be serviced by joined peers — only "
            "allreduce has defined join semantics (neutral "
            "contributions; upstream horovod/common/ops join).")
    if ps.ranks is not None:
        raise RuntimeError(
            "eager allreduce on a subset process set while "
            f"process(es) {list(joined)} are joined is not "
            "supported — use the global set or the join mask "
            "(DistributedOptimizer.step(alive=)).")
    _, shapes, op = desc[:3]
    _check_join_avg_dtypes(op, shapes)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _check_reduce(op: int, prescale: float, postscale: float,
                  compression) -> None:
    if op not in _DIST_OPS and op != ReduceOp.Adasum:
        raise ValueError(f"unknown reduce op {op}")
    if op not in _SCALING_OPS and (prescale != 1.0 or postscale != 1.0):
        raise ValueError("prescale/postscale only apply to Sum/Average/Adasum")
    marker = getattr(compression, "wire", None)
    if marker is not None and op not in (ReduceOp.Sum, ReduceOp.Average):
        raise ValueError(f"{marker} quantized allreduce supports Sum and "
                         "Average")


def _resolve_axis(algorithm: Optional[str], overlap_chunks: Optional[int],
                  wire: Optional[str]) -> tuple:
    """``algorithm``, ``overlap_chunks`` and ``wire`` with the config's
    defaults, validated as the reference's ``allreduce`` validates them."""
    cfg = get_config()
    if algorithm is None:
        algorithm = cfg.allreduce_algorithm
    if overlap_chunks is None:
        overlap_chunks = cfg.overlap_chunks
    if wire is None:
        wire = cfg.allreduce_wire
    if algorithm not in _overlap.ALGORITHMS:
        _overlap._reject_algorithm(
            algorithm,
            knob=("allreduce(algorithm=...)"
                  if algorithm != cfg.allreduce_algorithm
                  else "HOROVOD_ALLREDUCE_ALGORITHM"))
    if wire not in _overlap.WIRES:
        raise ValueError(
            f"unknown allreduce wire {wire!r}; expected one of "
            f"{_overlap.WIRES} (HOROVOD_ALLREDUCE_WIRE)")
    overlap_chunks = int(overlap_chunks)
    if overlap_chunks < 1:
        raise ValueError(
            f"overlap_chunks must be >= 1, got {overlap_chunks}")
    return algorithm, overlap_chunks, wire


def _divide(buf: torch.Tensor, k: int) -> torch.Tensor:
    return buf.div_(k) if buf.is_floating_point() else buf.floor_divide_(k)


def _ensure_p2p(ps: ProcessSet, buf: torch.Tensor) -> None:
    """Batched point-to-point ops on a subset of a NCCL group need the
    group's communicator, which only a call of every member makes."""
    if dist.get_backend(ps.group) == "nccl" and not ps.p2p_ready:
        dist.all_reduce(buf.new_zeros(1), group=ps.group)
        ps.p2p_ready = True


def _set_ranks(ps: ProcessSet) -> List[int]:
    return (list(range(dist.get_world_size())) if ps.ranks is None
            else ps.ranks)


def _adasum(buf: torch.Tensor, ps: ProcessSet) -> torch.Tensor:
    """Adasum of ``buf`` over the set (``adasum.py``), by node first when
    ``HOROVOD_HIERARCHICAL_ALLREDUCE`` is set: the set's ranks are grouped
    by ``rank // local_size``."""
    ranks = _set_ranks(ps)
    if len(ranks) == 1:
        return buf
    _ensure_p2p(ps, buf)
    if get_config().hierarchical_allreduce:
        nodes: dict = {}
        for r in ranks:
            nodes.setdefault(r // _core.local_size(), []).append(r)
        return hierarchical_adasum_allreduce(buf, list(nodes.values()),
                                             ps.group)
    return adasum_allreduce(buf, ranks, ps.group)


def _issue_reduce(buf: torch.Tensor, op: int, ps: ProcessSet,
                  prescale: float) -> list:
    """Start the in-place ``psum`` reduction of ``buf`` (already on the
    wire dtype) across ``ps``; returns the work to wait for. Adasum runs
    its rounds here, at issue (``adasum.py``: on NCCL they are queued on
    the device, on gloo they have completed on return), so it leaves no
    work."""
    if op in _SCALING_OPS and prescale != 1.0:
        buf.mul_(prescale)
    if op == ReduceOp.Adasum:
        buf.copy_(_adasum(buf, ps))
        return []
    return [dist.all_reduce(buf, op=_DIST_OPS[op], group=ps.group,
                            async_op=True)]


def _finish_reduce(buf: torch.Tensor, op: int, k: int,
                   postscale: float) -> torch.Tensor:
    """Average's division by the ``k`` contributing ranks, then
    postscale."""
    if op == ReduceOp.Average:
        _divide(buf, k)
    if op in _SCALING_OPS and postscale != 1.0:
        buf.mul_(postscale)
    return buf


def _wire_label(dtype: torch.dtype) -> str:
    """Metrics label of an unquantized payload dtype; an exact exchange of
    an int8 tensor is ``raw-int8``, so ``wire="int8"`` always means the
    quantized format (the reference's ``_wire_label``)."""
    name = _dtype_name(dtype)
    name = {"float32": "fp32", "bfloat16": "bf16", "float16": "fp16",
            "float64": "fp64"}.get(name, name)
    return f"raw-{name}" if name in _overlap.QUANT_WIRES else name


def _record_algorithm(alg: str, base: str, qwire: Optional[str],
                      c: torch.Tensor, logical: tuple, n: int, topo,
                      chunks: int) -> None:
    """The reference's per-bucket telemetry: ``allreduce_algorithm_total``,
    ``allreduce_wire_bytes_total`` (one series a leg for the decomposed
    lowerings), the ``allreduce_compression_ratio`` gauge (the same legs
    at the bucket's own dtype over the legs as shipped) and the
    ``allreduce_algorithm`` timeline marker. Counted per call (the
    reference counts per compiled bucket), on the set's size ``n``."""
    _metrics.counter("allreduce_algorithm_total", algorithm=alg).inc()
    eff_wire = qwire or _wire_label(c.dtype)
    phases = _overlap.wire_bytes_by_phase(base, c.numel(), eff_wire, n,
                                          dims=topo,
                                          elem_bytes=c.element_size())
    wb = sum(phases.values())
    if alg == "psum":
        _metrics.counter("allreduce_wire_bytes_total", algorithm=alg,
                         wire=eff_wire).inc(wb)
    else:
        for ph, b in phases.items():
            _metrics.counter("allreduce_wire_bytes_total", algorithm=alg,
                             wire=eff_wire, phase=ph).inc(b)
    numel, dtype, itemsize = logical
    wb_logical = sum(_overlap.wire_bytes_by_phase(
        base, numel, _wire_label(dtype), n, dims=topo,
        elem_bytes=itemsize).values())
    if wb_logical and wb:
        _metrics.gauge("allreduce_compression_ratio",
                       wire=eff_wire).set(wb_logical / wb)
    span = _tracing.current_span()
    if span is not None:
        _metrics._timeline_marker(
            "allreduce_algorithm", category="overlap", op_id=span.op_id,
            tensor=span.tensor, algorithm=alg,
            bytes=c.numel() * c.element_size(), wire=eff_wire,
            wire_bytes=wb, phases=dict(phases),
            topology="x".join(str(d) for d in (topo or ())),
            chunks=chunks)


def _stage_bucket(buf: torch.Tensor, compression, wire: str, op: int):
    """QUEUE: compress one fusion bucket and, under the ``bf16`` wire,
    cast a float bucket for the collective. Returns ``(c, ctx, cast_back,
    logical)``; ``logical`` is the bucket's own (numel, dtype, itemsize)."""
    logical = (buf.numel(), buf.dtype, buf.element_size())
    c, ctx = compression.compress(buf)
    cast_back = None
    if wire == "bf16" and op in (ReduceOp.Sum, ReduceOp.Average) and \
            c.is_floating_point() and c.dtype != torch.bfloat16:
        cast_back = c.dtype
        c = c.to(torch.bfloat16)
    return c, ctx, cast_back, logical


def _issue_bucket(staged, op: int, ps: ProcessSet, pre: float, post: float,
                  compression, algorithm: str, chunks: int, wire: str,
                  k: int):
    """EXEC: the per-bucket dispatcher (the reference's ``reduce_buffer``):
    resolve the bucket's lowering, strip a quantized wire from an integer
    bucket, record the telemetry and start the work. Adasum, Min, Max and
    Product pass through to ``psum``'s path. ``k`` is the number of
    contributing ranks (Average's divisor). Returns ``(works, finish)``;
    ``finish()`` returns the bucket on its own dtype."""
    c, ctx, cast_back, logical = staged
    reducible = op in (ReduceOp.Sum, ReduceOp.Average)
    quantizable = reducible and c.is_floating_point()
    n = ps.size()
    topo = _core.topology() if ps.ranks is None else None
    alg = _overlap.resolve_algorithm(
        algorithm, c.numel() * c.element_size(), op, n,
        reducible=reducible, wire=wire if quantizable else None,
        topology=topo)
    base, qwire = _overlap.parse_algorithm(alg)
    if qwire is not None and not quantizable:
        alg, qwire = base, None
    chunked = base in ("chunked_rs_ag", "chunked_rs_ag_2d")
    n_chunks = chunks if chunked else 1
    _record_algorithm(alg, base, qwire, c, logical, n, topo, n_chunks)
    if alg == "psum":
        works = _issue_reduce(c, op, ps, pre)

        def reduced():
            return _finish_reduce(c, op, k, post)
    else:
        if pre != 1.0:
            c.mul_(pre)
        phases = _core.torus_phases() if base.endswith("_2d") else None
        if qwire is not None:
            mean_k = float(k) if op == ReduceOp.Average else None
            x = c.to(torch.float32)
            if phases:
                works, lowered = _overlap.chunked_rs_ag_2d_quantized(
                    x, phases, n, n_chunks, qwire, mean_k)
            else:
                works, lowered = _overlap.chunked_rs_ag_quantized(
                    x, ps.group, n, n_chunks, qwire, mean_k)

            def reduced():
                out = lowered().to(c.dtype)
                return out.mul_(post) if post != 1.0 else out
        else:
            if base == "swing":
                _ensure_p2p(ps, c)
                works, lowered = _overlap.swing(c, ps.group, _set_ranks(ps),
                                                ps.rank())
            elif phases:
                works, lowered = _overlap.chunked_rs_ag_2d(c, phases, n,
                                                           n_chunks)
            else:
                works, lowered = _overlap.chunked_rs_ag(c, ps.group, n,
                                                        n_chunks)

            def reduced():
                return _finish_reduce(lowered(), op, k, post)

    def finish():
        r = reduced()
        if cast_back is not None:
            r = r.to(cast_back)
        return compression.decompress(r, ctx)
    return works, finish


def _stage_marker(tensors: List[torch.Tensor], threshold: int):
    """QUEUE of the quantized-marker path (``Compression.int8`` / ``fp8``,
    the reference's ``collective.py:323-393``): every float tensor in one
    fp32 buffer, each padded to a whole number of ``BLOCK``s so one
    tensor's magnitude never sets another's scale; the integer tensors in
    ordinary fusion buckets, reduced exactly."""
    live = [i for i, t in enumerate(tensors)
            if t.numel() and t.is_floating_point()]
    exact = [i for i, t in enumerate(tensors)
             if t.numel() and not t.is_floating_point()]
    spans, parts, off = [], [], 0
    for i in live:
        flat = tensors[i].reshape(-1).to(torch.float32)
        m = -(-flat.numel() // _quantized.BLOCK) * _quantized.BLOCK
        parts.append(torch.nn.functional.pad(flat, (0, m - flat.numel())))
        spans.append((i, off, flat.numel()))
        off += m
    buf = torch.cat(parts) if parts else None
    ints = (_fusion.fuse([tensors[i] for i in exact], threshold)
            if exact else ([], None))
    return buf, spans, exact, ints


def _issue_marker(staged, tensors, op: int, ps: ProcessSet, pre: float,
                  post: float, marker: str, threshold: int, k: int,
                  out: Optional[Sequence[torch.Tensor]]):
    """EXEC of the quantized-marker path: the fp32 buffer in pieces of the
    fusion threshold (``BLOCK``-aligned), each through the two-phase
    quantized allreduce (``ops/quantized.py``), Average dividing by the
    ``k`` contributing ranks before the re-quantization; the integer
    buckets through the exact ``psum``. Returns ``(works, finish)``."""
    buf, spans, exact, (ibufs, iunpack) = staged
    works, lowered = [], []
    if buf is not None:
        nbytes = _overlap.wire_bytes(buf.numel(), marker)
        _metrics.counter("allreduce_wire_bytes_total",
                         algorithm="compression", wire=marker).inc(nbytes)
        _metrics.gauge("allreduce_compression_ratio",
                       wire=marker).set(4 * buf.numel() / nbytes)
        if pre != 1.0:
            buf.mul_(pre)
        seg = max(_quantized.BLOCK,
                  (int(threshold) // 4) // _quantized.BLOCK
                  * _quantized.BLOCK)
        mean_k = float(k) if op == ReduceOp.Average else None
        for s in range(0, buf.numel(), seg):
            ws, fin = _quantized.issue_quantized_allreduce(
                buf[s:s + seg], ps.group, ps.size(), marker, mean_k)
            works.extend(ws)
            lowered.append(fin)
    for b in ibufs:
        works.extend(_issue_reduce(b, op, ps, pre))

    def finish():
        dst = ([torch.empty_like(t) for t in tensors] if out is None
               else list(out))
        if lowered:
            res = torch.cat([f() for f in lowered])
            if post != 1.0:
                res.mul_(post)
            for i, start, n in spans:
                dst[i].copy_(res[start:start + n].view(tensors[i].shape))
        if exact:
            iunpack([_finish_reduce(b, op, k, post) for b in ibufs],
                    out=[dst[i] for i in exact])
        for i, t in enumerate(tensors):
            if not t.numel():
                dst[i] = t.clone() if out is None else dst[i]
        return dst
    return works, finish


def _allreduce(tensors: List[torch.Tensor], op: int, ps: ProcessSet,
               pre: float, post: float, compression, threshold: int,
               out: Optional[Sequence[torch.Tensor]], name: Optional[str],
               how: str = "eager", algorithm: str = "auto",
               chunks: int = _overlap.DEFAULT_CHUNKS, wire: str = "fp32",
               reverse: bool = False, replay_joined: tuple = ()) -> Handle:
    """Every allreduce form: the tensors packed into fusion buckets, each
    bucket compressed (QUEUE) and reduced by its resolved lowering (EXEC);
    ``synchronize`` returns the list, written into ``out`` when given.
    ``reverse`` issues the buckets last first (the gradient-overlap order).
    ``how`` is :func:`_run`'s: a joined rank replays the op through here
    with ``"replay"`` and the joined ranks of its round in
    ``replay_joined``."""
    marker = getattr(compression, "wire", None)
    desc = None
    if ps.ranks is None:
        # Everything the bucket plan and the wire depend on: a joined rank
        # must issue exactly the NCCL work the active ranks issue.
        desc = ("allreduce", _shapes(tensors), op, pre, post, compression,
                threshold, algorithm, chunks, wire, reverse)
    # A quantized wire pads each tensor to whole blocks inside its bucket.
    # Only Sum and Average quantize; other ops keep the unpadded layout, so
    # the order of their sums and products is the psum path's.
    quantized = op in (ReduceOp.Sum, ReduceOp.Average) and (
        marker is not None
        or _overlap.parse_algorithm(algorithm)[1] is not None
        or wire in _overlap.QUANT_WIRES)
    pad = _quantized.BLOCK if quantized else 1

    def stage():
        if not ps.included():
            return None
        if marker is not None:
            return _stage_marker(tensors, threshold)
        buckets, unpack = _fusion.fuse(tensors, threshold, pad_elems=pad)
        return [_stage_bucket(b, compression, wire, op)
                for b in buckets], unpack

    def launch(staged, joined):
        if staged is None:
            if out is None:
                return _ready([t.clone() for t in tensors])
            for dst, t in zip(out, tensors):
                dst.copy_(t)
            return _ready(list(out))
        # Joined ranks contribute neutral elements: Average divides by the
        # active ranks only.
        k = ps.size() - len(joined or replay_joined)
        if marker is not None:
            works, finish = _issue_marker(staged, tensors, op, ps, pre, post,
                                          marker, threshold, k, out)
            return Handle(works, finish)
        buckets, unpack = staged
        issued: list = [None] * len(buckets)
        for b in _fusion.issue_order(len(buckets), reverse):
            issued[b] = _issue_bucket(buckets[b], op, ps, pre, post,
                                      compression, algorithm, chunks, wire,
                                      k)

        def finish():
            return unpack([fin() for _, fin in issued], out=out)
        return Handle([w for ws, _ in issued for w in ws], finish)

    return _run("allreduce", ps, tensors,
                _sig(tensors, op, _ps_key(ps), pre, post,
                     compression.__name__, threshold, algorithm, chunks,
                     reverse, wire),
                stage, launch, name=name, desc=desc, how=how)


def grouped_allreduce_async(tensors: Sequence[torch.Tensor],
                            op: int = Average,
                            process_set: Optional[ProcessSet] = None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            compression=Compression.none,
                            fusion_threshold_bytes: Optional[int] = None,
                            out: Optional[Sequence[torch.Tensor]] = None,
                            name: Optional[str] = None,
                            algorithm: Optional[str] = None,
                            overlap_chunks: Optional[int] = None,
                            wire: Optional[str] = None,
                            _reverse_issue: bool = False) -> Handle:
    """Start :func:`grouped_allreduce`; ``synchronize`` returns the list."""
    pre, post = float(prescale_factor), float(postscale_factor)
    _check_reduce(op, pre, post, compression)
    algorithm, overlap_chunks, wire = _resolve_axis(algorithm,
                                                    overlap_chunks, wire)
    tensors = list(tensors)
    ps = _resolve_ps(process_set)
    if not tensors:
        return _ready([])
    if fusion_threshold_bytes is None:
        fusion_threshold_bytes = get_config().fusion_threshold_bytes
    return _allreduce(tensors, op, ps, pre, post, compression,
                      int(fusion_threshold_bytes), out, name,
                      algorithm=algorithm, chunks=overlap_chunks, wire=wire,
                      reverse=bool(_reverse_issue))


def grouped_allreduce(tensors: Sequence[torch.Tensor], op: int = Average,
                      process_set: Optional[ProcessSet] = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      compression=Compression.none,
                      fusion_threshold_bytes: Optional[int] = None,
                      out: Optional[Sequence[torch.Tensor]] = None,
                      name: Optional[str] = None,
                      algorithm: Optional[str] = None,
                      overlap_chunks: Optional[int] = None,
                      wire: Optional[str] = None,
                      _reverse_issue: bool = False) -> List[torch.Tensor]:
    """Allreduce a list of tensors as one fused operation
    (``hvd.grouped_allreduce``): the tensors are packed into fusion buckets
    (``fusion.py``), one lowering runs per bucket, and the results are
    sliced back out. ``out`` receives the results in place when given.
    ``algorithm``, ``overlap_chunks`` and ``wire`` are :func:`allreduce`'s.
    ``_reverse_issue`` (internal) issues the buckets last first."""
    return grouped_allreduce_async(
        tensors, op, process_set, prescale_factor, postscale_factor,
        compression, fusion_threshold_bytes, out, name, algorithm,
        overlap_chunks, wire, _reverse_issue).synchronize()


def allreduce_async(tensor: torch.Tensor, op: int = Average,
                    process_set: Optional[ProcessSet] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    compression=Compression.none,
                    name: Optional[str] = None,
                    fusion_threshold_bytes: Optional[int] = None,
                    algorithm: Optional[str] = None,
                    overlap_chunks: Optional[int] = None,
                    wire: Optional[str] = None) -> Handle:
    """Start :func:`allreduce`; ``synchronize`` returns the new tensor."""
    return grouped_allreduce_async(
        [tensor], op, process_set, prescale_factor, postscale_factor,
        compression, fusion_threshold_bytes, None, name, algorithm,
        overlap_chunks, wire).then(lambda out: out[0])


def allreduce(tensor: torch.Tensor, op: int = Average,
              process_set: Optional[ProcessSet] = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              compression=Compression.none,
              name: Optional[str] = None,
              fusion_threshold_bytes: Optional[int] = None,
              algorithm: Optional[str] = None,
              overlap_chunks: Optional[int] = None,
              wire: Optional[str] = None) -> torch.Tensor:
    """Reduce this rank's ``tensor`` with every other rank's
    (``hvd.allreduce``). Returns a new tensor; the input is left as is.
    A tensor above ``fusion_threshold_bytes`` (``HOROVOD_FUSION_THRESHOLD``
    by default) is reduced in aligned chunks, as in the reference; for
    Adasum each chunk has its own coefficients.

    ``algorithm`` (default ``HOROVOD_ALLREDUCE_ALGORITHM``, ``auto``) picks
    each bucket's lowering for Sum and Average (``overlap.py``): ``psum``,
    ``rs_ag``, ``chunked_rs_ag`` (``overlap_chunks`` pieces, default
    ``HOROVOD_OVERLAP_CHUNKS``), their ``_int8`` / ``_fp8`` quantized
    forms, the ``_2d`` forms over the topology, ``swing``, or ``auto`` by
    size. Other ops pass through unchanged. ``wire`` (default
    ``HOROVOD_ALLREDUCE_WIRE``, ``fp32``): ``bf16`` casts each float bucket
    for the collective and back; ``int8`` / ``fp8`` make ``auto`` take the
    quantized forms. ``compression=Compression.int8`` / ``fp8`` quantize
    every float tensor through the two-phase quantized allreduce and
    ignore ``algorithm``; integer tensors are reduced exactly."""
    return allreduce_async(tensor, op, process_set, prescale_factor,
                           postscale_factor, compression, name,
                           fusion_threshold_bytes, algorithm,
                           overlap_chunks, wire).synchronize()


def allreduce_async_(tensor: torch.Tensor, **kwargs) -> Handle:
    """In-place :func:`allreduce_async`: ``synchronize`` writes the result
    into ``tensor`` and returns it (``hvd.allreduce_async_``)."""
    return allreduce_async(tensor, **kwargs).then(tensor.copy_)


def allreduce_(tensor: torch.Tensor, **kwargs) -> torch.Tensor:
    """In-place :func:`allreduce` (``hvd.allreduce_``)."""
    return allreduce_async_(tensor, **kwargs).synchronize()


def _in_step_allreduce_async(tensors: List[torch.Tensor], op: int,
                             ps: ProcessSet, name: Optional[str] = None,
                             out: Optional[Sequence[torch.Tensor]] = None,
                             prescale: float = 1.0, postscale: float = 1.0,
                             compression=Compression.none,
                             threshold: Optional[int] = None,
                             algorithm: str = "auto",
                             chunks: int = _overlap.DEFAULT_CHUNKS,
                             wire: str = "fp32") -> Handle:
    """Start an allreduce inside a training step's forward or backward,
    on the set's group without a negotiation round: the reference's
    in-program collective (a ``pmean`` inside the jitted step,
    ``_traced_span``), which it never negotiates. Cross-replica batch
    norm's moments and the gradient buckets of
    ``DistributedOptimizer(overlap=True)`` take this path, so a step costs
    no host round per layer or bucket, and ranks may use disjoint sets
    (batch-norm groups). Every member issues the same in-step allreduces
    in the same order because they run the same model. The fusion plan,
    the per-bucket lowering, the QUEUE and EXEC phases and the pending
    entry are those of :func:`allreduce`; its span comes from the
    negative sequence and it counts ``collective_traced_total`` (per call
    here, per compiled program in the reference). A joined rank does not
    service it: use the join mask."""
    if threshold is None:
        threshold = get_config().fusion_threshold_bytes
    return _allreduce(list(tensors), op, ps, prescale, postscale,
                      compression, int(threshold), out, name,
                      how="in_step", algorithm=algorithm, chunks=chunks,
                      wire=wire)


def _in_step_bucket_async(buf: torch.Tensor, op: int, ps: ProcessSet,
                          prescale: float, postscale: float, compression,
                          algorithm: str, chunks: int, wire: str,
                          name: Optional[str] = None) -> Handle:
    """Start the in-place allreduce of one packed gradient bucket inside
    the backward (``DistributedOptimizer(overlap=True)``): the per-bucket
    lowering of :func:`allreduce` on ``buf`` itself, under an in-step span
    (no round; see :func:`_in_step_allreduce_async`). ``synchronize``
    returns ``buf`` holding the result."""
    marker = getattr(compression, "wire", None)
    nbytes = buf.numel() * buf.element_size()

    def stage():
        if marker is not None:
            return _stage_marker([buf], nbytes)
        return _stage_bucket(buf, compression, wire, op)

    def launch(staged, joined):
        if marker is not None:
            works, finish = _issue_marker(staged, [buf], op, ps, prescale,
                                          postscale, marker, nbytes,
                                          ps.size(), [buf])
            return Handle(works, lambda: finish()[0])
        works, fin = _issue_bucket(staged, op, ps, prescale, postscale,
                                   compression, algorithm, chunks, wire,
                                   ps.size())

        def finish():
            r = fin()
            if r.data_ptr() != buf.data_ptr():
                buf.copy_(r)
            return buf
        return Handle(works, finish)

    return _run("allreduce", ps, [buf], (), stage, launch, name=name,
                how="in_step")


def _in_step_allreduce(tensor: torch.Tensor, op: int, ps: ProcessSet,
                       name: Optional[str] = None) -> torch.Tensor:
    """:func:`_in_step_allreduce_async` of one tensor, waited for."""
    return _in_step_allreduce_async([tensor], op, ps, name,
                                    algorithm="psum").synchronize()[0]


def _in_step_reducescatter(x: torch.Tensor, ps: ProcessSet,
                           name: Optional[str] = None,
                           trace_one: bool = False) -> torch.Tensor:
    """This rank's chunk of the Sum of a 1-D buffer whose length is a
    multiple of the set's size, inside a training step: the reference's
    in-program ``psum_scatter(tiled=True)``, with no round (see
    :func:`_in_step_allreduce_async`). Over one rank it returns ``x``;
    ``trace_one`` still runs it under the controller there (span,
    timeline phases, ``collective_traced_total``), with nothing to
    exchange."""
    k = ps.size()
    if k == 1 and not trace_one:
        return x

    def launch(_, joined):
        if k == 1:
            return _ready(x)
        out = x.new_empty(x.numel() // k)
        work = _overlap._RS_SINGLE(out, x, group=ps.group, async_op=True)
        return Handle([work], lambda: out)

    return _run("reducescatter", ps, [x], (), lambda: None, launch,
                name=name, how="in_step").synchronize()


def _in_step_allgather(x: torch.Tensor, ps: ProcessSet,
                       name: Optional[str] = None,
                       trace_one: bool = False) -> torch.Tensor:
    """Every member's 1-D ``x``, concatenated in set order, inside a
    training step: the reference's in-program ``all_gather(tiled=True)``,
    with no round. ``trace_one`` as in :func:`_in_step_reducescatter`."""
    k = ps.size()
    if k == 1 and not trace_one:
        return x

    def launch(_, joined):
        if k == 1:
            return _ready(x)
        out = x.new_empty(x.numel() * k)
        work = _quantized.ALL_GATHER_SINGLE(out, x.contiguous(),
                                            group=ps.group, async_op=True)
        return Handle([work], lambda: out)

    return _run("allgather", ps, [x], (), lambda: None, launch, name=name,
                how="in_step").synchronize()



# ---------------------------------------------------------------------------
# the other collectives
# ---------------------------------------------------------------------------

def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     process_set: Optional[ProcessSet] = None,
                     name: Optional[str] = None) -> Handle:
    """In-place :func:`broadcast_async`: ``synchronize`` returns ``tensor``
    holding the root's value."""
    ps = _resolve_ps(process_set)
    if ps.ranks is not None and root_rank not in ps.ranks:
        raise ValueError(f"root rank {root_rank} not in process set "
                         f"{ps.ranks}")
    root = int(root_rank)

    def stage():
        if not ps.included():
            return None
        # NCCL moves device memory only: a host tensor (an optimizer's
        # step count) is staged through the device.
        if tensor.device.type == "cpu" and \
                dist.get_backend(ps.group) == "nccl":
            return tensor.to(torch.device("cuda",
                                          torch.cuda.current_device()))
        return tensor if tensor.is_contiguous() else tensor.contiguous()

    def launch(buf, joined):
        if buf is None:
            return _ready(tensor)
        work = dist.broadcast(buf, src=root, group=ps.group, async_op=True)
        if buf is tensor:
            return Handle([work], lambda: tensor)

        def finish():
            tensor.copy_(buf)
            return tensor
        return Handle([work], finish)

    return _run("broadcast", ps, [tensor], _sig([tensor], root, _ps_key(ps)),
                stage, launch, name=name)


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    process_set: Optional[ProcessSet] = None,
                    name: Optional[str] = None) -> Handle:
    """Start :func:`broadcast`; ``synchronize`` returns a new tensor."""
    return broadcast_async_(tensor.clone(), root_rank, process_set, name)


def broadcast(tensor: torch.Tensor, root_rank: int,
              process_set: Optional[ProcessSet] = None,
              name: Optional[str] = None) -> torch.Tensor:
    """``root_rank``'s tensor on every rank (``hvd.broadcast``); returns a
    new tensor."""
    return broadcast_async(tensor, root_rank, process_set,
                           name).synchronize()


def broadcast_(tensor: torch.Tensor, root_rank: int,
               process_set: Optional[ProcessSet] = None,
               name: Optional[str] = None) -> torch.Tensor:
    """In-place :func:`broadcast`."""
    return broadcast_async_(tensor, root_rank, process_set,
                            name).synchronize()


def _rows(tensor: torch.Tensor) -> torch.Tensor:
    x = tensor.contiguous()
    return x.reshape(1) if x.dim() == 0 else x


def _issue_allgather(x: torch.Tensor, ps: ProcessSet):
    """(work, parts): every member's ``x`` into ``parts``, in set order."""
    parts = [torch.empty_like(x) for _ in range(ps.size())]
    return dist.all_gather(parts, x, group=ps.group, async_op=True), parts


def allgather_async(tensor: torch.Tensor,
                    process_set: Optional[ProcessSet] = None,
                    name: Optional[str] = None) -> Handle:
    """Start :func:`allgather`; ``synchronize`` returns the concatenation."""
    return grouped_allgather_async([tensor], process_set, name).then(
        lambda out: out[0])


def allgather(tensor: torch.Tensor,
              process_set: Optional[ProcessSet] = None,
              name: Optional[str] = None) -> torch.Tensor:
    """Every rank's tensor concatenated along dim 0, in rank order
    (``hvd.allgather``); all ranks pass the same shape (see
    :func:`ragged_allgather` for per-rank dim-0 sizes)."""
    return allgather_async(tensor, process_set, name).synchronize()


def grouped_allgather_async(tensors: Sequence[torch.Tensor],
                            process_set: Optional[ProcessSet] = None,
                            name: Optional[str] = None) -> Handle:
    """Start :func:`grouped_allgather`; ``synchronize`` returns the list."""
    ps = _resolve_ps(process_set)
    tensors = list(tensors)

    def stage():
        return [_rows(t) for t in tensors]

    def launch(xs, joined):
        if not ps.included():
            return _ready([x.new_zeros((ps.size() * x.shape[0],)
                                       + x.shape[1:]) for x in xs])
        issued = [_issue_allgather(x, ps) for x in xs]
        return Handle([w for w, _ in issued],
                      lambda: [torch.cat(parts, dim=0)
                               for _, parts in issued])

    return _run("allgather", ps, tensors, _sig(tensors, _ps_key(ps)), stage,
                launch, name=name)


def grouped_allgather(tensors: Sequence[torch.Tensor],
                      process_set: Optional[ProcessSet] = None,
                      name: Optional[str] = None) -> List[torch.Tensor]:
    """:func:`allgather` of each tensor, issued together
    (``hvd.grouped_allgather``)."""
    return grouped_allgather_async(tensors, process_set,
                                   name).synchronize()


def _exchange_counts(counts: Sequence[int], ps: ProcessSet,
                     device: torch.device) -> List[List[int]]:
    """Every member's ``counts`` row, in set order (one blocking
    all-gather; on the device under NCCL)."""
    if dist.get_backend(ps.group) == "nccl" and device.type != "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    row = torch.tensor(list(counts), dtype=torch.int64, device=device)
    parts = [torch.empty_like(row) for _ in range(ps.size())]
    dist.all_gather(parts, row, group=ps.group)
    return torch.stack(parts).tolist()


def _ragged_shapes(x: torch.Tensor) -> tuple:
    """A signature's shapes where dim 0 differs from rank to rank."""
    return (((-1,) + tuple(x.shape[1:]), _dtype_name(x.dtype)),)


def ragged_allgather(tensor: torch.Tensor,
                     process_set: Optional[ProcessSet] = None,
                     name: Optional[str] = None) -> torch.Tensor:
    """Every member's rows concatenated along dim 0, where dim 0 may differ
    from rank to rank (the reference's eager ``ragged_allgather`` and
    upstream allgather's ragged mode): the sizes are exchanged first, then
    each rank's rows travel padded to the largest."""
    ps = _resolve_ps(process_set)
    x = _rows(tensor)

    def stage():
        if not ps.included():
            return None
        sizes = [row[0] for row in _exchange_counts([x.shape[0]], ps,
                                                    x.device)]
        top = max(sizes)
        padded = x if x.shape[0] == top else torch.cat(
            [x, x.new_zeros((top - x.shape[0],) + x.shape[1:])])
        return padded, sizes

    def launch(staged, joined):
        if staged is None:
            return _ready(x[:0].clone())
        padded, sizes = staged
        work, parts = _issue_allgather(padded, ps)
        return Handle([work], lambda: torch.cat(
            [p[:n] for p, n in zip(parts, sizes)], dim=0))

    return _run("allgather", ps, [x],
                (_ragged_shapes(x), (_ps_key(ps), "ragged")), stage, launch,
                name=name).synchronize()


def alltoall_async(tensor: torch.Tensor, splits=None,
                   process_set: Optional[ProcessSet] = None,
                   name: Optional[str] = None) -> Handle:
    """Start :func:`alltoall`; ``synchronize`` returns what it returns."""
    ps = _resolve_ps(process_set)
    k = ps.size()
    x = tensor.contiguous()
    if splits is None:
        if x.dim() == 0 or x.shape[0] % k:
            raise ValueError(f"alltoall requires dim0 ({tuple(x.shape)}) "
                             f"divisible by set size {k}")

        def launch_even(_, joined):
            if not ps.included():
                return _ready(x.clone())
            out = torch.empty_like(x)
            work = dist.all_to_all_single(out, x, group=ps.group,
                                          async_op=True)
            return Handle([work], lambda: out)
        return _run("alltoall", ps, [x], _sig([x], _ps_key(ps)),
                    lambda: None, launch_even, name=name)
    send = [int(s) for s in (splits.tolist() if torch.is_tensor(splits)
                             else splits)]
    if len(send) != k:
        raise ValueError(f"splits must have one entry per set member ({k}), "
                         f"got {len(send)}")
    if ps.included() and (sum(send) != x.shape[0] or min(send) < 0):
        raise ValueError(f"splits {send} do not cover the tensor's "
                         f"{x.shape[0]} rows")

    def stage():
        if not ps.included():
            return None
        me = ps.rank()
        return [row[me] for row in _exchange_counts(send, ps, x.device)]

    def launch(recv, joined):
        if recv is None:
            return _ready((x[:0].clone(), torch.zeros(k, dtype=torch.int64)))
        out = x.new_empty((sum(recv),) + x.shape[1:])
        work = dist.all_to_all_single(out, x, output_split_sizes=recv,
                                      input_split_sizes=send, group=ps.group,
                                      async_op=True)
        return Handle([work], lambda: (out, torch.tensor(
            recv, dtype=torch.int64)))

    return _run("alltoall", ps, [x],
                (_ragged_shapes(x), (_ps_key(ps), "splits")), stage, launch,
                name=name)


def alltoall(tensor: torch.Tensor, splits=None,
             process_set: Optional[ProcessSet] = None,
             name: Optional[str] = None):
    """Send slices of dim 0 to every member and gather theirs
    (``hvd.alltoall``).

    Without ``splits``: equal slices (dim 0 divisible by the set size);
    returns the received tensor, slices in set-rank order. With ``splits``
    (this rank's row count for each member, in set-rank order): returns
    ``(received, received_splits)``, ``received_splits[j]`` rows from member
    j, as the reference's torch frontend does."""
    return alltoall_async(tensor, splits, process_set, name).synchronize()


def grouped_reducescatter_async(tensors: Sequence[torch.Tensor],
                                op: int = Average,
                                process_set: Optional[ProcessSet] = None,
                                name: Optional[str] = None) -> Handle:
    """Start :func:`grouped_reducescatter`; ``synchronize`` returns the
    list."""
    if op not in (ReduceOp.Sum, ReduceOp.Average):
        raise ValueError("reducescatter supports Sum and Average")
    ps = _resolve_ps(process_set)
    k = ps.size()
    xs = [t.contiguous() for t in tensors]
    for x in xs:
        if x.dim() == 0 or x.shape[0] % k:
            raise ValueError(f"reducescatter requires dim0 "
                             f"({tuple(x.shape)}) divisible by {k}")

    def launch(_, joined):
        if not ps.included():
            return _ready([x.new_zeros((x.shape[0] // k,) + x.shape[1:])
                           for x in xs])
        outs, works = [], []
        for x in xs:
            out = x.new_empty((x.shape[0] // k,) + x.shape[1:])
            works.append(dist.reduce_scatter(out, list(x.chunk(k)),
                                             op=dist.ReduceOp.SUM,
                                             group=ps.group, async_op=True))
            outs.append(out)

        def finish():
            return [_divide(o, k) if op == ReduceOp.Average else o
                    for o in outs]
        return Handle(works, finish)

    return _run("reducescatter", ps, xs, _sig(xs, op, _ps_key(ps)),
                lambda: None, launch, name=name)


def grouped_reducescatter(tensors: Sequence[torch.Tensor],
                          op: int = Average,
                          process_set: Optional[ProcessSet] = None,
                          name: Optional[str] = None) -> List[torch.Tensor]:
    """:func:`reducescatter` of each tensor, issued together
    (``hvd.grouped_reducescatter``)."""
    return grouped_reducescatter_async(tensors, op, process_set,
                                       name).synchronize()


def reducescatter_async(tensor: torch.Tensor, op: int = Average,
                        process_set: Optional[ProcessSet] = None,
                        name: Optional[str] = None) -> Handle:
    """Start :func:`reducescatter`; ``synchronize`` returns this rank's
    chunk."""
    return grouped_reducescatter_async([tensor], op, process_set,
                                       name).then(lambda out: out[0])


def reducescatter(tensor: torch.Tensor, op: int = Average,
                  process_set: Optional[ProcessSet] = None,
                  name: Optional[str] = None) -> torch.Tensor:
    """Reduce every member's tensor, then keep this rank's equal chunk of
    dim 0 (``hvd.reducescatter``; Sum or Average, dim 0 divisible by the
    set size)."""
    return reducescatter_async(tensor, op, process_set, name).synchronize()


def _group_barrier(ps: ProcessSet) -> None:
    if dist.get_backend(ps.group) == "nccl":
        dist.barrier(group=ps.group,
                     device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=ps.group)


def barrier(process_set: Optional[ProcessSet] = None) -> None:
    """Block until every rank of the set arrives (``hvd.barrier``). Like
    every eager op it takes a negotiation round on every rank of the world;
    ranks outside the set then return at once."""
    ps = _resolve_ps(process_set)

    def launch(_, joined):
        if ps.included():
            _group_barrier(ps)
        return _ready(None)

    _run("barrier", ps, [], _sig([], _ps_key(ps)), lambda: None, launch,
         name="barrier").synchronize()


def broadcast_object(obj: Any, root_rank: int = 0,
                     process_set: Optional[ProcessSet] = None) -> Any:
    """A picklable object from ``root_rank`` on every rank
    (``hvd.broadcast_object``). On the global set it travels over the
    control group (host memory); not negotiated, as in the reference."""
    ps = _resolve_ps(process_set)
    if not ps.included():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=int(root_rank), group=_object_group(
        ps))
    return box[0]


def allgather_object(obj: Any, process_set: Optional[ProcessSet] = None,
                     name: Optional[str] = None) -> list:
    """Every member's picklable object, in set order
    (``hvd.allgather_object``); a rank outside the set gets []. On the
    global set it travels over the control group; negotiation's full round
    is one."""
    ps = _resolve_ps(process_set)
    if not ps.included():
        return []
    out = [None] * ps.size()
    dist.all_gather_object(out, obj, group=_object_group(ps))
    return out


def _object_group(ps: ProcessSet):
    return _core.control_group() if ps.ranks is None else ps.group


# ---------------------------------------------------------------------------
# join (port of horovod_tpu/collective.py:1681-1829)
# ---------------------------------------------------------------------------

def join() -> int:
    """Join op for uneven data (``hvd.join``): this rank has no more
    batches. Blocks until every rank has joined and returns the rank of the
    **last** rank to join.

    While it waits, a joined rank services the active ranks' eager
    allreduces on the global set: each negotiation round it flags
    ``joined``, receives the op's descriptor and issues the same NCCL work
    with the op's neutral element (0 for Sum, Average and Adasum, the
    dtype's max for Min and min for Max, 1 for Product). The active ranks'
    Average divides by the number of active ranks. Any other op while a
    rank is joined, and an allreduce on a subset set, raise on every rank
    before any work is issued.

    When every rank has joined, each measures how long it waited on its own
    monotonic clock; the one that waited least joined last (ties go to the
    higher rank). A barrier then flushes the serviced work, and the
    negotiation history and span ids restart on every rank. A world of one
    rank runs a barrier and returns ``size() - 1``."""
    global _OP_SEQ, _NEG_HASH
    if _core.size() <= 1:
        barrier()
        return _core.size() - 1
    t0 = _time.monotonic()
    while not _join_service_round():
        pass
    waited = _time.monotonic() - t0
    table = allgather_object((waited, -_core.rank()))
    _group_barrier(global_process_set())
    # Joined ranks serviced ops without folding them into their rolling
    # hash: restart the history on every rank (all are here). Span ids and
    # the piggybacked wait count the same sequence.
    _OP_SEQ = 0
    _NEG_HASH = b"\x00" * 16
    _PREV_WAIT[0] = _PREV_WAIT[1] = 0
    _tracing.reset_spans()
    return -min(table)[1]


def _join_service_round() -> bool:
    """One negotiation round as a joined rank: True once every rank has
    joined; else an active rank issued an op: replay it with neutral
    contributions and return False."""
    rows = _host_allgather_i32(
        np.array([0, 0, 0, 0, 1, 1, 0, 0], np.int32))
    if rows[:, 5].all():
        return True
    objs = allgather_object(("joined",))
    actives = [o for o in objs if o[0] == "active"]
    if any(o[1] != actives[0][1] for o in actives):
        # The actives raise their mismatch error this round; a joined rank
        # must raise too, not replay work the actives never issue.
        table = "\n".join(f"  process {i}: {o[1] if len(o) > 1 else o}"
                          for i, o in enumerate(objs))
        raise RuntimeError(
            "eager collective mismatch across ACTIVE processes while this "
            f"process is joined — nothing to service.\n{table}")
    desc = next((o[2] for o in actives if o[2] is not None), None)
    if desc is None:
        raise RuntimeError(
            "joined process cannot service this eager collective (no "
            "descriptor — only global-set allreduce is join-serviceable)")
    (_, shapes, op, pre, post, compression, threshold, algorithm, chunks,
     wire, reverse) = desc
    _check_join_avg_dtypes(op, shapes)
    dev = _core.device()
    tensors = []
    for shape, name in shapes:
        dtype = getattr(torch, name)
        tensors.append(torch.full(shape, _neutral_host(op, dtype),
                                  dtype=dtype, device=dev))
    _allreduce(tensors, op, global_process_set(), pre, post, compression,
               threshold, None, None, how="replay", algorithm=algorithm,
               chunks=chunks, wire=wire, reverse=reverse,
               replay_joined=tuple(int(i) for i in np.nonzero(rows[:, 5])[0])
               ).synchronize()
    return False


def _check_join_avg_dtypes(op: int, shapes) -> None:
    """Integer Average cannot take the joined-divisor correction; raise on
    both sides of the round, before any work is issued, so neither peer is
    left inside a collective."""
    if op != ReduceOp.Average:
        return
    bad = [d for _, d in shapes if not getattr(torch, d).is_floating_point]
    if bad:
        raise RuntimeError(
            f"integer Average allreduce (dtypes {bad}) with joined ranks "
            "is not supported (the divisor correction needs float "
            "arithmetic) — use Sum and divide yourself.")


def _neutral_host(op: int, dtype: torch.dtype):
    """A joined rank's contribution: the op's neutral element in
    ``dtype``."""
    if op in (ReduceOp.Sum, ReduceOp.Average, ReduceOp.Adasum):
        return 0
    info = torch.finfo if dtype.is_floating_point else torch.iinfo
    if op == ReduceOp.Min:
        return info(dtype).max
    if op == ReduceOp.Max:
        return info(dtype).min
    if op == ReduceOp.Product:
        return 1
    raise RuntimeError(f"op {op} has no join-neutral element")
