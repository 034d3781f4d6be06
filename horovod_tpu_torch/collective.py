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
from horovod_tpu_torch import timeline as _tl
from horovod_tpu_torch import tracing as _tracing
from horovod_tpu_torch.adasum import (adasum_allreduce,
                                      hierarchical_adasum_allreduce)
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.config import get_config
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

# ``all_gather_into_tensor`` under its newer name where torch has it.
_ALL_GATHER_SINGLE = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)


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
    _ALL_GATHER_SINGLE(out, row, group=_core.control_group())
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
    if getattr(compression, "wire", None) is not None:
        raise NotImplementedError("quantized wire: not yet ported")


def _divide(buf: torch.Tensor, k: int) -> torch.Tensor:
    return buf.div_(k) if buf.is_floating_point() else buf.floor_divide_(k)


def _adasum(buf: torch.Tensor, ps: ProcessSet) -> torch.Tensor:
    """Adasum of ``buf`` over the set (``adasum.py``), by node first when
    ``HOROVOD_HIERARCHICAL_ALLREDUCE`` is set: the set's ranks are grouped
    by ``rank // local_size``."""
    ranks = (list(range(dist.get_world_size())) if ps.ranks is None
             else ps.ranks)
    if len(ranks) == 1:
        return buf
    if dist.get_backend(ps.group) == "nccl" and not ps.p2p_ready:
        # Batched point-to-point ops on a subset of a NCCL group need the
        # group's communicator, which only a call of every member makes.
        dist.all_reduce(buf.new_zeros(1), group=ps.group)
        ps.p2p_ready = True
    if get_config().hierarchical_allreduce:
        nodes: dict = {}
        for r in ranks:
            nodes.setdefault(r // _core.local_size(), []).append(r)
        return hierarchical_adasum_allreduce(buf, list(nodes.values()),
                                             ps.group)
    return adasum_allreduce(buf, ranks, ps.group)


def _issue_reduce(buf: torch.Tensor, op: int, ps: ProcessSet,
                  prescale: float) -> list:
    """Start the in-place reduction of ``buf`` (already on the wire dtype)
    across ``ps``; returns the work to wait for. Adasum runs its rounds
    here, at issue (``adasum.py``: on NCCL they are queued on the device,
    on gloo they have completed on return), so it leaves no work."""
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


def _allreduce(tensors: List[torch.Tensor], op: int, ps: ProcessSet,
               pre: float, post: float, compression, threshold: int,
               out: Optional[Sequence[torch.Tensor]], name: Optional[str],
               how: str = "eager") -> Handle:
    """Every allreduce form: the tensors packed into fusion buckets, each
    bucket compressed (QUEUE) and reduced (EXEC); ``synchronize`` returns
    the list, written into ``out`` when given. ``how`` is :func:`_run`'s: a
    joined rank replays the op through here with ``"replay"``."""
    desc = None
    if ps.ranks is None:
        # Everything the bucket plan and the wire depend on: a joined rank
        # must issue exactly the NCCL work the active ranks issue.
        desc = ("allreduce", _shapes(tensors), op, pre, post, compression,
                threshold)

    def stage():
        if not ps.included():
            return None
        buckets, unpack = _fusion.fuse(tensors, threshold)
        return [compression.compress(b) for b in buckets], unpack

    def launch(staged, joined):
        if staged is None:
            if out is None:
                return _ready([t.clone() for t in tensors])
            for dst, t in zip(out, tensors):
                dst.copy_(t)
            return _ready(list(out))
        wire, unpack = staged
        works = []
        for c, _ in wire:
            works.extend(_issue_reduce(c, op, ps, pre))
        # Joined ranks contributed neutral elements: Average divides by
        # the active ranks only.
        k = ps.size() - len(joined)

        def finish():
            return unpack([compression.decompress(
                _finish_reduce(c, op, k, post), ctx) for c, ctx in wire],
                out=out)
        return Handle(works, finish)

    return _run("allreduce", ps, tensors,
                _sig(tensors, op, _ps_key(ps), pre, post,
                     compression.__name__, threshold),
                stage, launch, name=name, desc=desc, how=how)


def grouped_allreduce_async(tensors: Sequence[torch.Tensor],
                            op: int = Average,
                            process_set: Optional[ProcessSet] = None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            compression=Compression.none,
                            fusion_threshold_bytes: Optional[int] = None,
                            out: Optional[Sequence[torch.Tensor]] = None,
                            name: Optional[str] = None) -> Handle:
    """Start :func:`grouped_allreduce`; ``synchronize`` returns the list."""
    pre, post = float(prescale_factor), float(postscale_factor)
    _check_reduce(op, pre, post, compression)
    tensors = list(tensors)
    ps = _resolve_ps(process_set)
    if not tensors:
        return _ready([])
    if fusion_threshold_bytes is None:
        fusion_threshold_bytes = get_config().fusion_threshold_bytes
    return _allreduce(tensors, op, ps, pre, post, compression,
                      int(fusion_threshold_bytes), out, name)


def grouped_allreduce(tensors: Sequence[torch.Tensor], op: int = Average,
                      process_set: Optional[ProcessSet] = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      compression=Compression.none,
                      fusion_threshold_bytes: Optional[int] = None,
                      out: Optional[Sequence[torch.Tensor]] = None,
                      name: Optional[str] = None) -> List[torch.Tensor]:
    """Allreduce a list of tensors as one fused operation
    (``hvd.grouped_allreduce``): the tensors are packed into fusion buckets
    (``fusion.py``), one collective runs per bucket, and the results are
    sliced back out. ``out`` receives the results in place when given."""
    return grouped_allreduce_async(
        tensors, op, process_set, prescale_factor, postscale_factor,
        compression, fusion_threshold_bytes, out, name).synchronize()


def allreduce_async(tensor: torch.Tensor, op: int = Average,
                    process_set: Optional[ProcessSet] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    compression=Compression.none,
                    name: Optional[str] = None,
                    fusion_threshold_bytes: Optional[int] = None) -> Handle:
    """Start :func:`allreduce`; ``synchronize`` returns the new tensor."""
    return grouped_allreduce_async(
        [tensor], op, process_set, prescale_factor, postscale_factor,
        compression, fusion_threshold_bytes, None, name).then(
            lambda out: out[0])


def allreduce(tensor: torch.Tensor, op: int = Average,
              process_set: Optional[ProcessSet] = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              compression=Compression.none,
              name: Optional[str] = None,
              fusion_threshold_bytes: Optional[int] = None) -> torch.Tensor:
    """Reduce this rank's ``tensor`` with every other rank's
    (``hvd.allreduce``). Returns a new tensor; the input is left as is.
    A tensor above ``fusion_threshold_bytes`` (``HOROVOD_FUSION_THRESHOLD``
    by default) is reduced in aligned chunks, as in the reference; for
    Adasum each chunk has its own coefficients."""
    return allreduce_async(tensor, op, process_set, prescale_factor,
                           postscale_factor, compression, name,
                           fusion_threshold_bytes).synchronize()


def allreduce_async_(tensor: torch.Tensor, **kwargs) -> Handle:
    """In-place :func:`allreduce_async`: ``synchronize`` writes the result
    into ``tensor`` and returns it (``hvd.allreduce_async_``)."""
    return allreduce_async(tensor, **kwargs).then(tensor.copy_)


def allreduce_(tensor: torch.Tensor, **kwargs) -> torch.Tensor:
    """In-place :func:`allreduce` (``hvd.allreduce_``)."""
    return allreduce_async_(tensor, **kwargs).synchronize()


def _in_step_allreduce(tensor: torch.Tensor, op: int, ps: ProcessSet,
                       name: Optional[str] = None) -> torch.Tensor:
    """An allreduce inside a training step's forward or backward, issued on
    the set's group without a negotiation round: the reference's in-program
    collective (a ``pmean`` inside the jitted step, ``_traced_span``), which
    it never negotiates. Cross-replica batch norm's moments take this path
    (``ops/batch_norm.py``), so a step costs no host round per layer, and
    ranks may use disjoint sets (batch-norm groups). Every member issues
    the same in-step allreduces in the same order because they run the
    same model. The fusion plan, the QUEUE and EXEC phases and the pending
    entry are those of :func:`allreduce`; its span comes from the negative
    sequence and it counts ``collective_traced_total`` (per call here, per
    compiled program in the reference). A joined rank does not service it:
    use the join mask."""
    return _allreduce([tensor], op, ps, 1.0, 1.0, Compression.none,
                      get_config().fusion_threshold_bytes, None, name,
                      how="in_step").synchronize()[0]


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
    _, shapes, op, pre, post, compression, threshold = desc
    _check_join_avg_dtypes(op, shapes)
    dev = _core.device()
    tensors = []
    for shape, name in shapes:
        dtype = getattr(torch, name)
        tensors.append(torch.full(shape, _neutral_host(op, dtype),
                                  dtype=dtype, device=dev))
    _allreduce(tensors, op, global_process_set(), pre, post, compression,
               threshold, None, None, how="replay").synchronize()
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
