"""The allreduce algorithm axis: algorithm selection and the lowerings of a
fusion bucket onto ``torch.distributed``.

Port of ``horovod_tpu/overlap.py``. Every Sum or Average fusion bucket can
go out as:

* ``psum`` -- one ``all_reduce`` (latency-optimal);
* ``rs_ag`` -- a reduce-scatter then an all-gather, the ring's
  2(n-1)/n bytes per rank (``reduce_scatter_tensor`` and
  ``all_gather_into_tensor``, which NCCL and gloo both take);
* ``chunked_rs_ag`` -- the same split into ``overlap_chunks`` pieces by
  :func:`_split_sizes`; every piece's reduce-scatter is issued before any
  all-gather, as the reference pins its order;
* ``*_int8`` / ``*_fp8`` -- the same decompositions with the block-scaled
  1-byte wire of ``ops/quantized.py`` on both legs (fp32 reduction at the
  owning rank, Average's division before re-quantization);
* ``rs_ag_2d`` / ``chunked_rs_ag_2d`` (and their quantized forms) -- a
  reduce-scatter along each dim of the topology (``parallel/mesh.py``) in
  turn and the all-gathers back in reverse, each phase on the sub-group of
  one line of the torus; the sub-groups are made once, at ``init``;
* ``swing`` -- the distance-halving pairwise schedule (PAPERS.md arxiv
  2401.09356) over ``batch_isend_irecv``: log2(n) exchanges a direction,
  each block reduced at one owner and relayed verbatim, so every rank
  holds the same bits.

:func:`resolve_algorithm` picks per bucket with the reference's size
cutoffs (``auto``): below ``RS_AG_MIN_BYTES`` ``psum``, below
``CHUNKED_MIN_BYTES`` ``rs_ag``, above it ``chunked_rs_ag``; the ``_2d``
forms when the topology has two or more dims; the quantized forms when the
wire is ``int8`` or ``fp8``.

**Process sets.** The port's sets are real sub-groups of k ranks, where
the reference masks the full axis of the world. The port resolves and
counts on the set's own size k: ``swing`` runs when k is a power of two
(else ``psum``), the chunk geometry splits over k, and the wire-byte
counters are the reference's formulas at k. The ``_2d`` lowerings need the
world's torus, so a subset set runs their 1-D base. The values are the
reference's member rows either way (the sum of the members' values); only
the order of the fp32 additions differs.

NCCL runs one communicator's work in issue order on one stream, so the
chunks of ``chunked_rs_ag`` do not overlap with each other there;
``tools/torch_collective_bench.py`` measures what a second communicator
for the all-gather legs would give. The reference's
``enable_latency_hiding`` sets XLA flags and has no counterpart here.

**Backward taps** (:func:`make_grad_sync_tap`, :func:`tap_params`, used by
``hvd.grad(overlap=True)``): an identity on a tree of tensors whose
backward allreduces the tree's gradient as an in-step collective, the
moment the backward produces it.

Each lowering returns ``(works, finish)``: the work to wait for and the
function that returns the reduced buffer after it. Dependent legs are
chained with ``work.wait()``, which on NCCL makes the caller's device
stream wait and leaves the host free, except the two legs of
``chunked_rs_ag`` on one NCCL communicator, which its stream already runs
in order. The quantized lowerings reduce between their legs on the
caller's stream, so that stream waits for each first leg.
"""

from __future__ import annotations

import functools
import logging
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch import metrics as _metrics
from horovod_tpu_torch.ops import quantized as _q

__all__ = [
    "ALGORITHMS", "WIRES", "QUANT_WIRES", "DEFAULT_CHUNKS",
    "RS_AG_MIN_BYTES", "CHUNKED_MIN_BYTES", "resolve_algorithm",
    "parse_algorithm", "compose_algorithm", "wire_bytes",
    "wire_bytes_by_phase", "chunked_rs_ag", "chunked_rs_ag_quantized",
    "chunked_rs_ag_2d", "chunked_rs_ag_2d_quantized", "swing",
    "make_grad_sync_tap", "tap_params",
]

log = logging.getLogger("horovod_tpu_torch")

#: the ``algorithm=`` axis of ``hvd.allreduce``
ALGORITHMS = ("auto", "psum", "rs_ag", "chunked_rs_ag",
              "rs_ag_int8", "chunked_rs_ag_int8",
              "rs_ag_fp8", "chunked_rs_ag_fp8",
              "rs_ag_2d", "chunked_rs_ag_2d",
              "rs_ag_2d_int8", "chunked_rs_ag_2d_int8",
              "rs_ag_2d_fp8", "chunked_rs_ag_2d_fp8",
              "swing")

#: the ``HOROVOD_ALLREDUCE_WIRE`` axis: ``fp32`` keeps the bucket's dtype,
#: ``bf16`` casts it for the collective and back, ``int8`` / ``fp8`` make
#: ``auto`` pick the quantized lowerings.
WIRES = ("fp32", "bf16", "int8", "fp8")

#: wire formats that restructure the reduction
QUANT_WIRES = ("int8", "fp8")

# ``auto``'s size cutoffs per bucket, the reference's.
RS_AG_MIN_BYTES = 4 * 1024 * 1024
CHUNKED_MIN_BYTES = 32 * 1024 * 1024

#: default chunk count of the ``chunked_*`` lowerings
#: (``HOROVOD_OVERLAP_CHUNKS``)
DEFAULT_CHUNKS = 4

_RS_SINGLE = getattr(dist, "reduce_scatter_single",
                     dist.reduce_scatter_tensor)


def parse_algorithm(algorithm: str):
    """``"chunked_rs_ag_int8" -> ("chunked_rs_ag", "int8")``; names
    without a quantized wire give ``(name, None)``."""
    for w in QUANT_WIRES:
        if algorithm.endswith("_" + w):
            return algorithm[: -len(w) - 1], w
    return algorithm, None


def compose_algorithm(base: str, wire) -> str:
    """Attach a quantized wire to a base name; ``fp32``, ``bf16`` and
    None leave it as is, and ``psum`` and ``swing`` stay exact."""
    if wire not in QUANT_WIRES or base in ("psum", "swing"):
        return base
    return f"{base}_{wire}"


def _reject_algorithm(requested: str, knob: Optional[str] = None) -> None:
    """Raise the rejection error, naming the composed form received and
    the knob that set it."""
    knobs = knob or ("algorithm= / HOROVOD_ALLREDUCE_ALGORITHM")
    base, qw = parse_algorithm(requested)
    if qw is not None and base in ALGORITHMS:
        raise ValueError(
            f"allreduce algorithm {requested!r} (base {base!r} composed "
            f"with wire={qw!r}) has no quantized lowering: {base!r} is "
            f"exact by construction. Drop the wire "
            f"(wire= / HOROVOD_ALLREDUCE_WIRE) or pick an rs_ag-family "
            f"base via {knobs}.")
    raise ValueError(
        f"unknown allreduce algorithm {requested!r} (set via {knobs}); "
        f"expected one of {ALGORITHMS} — quantized variants compose as "
        f"<base>_int8 / <base>_fp8.")


def _torus_ndims(topology) -> int:
    """Number of dims above 1 (``None`` or a ring: 1)."""
    if not topology:
        return 1
    return max(1, sum(1 for d in topology if int(d) > 1))


def resolve_algorithm(requested: str, nbytes: int, op: int, world: int,
                      reducible: bool, wire: Optional[str] = None,
                      topology: Optional[Tuple[int, ...]] = None,
                      knob: Optional[str] = None) -> str:
    """The lowering of one bucket of ``nbytes`` over ``world`` ranks.

    Ops other than Sum and Average (``reducible`` False) and a world of
    one take ``psum``. An explicit request wins, degraded where the
    fabric cannot carry it (``swing`` on a world that is not a power of
    two runs ``psum``, a ``_2d`` form on a ring runs its 1-D base);
    ``auto`` picks by size, takes the ``_2d`` forms on a topology of two
    or more dims and the quantized forms under an ``int8``/``fp8``
    ``wire``."""
    if requested not in ALGORITHMS:
        _reject_algorithm(requested, knob)
    if not reducible or world <= 1:
        return "psum"
    ndims = _torus_ndims(topology)
    if requested != "auto":
        if requested == "swing" and (world & (world - 1)):
            log.debug("swing needs a power-of-two world (have %d); "
                      "falling back to psum", world)
            return "psum"
        base, qw = parse_algorithm(requested)
        if base.endswith("_2d") and ndims < 2:
            return compose_algorithm(base[:-3], qw)
        return requested
    if nbytes >= CHUNKED_MIN_BYTES:
        return compose_algorithm(
            "chunked_rs_ag_2d" if ndims >= 2 else "chunked_rs_ag", wire)
    if nbytes >= RS_AG_MIN_BYTES:
        return compose_algorithm(
            "rs_ag_2d" if ndims >= 2 else "rs_ag", wire)
    return "psum"


def _split_sizes(m: int, n: int, chunks: int) -> Tuple[int, int]:
    """(per_chunk, n_chunks) for an m-element buffer over n ranks: every
    chunk is a multiple of n and no chunk is all padding."""
    chunks = max(1, int(chunks))
    chunks = min(chunks, max(1, -(-m // n)))
    per = -(-m // chunks)
    per = -(-per // n) * n
    return per, chunks


def wire_bytes(nelems: int, wire: str, elem_bytes: int = 4) -> int:
    """Bytes a bucket of ``nelems`` puts on the wire per traversal under
    ``wire``: the 1-byte payload plus its fp32 scales for the quantized
    wires, 2 a value for ``bf16``/``fp16``, else ``elem_bytes``. The ring
    factor 2(n-1)/n is left out, so ratios between wires are exact."""
    if wire in QUANT_WIRES:
        return nelems + _q.wire_overhead_bytes(nelems)
    if wire == "bf16" or wire == "fp16":
        return 2 * nelems
    return elem_bytes * nelems


def wire_bytes_by_phase(base: str, nelems: int, wire: str, world: int,
                        dims: Optional[Tuple[int, ...]] = None,
                        elem_bytes: int = 4) -> dict:
    """``{phase: bytes}`` of one traversal of an ``nelems`` bucket under
    ``base`` (wire suffix stripped): ``all`` for ``psum``; ``rs`` and
    ``ag`` for the 1-D decompositions and ``swing``; ``rs_d<j>`` and
    ``ag_d<j>`` for each dim of a ``_2d`` lowering, the payload shrinking
    by each dim's extent."""
    if base in ("psum", "auto"):
        return {"all": wire_bytes(nelems, wire, elem_bytes)}
    if base == "swing":
        c = -(-nelems // max(world, 1))
        legs = c * max(world - 1, 1)
        return {"rs": wire_bytes(legs, wire, elem_bytes),
                "ag": wire_bytes(legs, wire, elem_bytes)}
    if base.endswith("_2d"):
        ds = tuple(int(d) for d in (dims or ()) if int(d) > 1)
        if len(ds) < 2:
            ds = (world,)
        sizes, m = [], nelems
        for d in ds:
            sizes.append(m)
            m = -(-m // d)
        out = {f"rs_d{j}": wire_bytes(sizes[j], wire, elem_bytes)
               for j in range(len(ds))}
        for j in range(len(ds) - 1, -1, -1):
            out[f"ag_d{j}"] = wire_bytes(sizes[j], wire, elem_bytes)
        return out
    return {"rs": wire_bytes(nelems, wire, elem_bytes),
            "ag": wire_bytes(nelems, wire, elem_bytes)}


def torus_lines(dims: Sequence[int]) -> List[List[List[int]]]:
    """Entry j: the ranks of every line along dim j of a row-major torus
    (other coordinates fixed, coordinate j increasing); the sub-groups of
    the ``_2d`` phases. The reference's ``mesh.torus_groups``."""
    dims = tuple(int(d) for d in dims)
    ranks = np.arange(int(np.prod(dims))).reshape(dims)
    out = []
    for j in range(len(dims)):
        moved = np.moveaxis(ranks, j, -1).reshape(-1, dims[j])
        out.append([[int(r) for r in row] for row in moved])
    return out


Lowered = Tuple[List, Callable[[], torch.Tensor]]


def _pad_to(x: torch.Tensor, total: int) -> torch.Tensor:
    m = x.numel()
    return x if total == m else torch.cat([x, x.new_zeros(total - m)])


def _observe_chunks(nbytes: int, chunks: int) -> None:
    h = _metrics.histogram("allreduce_chunk_bytes",
                           buckets=_metrics.SIZE_BUCKETS)
    for _ in range(chunks):
        h.observe(nbytes)


def chunked_rs_ag(x: torch.Tensor, group, n: int,
                  chunks: int = DEFAULT_CHUNKS) -> Lowered:
    """Sum-allreduce a 1-D buffer as ``chunks`` reduce-scatter +
    all-gather pairs over the ``n`` ranks of ``group`` (``chunks=1`` is
    ``rs_ag``)."""
    m = x.numel()
    if m == 0 or n <= 1:
        return [], lambda: x
    per, chunks = _split_sizes(m, n, chunks)
    x = _pad_to(x, per * chunks)
    _observe_chunks(per * x.element_size(), chunks)
    scattered, rs_works = [], []
    for i in range(chunks):
        out = x.new_empty(per // n)
        rs_works.append(_RS_SINGLE(out, x[i * per:(i + 1) * per],
                                   group=group, async_op=True))
        scattered.append(out)
    # One NCCL communicator runs its work in issue order on one stream, so
    # an all-gather on it needs no wait for its reduce-scatter; a wait
    # there would hold the caller's stream (the backward's compute, under
    # overlap) until the reduce-scatter ends. gloo's worker threads do not
    # keep the order.
    ordered = dist.get_backend(group) == "nccl"
    gathered, works = [], []
    for w, part in zip(rs_works, scattered):
        if not ordered:
            w.wait()
        full = x.new_empty(per)
        works.append(_q.ALL_GATHER_SINGLE(full, part, group=group,
                                          async_op=True))
        gathered.append(full)

    def finish():
        out = gathered[0] if chunks == 1 else torch.cat(gathered)
        return out[:m]
    return works, finish


def chunked_rs_ag_quantized(x: torch.Tensor, group, n: int, chunks: int,
                            wire: str, mean_k: Optional[float] = None
                            ) -> Lowered:
    """:func:`chunked_rs_ag` with the quantized wire (fp32 buffer): each
    chunk's rows (one BLOCK-aligned row per rank) are quantized and
    exchanged all-to-all, reduced in fp32 at their owner, divided by
    ``mean_k`` (Average), re-quantized and all-gathered
    (``ops/quantized.issue_quantized_allreduce``). One rank reduces
    nothing and quantizes nothing."""
    if x.dtype != torch.float32:
        raise ValueError("quantized rs+ag reduces in fp32; cast the "
                         f"buffer first (got {x.dtype})")
    m = x.numel()
    if m == 0 or n <= 1:
        return [], lambda: (_q.true_div(x, mean_k)
                            if mean_k is not None and m else x)
    per, chunks = _split_sizes(m, n * _q.BLOCK, chunks)
    _observe_chunks(wire_bytes(per, wire), chunks)
    return _q.issue_quantized_allreduce(x, group, n, wire, mean_k, per,
                                        chunks)


def chunked_rs_ag_2d(x: torch.Tensor, phases: Sequence[Tuple[object, int]],
                     n: int, chunks: int = DEFAULT_CHUNKS) -> Lowered:
    """Sum-allreduce a 1-D buffer over the torus whose lines through this
    rank are ``phases`` (``(group, extent)`` per dim, product ``n``):
    reduce-scatter along dim 0, 1, ... and all-gather back in reverse,
    pipelined over ``chunks``."""
    m = x.numel()
    if m == 0 or n <= 1:
        return [], lambda: x
    per, chunks = _split_sizes(m, n, chunks)
    x = _pad_to(x, per * chunks)
    _observe_chunks(per * x.element_size(), chunks)
    gathered, works = [], []
    for i in range(chunks):
        cur = x[i * per:(i + 1) * per]
        for g, d in phases:
            out = cur.new_empty(cur.numel() // d)
            _RS_SINGLE(out, cur, group=g, async_op=True).wait()
            cur = out
        for j in range(len(phases) - 1, -1, -1):
            g, d = phases[j]
            full = cur.new_empty(cur.numel() * d)
            w = _q.ALL_GATHER_SINGLE(full, cur, group=g, async_op=True)
            if j:
                w.wait()
            else:
                works.append(w)
            cur = full
        gathered.append(cur)

    def finish():
        return (gathered[0] if chunks == 1 else torch.cat(gathered))[:m]
    return works, finish


def chunked_rs_ag_2d_quantized(x: torch.Tensor,
                               phases: Sequence[Tuple[object, int]], n: int,
                               chunks: int, wire: str,
                               mean_k: Optional[float] = None) -> Lowered:
    """:func:`chunked_rs_ag_2d` with the quantized wire: every
    reduce-scatter phase exchanges freshly quantized partials all-to-all
    and reduces them in fp32; after the last phase the owned block is
    divided by ``mean_k`` and quantized once, and the all-gather phases
    relay those same bytes, so every rank dequantizes identical codes."""
    if x.dtype != torch.float32:
        raise ValueError("quantized rs+ag reduces in fp32; cast the "
                         f"buffer first (got {x.dtype})")
    m = x.numel()
    if m == 0 or n <= 1:
        return [], lambda: (_q.true_div(x, mean_k)
                            if mean_k is not None and m else x)
    per, chunks = _split_sizes(m, n * _q.BLOCK, chunks)
    x = _pad_to(x, per * chunks)
    wbytes = sum(wire_bytes_by_phase("rs_ag_2d", per, wire, n,
                                     dims=tuple(d for _, d in phases))
                 .values())
    _observe_chunks(wbytes, chunks)
    gathered, works = [], []
    for i in range(chunks):
        cur = x[i * per:(i + 1) * per]
        for g, d in phases:
            ws, q_recv, s_recv = _q.alltoall_codes(
                *_q.quantize_blocks(cur.view(d, -1), wire), g)
            for w in ws:
                w.wait()
            cur = _q.reduce_rows(q_recv, s_recv)
        if mean_k is not None:
            cur = _q.true_div(cur, mean_k)
        q, s = _q.quantize_blocks(cur, wire)
        for j in range(len(phases) - 1, -1, -1):
            g, d = phases[j]
            ws, q, s = _q.allgather_codes(q, s, d, g)
            if j:
                for w in ws:
                    w.wait()
            else:
                works.extend(ws)
        gathered.append((q, s))

    def finish():
        outs = [_q.dequantize_blocks(q, s) for q, s in gathered]
        return (outs[0] if chunks == 1 else torch.cat(outs))[:m]
    return works, finish


# ---------------------------------------------------------------------------
# Swing: the distance-halving schedule for latency-bound buckets
# ---------------------------------------------------------------------------

def _swing_schedule(world: int):
    """The reference's static Swing tables on ``world`` (a power of two)
    ranks: ``(k, perms, keep, send)``. Step s pairs rank r with
    ``r +/- rho_s`` (``rho_s = (1 - (-2)^(s+1)) / 3``); ``keep[s][r]`` /
    ``send[s][r]`` are the block rows rank r keeps / sends at
    reduce-scatter step s, built backward from the final owner
    ``b(r) = r``, so each block is reduced by one association tree at one
    owner and the all-gather relays it verbatim."""
    return _swing_schedule_cached(int(world))


@functools.lru_cache(maxsize=None)
def _swing_schedule_cached(n: int):
    k = n.bit_length() - 1
    if n < 2 or (1 << k) != n:
        raise ValueError(f"swing requires a power-of-two world, got {n}")
    partners = []
    for s in range(k):
        rho = (1 - (-2) ** (s + 1)) // 3
        p = [(r + rho) % n if r % 2 == 0 else (r - rho) % n
             for r in range(n)]
        for r in range(n):
            if p[p[r]] != r or p[r] == r:
                raise AssertionError(f"swing pairing at step {s}, rank {r}")
        partners.append(p)
    T = [[None] * n for _ in range(k + 1)]
    for r in range(n):
        T[k][r] = {r}
    for s in range(k - 1, -1, -1):
        for r in range(n):
            mine, other = T[s + 1][r], T[s + 1][partners[s][r]]
            if mine & other:
                raise AssertionError(
                    f"swing schedule overlap at step {s}, rank {r}")
            T[s][r] = mine | other
    keep = tuple(np.array([sorted(T[s + 1][r]) for r in range(n)],
                          np.int32) for s in range(k))
    send = tuple(np.array([sorted(T[s + 1][partners[s][r]])
                           for r in range(n)], np.int32)
                 for s in range(k))
    perms = tuple(tuple((r, partners[s][r]) for r in range(n))
                  for s in range(k))
    return k, perms, keep, send


def swing(x: torch.Tensor, group, ranks: Sequence[int], me: int
          ) -> Lowered:
    """Sum-allreduce a 1-D buffer over the members ``ranks`` (global
    ranks, a power of two of them; this rank is ``ranks[me]``) with the
    Swing schedule. Bit-identical on every member."""
    from horovod_tpu_torch.adasum import _swap
    n = len(ranks)
    m = x.numel()
    if m == 0 or n <= 1:
        return [], lambda: x
    k, perms, keep, send = _swing_schedule(n)
    c = -(-m // n)
    total = c * n
    blocks = _pad_to(x, total).reshape(n, c).clone()
    _observe_chunks(total * x.element_size(), 1)
    idx = [(torch.as_tensor(keep[s][me], device=x.device, dtype=torch.long),
            torch.as_tensor(send[s][me], device=x.device, dtype=torch.long))
           for s in range(k)]
    for s in range(k):
        peer = ranks[perms[s][me][1]]
        krows, srows = idx[s]
        recv = _swap(blocks.index_select(0, srows), peer, group)
        blocks[krows] = blocks.index_select(0, krows) + recv
    for s in range(k - 1, -1, -1):
        peer = ranks[perms[s][me][1]]
        krows, srows = idx[s]
        blocks[srows] = _swap(blocks.index_select(0, krows), peer, group)
    return [], lambda: blocks.reshape(total)[:m]


# ---------------------------------------------------------------------------
# backward taps: collectives inside the backward pass
# ---------------------------------------------------------------------------

class _GradSyncTap(torch.autograd.Function):
    """Identity in the forward; the backward reduces the cotangents of all
    its inputs as one in-step allreduce."""

    @staticmethod
    def forward(ctx, sync, *xs):
        ctx.sync = sync
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *cts):
        return (None,) + tuple(ctx.sync(list(cts)))


def make_grad_sync_tap(**allreduce_kwargs) -> Callable:
    """An identity on a tree of tensors whose backward allreduces the
    tree's gradient (``hvd.allreduce(**allreduce_kwargs)``: ``op``,
    ``process_set``, ``prescale_factor``, ``postscale_factor``,
    ``compression``, ``fusion_threshold_bytes``, ``algorithm``,
    ``overlap_chunks``, ``wire``).

    Apply it to a parameter (sub)tree before the forward uses it: the
    forward is untouched, and in the backward the group's gradient is
    reduced the moment it is produced, long before the first layers finish
    theirs. The reduction is an in-step allreduce
    (``collective._in_step_allreduce_async``), the reference's in-program
    psum: it takes no negotiation round. The reference's tap is an
    identity outside an SPMD context; the port's world of one process per
    GPU is that context, so the tap reduces whenever ``hvd`` is
    initialised."""
    from horovod_tpu_torch import collective as C
    from horovod_tpu_torch import core
    from horovod_tpu_torch.checkpoint_sharded import (_flatten_with_keys,
                                                      _unflatten_like)
    from horovod_tpu_torch.compression import Compression
    kw = dict(allreduce_kwargs)
    op = kw.pop("op", C.Average)
    ps = kw.pop("process_set", None)
    pre = float(kw.pop("prescale_factor", 1.0))
    post = float(kw.pop("postscale_factor", 1.0))
    comp = kw.pop("compression", Compression.none)
    threshold = kw.pop("fusion_threshold_bytes", None)
    alg, chunks, wire = C._resolve_axis(kw.pop("algorithm", None),
                                        kw.pop("overlap_chunks", None),
                                        kw.pop("wire", None))
    if kw:
        raise TypeError(f"unexpected allreduce arguments {sorted(kw)}")
    C._check_reduce(op, pre, post, comp)

    def sync(cts):
        if not core.is_initialized():
            return cts
        return C._in_step_allreduce_async(
            cts, op, C._resolve_ps(ps), name="grad_sync_tap", prescale=pre,
            postscale=post, compression=comp, threshold=threshold,
            algorithm=alg, chunks=chunks, wire=wire).synchronize()

    def tap(tree):
        leaves = dict(_flatten_with_keys(tree))
        keys = [k for k, x in leaves.items()
                if isinstance(x, torch.Tensor) and x.is_floating_point()]
        if not keys:
            return tree
        leaves.update(zip(keys, _GradSyncTap.apply(
            sync, *[leaves[k] for k in keys])))
        return _unflatten_like(tree, leaves)

    return tap


def tap_params(params, **allreduce_kwargs):
    """Tap the floating leaves of ``params`` with gradient-sync identities
    (:func:`make_grad_sync_tap`), one per bucket: the leaves in the tree's
    own order (``named_parameters()``' registration order, so a bucket's
    gradients are produced together), cut into buckets of at most
    ``fusion_threshold_bytes`` (``HOROVOD_FUSION_THRESHOLD`` by default).
    Each bucket's backward collective goes out as soon as its gradients
    are complete, in reverse production order, with no end-of-backward
    barrier. The reference taps each top-level group and leaves the
    bucketing of its psums to XLA's combiner; a flat
    ``dict(model.named_parameters())`` would otherwise cost one
    collective per tensor. Used by ``hvd.grad(..., overlap=True)``."""
    from horovod_tpu_torch.config import get_config
    from horovod_tpu_torch.elastic.state import _tree_map
    threshold = allreduce_kwargs.get("fusion_threshold_bytes")
    if threshold is None:
        threshold = get_config().fusion_threshold_bytes
    tap = make_grad_sync_tap(**allreduce_kwargs)
    leaves: List = []
    _tree_map(leaves.append, params)
    buckets, size = [[]], 0
    for i, x in enumerate(leaves):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            continue
        nbytes = x.numel() * x.element_size()
        if buckets[-1] and size + nbytes > threshold:
            buckets.append([])
            size = 0
        buckets[-1].append(i)
        size += nbytes
    for idx in buckets:
        if idx:
            for i, y in zip(idx, tap([leaves[i] for i in idx])):
                leaves[i] = y
    it = iter(leaves)
    return _tree_map(lambda _: next(it), params)
