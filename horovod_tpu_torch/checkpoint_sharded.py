"""Async sharded checkpointing: lose seconds, not epochs.

Port of ``horovod_tpu/checkpoint_sharded.py``. A lost GPU must cost the
job the seconds since the last durable snapshot, not everything since the
last synchronous full save: every rank writes only the shards it owns,
off the training thread, and a manifest stitches the shards into one
restorable step.

Mechanics, as in the reference:

* **Shard-major layout** -- the unit of persistence is a tree (nested
  dicts, lists and tuples) whose tensor leaves have leading dimension
  ``num_shards``: shard ``s`` of every leaf belongs to rank ``s``.
* **Async writer** -- :meth:`ShardedCheckpointManager.save` starts the
  device-to-host copies and returns; a background thread writes the
  files. On the card the copies go into pinned host buffers on a side
  CUDA stream, behind an event recorded on the caller's stream, and the
  writer waits on the copies' own event (the reference's
  ``copy_to_host_async`` contract). At most ``max_pending`` saves are in
  flight: a further ``save()`` waits for the writer and says so in a log
  line, so unwritten snapshots cannot pile up host memory.
* **Two-phase commit** -- phase 1: every rank writes its shard files (tmp
  + atomic rename) plus a per-rank ``.ok`` receipt salted with the elastic
  attempt; phase 2: rank 0's writer waits for all receipts (a filesystem
  barrier) and publishes ``manifest-<step>.json`` atomically. A restore
  only reads manifests, so an unpublished step is invisible to
  ``latest_step()`` and a *requested* torn step raises
  :class:`TornCheckpointError`.
* **N->M resharding** -- restore re-chunks ``(n, c)`` leaves for ``m``
  shards (stripped to their recorded unpadded length); ``(n,)`` counters
  collapse to their max and refill.

The on-disk format is the reference's, byte for byte: ``np.savez`` shard
files keyed by ``jax.tree_util.keystr`` strings (``['opt_state']['mu']``;
plain dicts in sorted key order, ``OrderedDict`` in its own), the same
receipt and manifest JSON. A step written by either package restores in
the other. numpy has no bfloat16: a bf16 tensor travels as its raw 16-bit
words (numpy ``|V2``, what numpy writes for the reference's bf16 arrays)
and its manifest leaf says ``"dtype": "bfloat16"``.

``save_state`` / ``adopt_state`` bridge an elastic ``TorchState`` or
``TensorState``: its last commit goes down the replicated path (rank 0's
``replicated.npz``), its attributes and the commit's container skeleton
(keys, non-tensor values such as AdamW's ``param_groups``) into the
manifest's ``meta``, so a fresh process rebuilds the commit from the
manifest alone.

**ZeRO-1** (``optimizer_sharded.py``). A ``ShardedAdamWState`` in the port
is this rank's row; ``pack_opt_state`` gives it as the one shard the rank
owns, and ``save(..., num_shards=n, owned=[rank])`` takes such per-rank
rows. The files are the reference's: shard s of ``['opt_state']['mu']`` is
rank s's ``(c,)`` row, the manifest records the unpadded length, and
``(n,)`` step counters collapse to their max on an N->M restore, so a
ZeRO-1 step written by either package restores in the other at any N->M.
``unpack_opt_state(..., rank=r)`` takes rank r's row of a restore;
``reshard_opt_state`` first gathers the rows over the old set, because no
rank holds them all. In ``save_state`` / ``adopt_state`` a committed
``ShardedAdamWState`` goes down the shard path: every rank writes its row,
and every rank adopts together, each taking its row of the manifest
resharded for the current world (a newer in-memory commit is kept only
where every rank still holds the row it committed in this world). The
port has no
``ErrorFeedbackState`` (error feedback lives in ``DistributedOptimizer``),
so ``info["error_feedback"]`` is always false, and a reference step saved
with that wrapper restores without it.

Instrumented as the reference: ``checkpoint_save_seconds{kind=shard}``,
``checkpoint_restore_seconds{kind=shard}``, ``checkpoint_publish_seconds``,
``checkpoint_bytes_total{kind=shard|full}``,
``checkpoint_interval_seconds{kind=shard}``, ``checkpoint_last_step``,
``checkpoint_pending_saves`` and timeline ``CHECKPOINT`` markers; and
``checkpoint_save_hold_seconds``, how long ``save()`` held its caller.
The writer honours the ``slow_write`` fault (``faults.py``).
"""

from __future__ import annotations

import glob
import json
import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "ShardedCheckpointManager", "Restored", "TornCheckpointError",
    "owned_shards", "save_state", "adopt_state", "stash_failure_stamp",
    "pack_opt_state", "unpack_opt_state", "reshard_opt_state",
]

logger = logging.getLogger("horovod_tpu_torch")

_OK_POLL_S = 0.05
_ALIGN = 64          # byte alignment of each leaf in a pinned staging buffer


class TornCheckpointError(RuntimeError):
    """A step directory exists but its manifest was never published (the
    job died between phase 1 and phase 2): restoring it would resurrect a
    torn step, so it fails loudly instead."""


class Restored(NamedTuple):
    step: int
    shards: Any          # tree (or {keystr: tensor} without a template)
    replicated: Any
    meta: Dict[str, Any]
    manifest: Dict[str, Any]


def _step_dirname(step: int) -> str:
    return f"step-{step:08d}"


def _manifest_name(step: int) -> str:
    return f"manifest-{step:08d}.json"


def _shard_filename(s: int, num_shards: int) -> str:
    return f"shard-{s:05d}-of-{num_shards:05d}.npz"


# ---------------------------------------------------------------------------
# key paths: jax.tree_util.keystr of the same nested containers
# ---------------------------------------------------------------------------

def _children(node):
    """[(key-path element, child)] of a container, None for a leaf. Plain
    dicts go in sorted key order and ``OrderedDict`` in its own, as jax
    flattens them; None is an empty subtree."""
    if isinstance(node, OrderedDict):
        return [(f"[{k!r}]", v) for k, v in node.items()]
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def _flatten_with_keys(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """-> [(keystr, leaf)], the strings ``jax.tree_util.keystr`` gives the
    same nested dicts, lists and tuples."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in kids:
        out += _flatten_with_keys(v, prefix + k)
    return out


def _build_like(node, prefix: str, flat_dict: Dict[str, torch.Tensor]):
    """:func:`_unflatten_like`'s recursion. A module-level function: a
    recursive closure would sit in a reference cycle with ``flat_dict``
    and keep its tensors alive until the garbage collector runs."""
    kids = _children(node)
    if node is None:
        return None
    if kids is None:
        a = flat_dict[prefix]
        dtype = getattr(node, "dtype", None)
        if isinstance(dtype, torch.dtype) and a.dtype != dtype:
            a = a.to(dtype)
        return a
    if isinstance(node, dict):
        out = type(node)() if isinstance(node, OrderedDict) else {}
        for k, v in (node.items() if isinstance(node, OrderedDict)
                     else ((k, node[k]) for k in sorted(node))):
            out[k] = _build_like(v, prefix + f"[{k!r}]", flat_dict)
        return out
    items = [_build_like(v, prefix + f"[{i}]", flat_dict)
             for i, v in enumerate(node)]
    return tuple(items) if isinstance(node, tuple) else items


def _unflatten_like(template, flat_dict: Dict[str, torch.Tensor]):
    """Rebuild ``template``'s structure from ``{keystr: tensor}``, each
    leaf cast to the template leaf's dtype (keys must match exactly)."""
    keys = [k for k, _ in _flatten_with_keys(template)]
    missing = sorted(set(keys) - set(flat_dict))
    extra = sorted(set(flat_dict) - set(keys))
    if missing or extra:
        raise KeyError(
            f"checkpoint does not match the template: missing leaves "
            f"{missing}, unexpected leaves {extra}")
    return _build_like(template, "", flat_dict)


# ---------------------------------------------------------------------------
# tensors <-> npz arrays
# ---------------------------------------------------------------------------

def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return ("bfloat16" if t.dtype == torch.bfloat16
                else str(t.dtype).replace("torch.", ""))
    return str(np.asarray(t).dtype)


def _to_numpy(t) -> np.ndarray:
    """A host tensor or array as the array ``np.savez`` writes: bf16 as its
    raw 16-bit words (``|V2``), never through a float cast."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2")
        return t.contiguous().numpy()
    return np.asarray(t)


def _to_tensor(a: np.ndarray, dtype_name: Optional[str] = None
               ) -> torch.Tensor:
    """An array read from a shard file as a CPU tensor; bf16 (by the
    manifest's dtype, or numpy's ``|V2``) from its raw 16-bit words."""
    a = np.require(a, requirements="C")     # keeps 0-d arrays 0-d
    if dtype_name == "bfloat16" or a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _world() -> Tuple[int, int]:
    from horovod_tpu_torch import core
    if core.is_initialized():
        return core.size(), core.rank()
    return 1, 0


def owned_shards(num_shards: int) -> List[int]:
    """Which shard ids this process durably owns: shards round-robin over
    the ranks (one device per process, so shard ``s`` of a world-sized
    layout is rank ``s``'s)."""
    nproc, pid = _world()
    if nproc == 1:
        return list(range(num_shards))
    return [s for s in range(num_shards) if s % nproc == pid]


def _coerce_mesh(mesh, num_shards: int) -> Optional[Tuple[int, int]]:
    """Normalize a ``mesh=`` argument -- ``"dpXxmpY"`` string or ``(dp,
    mp)`` tuple -- against a shard count. ``None`` defaults to the dp-only
    factoring."""
    if mesh is None:
        return (int(num_shards), 1) if num_shards else None
    if isinstance(mesh, str):
        from horovod_tpu_torch.parallel.mesh import parse_mesh
        dp, mp = parse_mesh(mesh)
    else:
        dp, mp = int(mesh[0]), int(mesh[1])
    if num_shards and dp * mp != int(num_shards):
        raise ValueError(
            f"mesh dp{dp}xmp{mp} describes {dp * mp} shards but the "
            f"checkpoint has num_shards={num_shards}; the mesh must "
            f"factor the shard count exactly")
    return (dp, mp)


class _Staging:
    """Pinned host buffers for the device-to-host snapshots: one flat
    buffer per in-flight save, reused across saves (pinning costs about a
    second a GiB, so it is paid once per buffer)."""

    def __init__(self):
        self._free: List[torch.Tensor] = []
        self._lock = threading.Lock()

    def take(self, nbytes: int) -> torch.Tensor:
        with self._lock:
            for i, b in enumerate(self._free):
                if b.numel() >= nbytes:
                    return self._free.pop(i)
            # none fits: drop one that is too small, so the pool stays
            # bounded by the number of in-flight saves
            if self._free:
                self._free.pop(0)
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def give(self, buf: torch.Tensor) -> None:
        with self._lock:
            self._free.append(buf)


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


class _SaveJob(NamedTuple):
    step: int
    parts: Dict[int, List[Tuple[str, Any]]]   # shard id -> [(key, host)]
    replicated: Optional[List[Tuple[str, Any]]]   # None: not rank 0
    meta: Dict[str, Any]
    unpadded: Dict[str, int]
    num_shards: int
    num_ranks: int
    rank: int
    attempt: int                  # elastic restart count (receipt salt)
    enqueued_at: float
    mesh: Optional[Tuple[int, int]]
    copied: Optional[torch.cuda.Event]    # device-to-host copies done
    staging: Optional[torch.Tensor]       # pinned buffer to hand back
    sources: Any                          # device tensors, alive to copied


class ShardedCheckpointManager:
    """Per-rank shard files + an atomically published manifest.

    ``directory`` must be shared by all ranks. One background writer
    thread per manager keeps every save's file IO off the training
    thread; ``max_pending`` bounds the saves in flight (their host
    snapshots).
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 publish_timeout_s: float = 120.0, max_pending: int = 2):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max(1, int(max_to_keep))
        self.publish_timeout_s = float(publish_timeout_s)
        self.max_pending = max(1, int(max_pending))
        os.makedirs(self.directory, exist_ok=True)
        self._jobs: List[Optional[_SaveJob]] = []
        self._cv = threading.Condition()
        self._inflight = 0            # enqueued and not yet written
        self._error: Optional[BaseException] = None
        self._last_publish_wall: Optional[float] = None
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stage = _Staging()
        self._streams: Dict[int, torch.cuda.Stream] = {}

    # -- save ------------------------------------------------------------

    def save(self, step: int, shards=None, replicated=None,
             meta: Optional[Dict[str, Any]] = None, *,
             unpadded: Optional[Dict[str, int]] = None,
             num_shards: Optional[int] = None,
             owned: Optional[List[int]] = None,
             mesh=None,
             wait: bool = False) -> None:
        """Snapshot ``shards`` (shard-major tree: every tensor leaf is
        ``(num_shards, ...)``) and ``replicated`` (any tree; written by rank
        0 only) for ``step``, asynchronously. ``owned`` (with
        ``num_shards``) names the shards this rank writes, and each leaf
        then holds exactly those shards in ``owned``'s order (leading dim
        ``len(owned)``): a rank's ZeRO-1 row from :func:`pack_opt_state`,
        which no rank holds for the whole world. Without it the rank
        writes the shards :func:`owned_shards` gives it.

        ``meta`` is a JSON-able dict published in the manifest.
        ``unpadded`` maps a shard leaf's key to its true flat length for
        N->M resharding. ``mesh`` (``"dpXxmpY"`` or ``(dp, mp)``; default
        dp-only) records the factoring behind the shards, cross-checked at
        publish. The caller's stream waits for the device-to-host copies
        before its next kernel, so the caller may change the tensors in
        place at once. ``wait=True`` blocks until the manifest is
        published (rank 0) / this rank's receipt is written.
        """
        flat: List[Tuple[str, Any]] = []
        if shards is not None:
            flat = _flatten_with_keys(shards)
        rep = (_flatten_with_keys(replicated)
               if replicated is not None else None)
        self._save_flat(step, flat, rep, meta, unpadded=unpadded,
                        num_shards=num_shards, owned=owned, mesh=mesh,
                        wait=wait)

    def _save_flat(self, step, flat, rep, meta, *, unpadded=None,
                   num_shards=None, owned=None, mesh=None, mutable=True,
                   wait=False) -> None:
        t0 = time.perf_counter()
        self._raise_pending()
        nproc, pid = _world()
        if owned is not None and num_shards is None:
            raise ValueError("save(owned=...) needs num_shards: the leaves "
                             "hold only the owned shards")
        if flat:
            for key, leaf in flat:
                if getattr(leaf, "ndim", 0) < 1:
                    raise ValueError(
                        f"shard leaf {key} is a scalar: shard-major "
                        f"leaves need a leading num_shards dimension")
            if num_shards is None:
                num_shards = int(flat[0][1].shape[0])
            lead = len(owned) if owned is not None else num_shards
            for key, leaf in flat:
                if int(leaf.shape[0]) != lead:
                    raise ValueError(
                        f"shard leaf {key} has leading dim "
                        f"{leaf.shape[0]} != {lead} (" + (
                            f"the owned shards {list(owned)}"
                            if owned is not None else "num_shards") + ")")
        elif num_shards is None:
            num_shards = 0       # a replicated/meta-only save
        own = list(owned) if owned is not None else owned_shards(num_shards)
        items: List[Tuple[Any, str, Any]] = []     # (slot, key, leaf)
        for j, s in enumerate(own):
            for key, leaf in flat:
                items.append((s, key, leaf[j if owned is not None else s]))
        if pid == 0 and rep is not None:
            for key, leaf in rep:
                items.append((None, key, leaf))
        waited = self._acquire_slot()
        try:
            host, copied, staging, sources = self._snapshot(items, mutable)
        except BaseException:
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()
            raise
        parts: Dict[int, List[Tuple[str, Any]]] = {s: [] for s in own}
        rep_host: Optional[List[Tuple[str, Any]]] = (
            [] if pid == 0 and rep is not None else None)
        for (slot, key, _), h in zip(items, host):
            (rep_host if slot is None else parts[slot]).append((key, h))
        job = _SaveJob(step=int(step), parts=parts, replicated=rep_host,
                       meta=dict(meta or {}), unpadded=dict(unpadded or {}),
                       num_shards=int(num_shards), num_ranks=nproc,
                       rank=pid,
                       attempt=int(os.environ.get(
                           "HVD_TPU_ELASTIC_RESTART", "0")),
                       enqueued_at=time.perf_counter(),
                       mesh=_coerce_mesh(mesh, int(num_shards)),
                       copied=copied, staging=staging, sources=sources)
        self._ensure_thread()
        with self._cv:
            self._jobs.append(job)
            self._cv.notify_all()
            pending = self._inflight
        from horovod_tpu_torch import metrics as _metrics
        _metrics.gauge("checkpoint_pending_saves").set(pending)
        _metrics.histogram("checkpoint_save_hold_seconds").observe(
            time.perf_counter() - t0)
        if waited > 0.001:
            logger.warning(
                "sharded checkpoint save(step=%s) waited %.3f s for the "
                "writer: max_pending=%d saves were in flight", step,
                waited, self.max_pending)
        if wait:
            self.wait()

    def _acquire_slot(self) -> float:
        """Take one of ``max_pending`` in-flight slots; returns how long it
        waited for the writer to free one."""
        t0 = time.perf_counter()
        with self._cv:
            while self._inflight >= self.max_pending and \
                    self._error is None:
                self._cv.wait(0.5)
            if self._error is None:
                self._inflight += 1
                return time.perf_counter() - t0
        self._raise_pending()
        raise AssertionError("unreachable")

    def _snapshot(self, items, mutable: bool):
        """Host copies of every leaf, started now. CUDA leaves go into one
        pinned buffer on a side stream behind an event of the caller's
        stream; returns (host leaves, copies-done event, pinned buffer,
        the device tensors to keep alive until the event)."""
        host: List[Any] = [None] * len(items)
        cuda = [i for i, (_, _, t) in enumerate(items)
                if isinstance(t, torch.Tensor) and t.is_cuda]
        on_card = set(cuda)
        for i, (_, _, t) in enumerate(items):
            if i in on_card:
                continue
            if isinstance(t, torch.Tensor):
                t = t.detach()
                host[i] = t.clone() if mutable else t
            else:
                host[i] = np.array(t) if mutable else np.asarray(t)
        if not cuda:
            return host, None, None, None
        dev = items[cuda[0]][2].device
        sizes = [_aligned(items[i][2].numel() * items[i][2].element_size())
                 for i in cuda]
        buf = self._stage.take(max(1, sum(sizes)))
        stream = self._streams.get(dev.index)
        if stream is None:
            stream = self._streams[dev.index] = torch.cuda.Stream(dev)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
        sources = []
        off = 0
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            for i, n in zip(cuda, sizes):
                t = items[i][2].detach()
                nbytes = t.numel() * t.element_size()
                view = buf[off:off + nbytes].view(t.dtype).view(t.shape)
                view.copy_(t, non_blocking=True)
                host[i] = view
                sources.append(t)
                off += n
            copied = torch.cuda.Event()
            copied.record(stream)
        if mutable:
            torch.cuda.current_stream(dev).wait_event(copied)
        return host, copied, buf, sources

    def wait(self) -> None:
        """Block until every enqueued save is durable (and, on rank 0,
        published); re-raises a writer failure."""
        with self._cv:
            while self._inflight > 0 and self._error is None:
                self._cv.wait(0.5)
        self._raise_pending()

    def close(self) -> None:
        if self._thread is not None:
            with self._cv:
                self._jobs.append(None)
                self._cv.notify_all()
            self._thread.join(timeout=max(10.0, self.publish_timeout_s))
            self._thread = None

    def _raise_pending(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(
                f"sharded checkpoint writer failed: {err!r}") from err

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer_loop, daemon=True,
                name="hvd-ckpt-writer")
            self._thread.start()

    # -- writer thread ---------------------------------------------------

    def _writer_loop(self) -> None:
        while True:
            with self._cv:
                while not self._jobs:
                    self._cv.wait()
                job = self._jobs.pop(0)
            if job is None:
                return
            try:
                self._write(job)
            except BaseException as e:   # noqa: BLE001 -- surfaced on wait()
                logger.error("sharded checkpoint save(step=%s) failed: %s",
                             job.step, e)
                with self._lock:
                    self._error = e
            finally:
                if job.staging is not None:
                    self._stage.give(job.staging)
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()
                    pending = self._inflight
                from horovod_tpu_torch import metrics as _metrics
                _metrics.gauge("checkpoint_pending_saves").set(pending)

    def _atomic_write_npz(self, path: str, arrays: Dict[str, np.ndarray],
                          delay_s: float) -> int:
        tmp = path + ".tmp"
        if delay_s > 0:
            time.sleep(delay_s)   # injected slow_write fault
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
        return os.path.getsize(path)

    def _write(self, job: _SaveJob) -> None:
        from horovod_tpu_torch import faults as _faults
        from horovod_tpu_torch import metrics as _metrics
        if job.copied is not None:
            job.copied.synchronize()
        t0 = time.perf_counter()
        step_dir = os.path.join(self.directory, _step_dirname(job.step))
        os.makedirs(step_dir, exist_ok=True)
        delay = _faults.slow_write_seconds()
        files: Dict[str, Dict[str, Any]] = {}
        leaves: Dict[str, Dict[str, Any]] = {}
        # Phase 1a: this rank's owned shard files (tmp + atomic rename).
        for s, part in sorted(job.parts.items()):
            host = {}
            for k, v in part:
                host[k] = _to_numpy(v)
                info = leaves.setdefault(k, {
                    "shape": list(host[k].shape), "dtype": _dtype_name(v)})
                if k in job.unpadded:
                    info["unpadded"] = int(job.unpadded[k])
            fname = _shard_filename(s, job.num_shards)
            nbytes = self._atomic_write_npz(
                os.path.join(step_dir, fname), host, delay)
            files[fname] = {"bytes": nbytes, "shard": s}
            _metrics.counter("checkpoint_bytes_total", kind="shard").inc(
                nbytes)
        if job.replicated is not None:
            host = {}
            for k, v in job.replicated:
                host[k] = _to_numpy(v)
                if _dtype_name(v) == "bfloat16":
                    # numpy cannot say it: the manifest does
                    leaves[k] = {"shape": list(host[k].shape),
                                 "dtype": "bfloat16"}
            nbytes = self._atomic_write_npz(
                os.path.join(step_dir, "replicated.npz"), host, delay)
            files["replicated.npz"] = {"bytes": nbytes}
            _metrics.counter("checkpoint_bytes_total", kind="full").inc(
                nbytes)
        # Phase 1b: per-rank receipt, salted with the elastic attempt so a
        # dead incarnation's torn save of this step cannot satisfy the
        # publish barrier; this rank's stale receipts are cleared.
        for stale in glob.glob(os.path.join(
                step_dir, f"rank-{job.rank:05d}-of-*.ok")):
            if not stale.endswith(self._receipt_name(job.rank, job)):
                try:
                    os.remove(stale)
                except OSError:
                    pass
        ok = {"rank": job.rank, "num_ranks": job.num_ranks,
              "attempt": job.attempt,
              "mesh_axes": list(job.mesh) if job.mesh else None,
              "files": files, "leaves": leaves,
              "wall_time": time.time()}
        ok_tmp = os.path.join(
            step_dir, self._receipt_name(job.rank, job) + ".tmp")
        with open(ok_tmp, "w") as f:
            json.dump(ok, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(ok_tmp, ok_tmp[:-4])
        _metrics._timeline_marker(
            "CHECKPOINT", category="checkpoint", phase="save",
            step=job.step, shards=sorted(job.parts))
        _metrics.histogram("checkpoint_save_seconds", kind="shard").observe(
            time.perf_counter() - t0)
        # Phase 2: rank 0 waits for every receipt, then publishes.
        if job.rank == 0:
            t1 = time.perf_counter()
            self._publish(job, step_dir)
            _metrics.histogram("checkpoint_publish_seconds").observe(
                time.perf_counter() - t1)

    @staticmethod
    def _receipt_name(rank: int, job: _SaveJob) -> str:
        return (f"rank-{rank:05d}-of-{job.num_ranks:05d}"
                f".a{job.attempt}.ok")

    def _publish(self, job: _SaveJob, step_dir: str) -> None:
        from horovod_tpu_torch import metrics as _metrics
        deadline = time.monotonic() + self.publish_timeout_s
        receipts = {}
        while len(receipts) < job.num_ranks:
            for r in range(job.num_ranks):
                if r in receipts:
                    continue
                p = os.path.join(step_dir, self._receipt_name(r, job))
                if os.path.exists(p):
                    with open(p) as f:
                        receipts[r] = json.load(f)
            if len(receipts) < job.num_ranks:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"step {job.step}: only {sorted(receipts)} of "
                        f"{job.num_ranks} rank receipts after "
                        f"{self.publish_timeout_s}s: not publishing a "
                        f"torn manifest")
                time.sleep(_OK_POLL_S)
        files: Dict[str, Dict[str, Any]] = {}
        leaves: Dict[str, Dict[str, Any]] = {}
        for r in sorted(receipts):
            rm = receipts[r].get("mesh_axes")
            if job.mesh is not None and rm is not None \
                    and tuple(rm) != tuple(job.mesh):
                axis = "dp" if int(rm[0]) != job.mesh[0] else "mp"
                raise ValueError(
                    f"step {job.step}: {axis} axis mismatch: rank {r} "
                    f"saved under mesh dp{int(rm[0])}xmp{int(rm[1])} "
                    f"but this job is dp{job.mesh[0]}xmp{job.mesh[1]}; "
                    f"not publishing a mixed-axis manifest")
            files.update(receipts[r]["files"])
            leaves.update(receipts[r]["leaves"])
        manifest = {
            "format": 1,
            "step": job.step,
            "num_shards": job.num_shards,
            "num_ranks": job.num_ranks,
            "mesh_axes": list(job.mesh) if job.mesh else None,
            "dir": _step_dirname(job.step),
            "files": files,
            "leaves": leaves,
            "meta": job.meta,
            "wall_time": time.time(),
        }
        tmp = os.path.join(self.directory,
                           _manifest_name(job.step) + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, tmp[:-4])
        now = time.time()
        with self._lock:
            prev, self._last_publish_wall = self._last_publish_wall, now
        if prev is not None:
            _metrics.gauge("checkpoint_interval_seconds",
                           kind="shard").set(now - prev)
        _metrics.gauge("checkpoint_last_step", kind="shard").set(job.step)
        _metrics._timeline_marker(
            "CHECKPOINT", category="checkpoint", phase="publish",
            step=job.step, ranks=job.num_ranks)
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        for step in steps[:-self.max_to_keep]:
            # Manifest first: the step becomes invisible before its files
            # disappear, so a concurrent restore never sees a half-step.
            try:
                os.remove(os.path.join(self.directory,
                                       _manifest_name(step)))
            except FileNotFoundError:
                pass
            sd = os.path.join(self.directory, _step_dirname(step))
            for p in glob.glob(os.path.join(sd, "*")):
                try:
                    os.remove(p)
                except OSError:
                    pass
            try:
                os.rmdir(sd)
            except OSError:
                pass

    # -- restore ---------------------------------------------------------

    def all_steps(self) -> List[int]:
        """Published steps, ascending (unpublished/torn steps excluded)."""
        out = []
        for p in glob.glob(os.path.join(self.directory, "manifest-*.json")):
            base = os.path.basename(p)
            try:
                out.append(int(base[len("manifest-"):-len(".json")]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read_manifest(self, step: int) -> Dict[str, Any]:
        path = os.path.join(self.directory, _manifest_name(step))
        if not os.path.exists(path):
            if os.path.isdir(os.path.join(self.directory,
                                          _step_dirname(step))):
                raise TornCheckpointError(
                    f"step {step} in {self.directory} has shard files but "
                    f"no published manifest: the save died between "
                    f"phase 1 and phase 2; refusing to restore a torn "
                    f"step")
            raise FileNotFoundError(
                f"no checkpoint manifest for step {step} in "
                f"{self.directory}")
        with open(path) as f:
            return json.load(f)

    def restore(self, step: Optional[int] = None, *,
                num_shards: Optional[int] = None,
                mesh=None,
                shards_template=None, replicated_template=None) -> Restored:
        """Load a published step as CPU tensors, resharding to
        ``num_shards`` when it differs from the manifest's. Without
        templates the shard/replicated trees come back as ``{keystr:
        tensor}``; with templates they are rebuilt in the template's
        structure and dtypes (keys must match exactly). ``mesh`` names the
        target dp x mp factoring and implies ``num_shards = dp * mp``."""
        from horovod_tpu_torch import metrics as _metrics
        t0 = time.perf_counter()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no published checkpoint in {self.directory}")
        manifest = self.read_manifest(step)
        saved_axes = manifest.get("mesh_axes")
        if saved_axes is not None and int(manifest["num_shards"]) and \
                int(saved_axes[0]) * int(saved_axes[1]) \
                != int(manifest["num_shards"]):
            raise ValueError(
                f"step {step}: manifest mesh axes "
                f"dp{int(saved_axes[0])}xmp{int(saved_axes[1])} describe "
                f"{int(saved_axes[0]) * int(saved_axes[1])} shards but "
                f"num_shards={int(manifest['num_shards'])}: the dp/mp "
                f"axes do not factor the shard count; the manifest is "
                f"mixed-axis or corrupt, refusing to restore")
        if mesh is not None:
            tdp, tmp = _coerce_mesh(mesh, 0)
            if num_shards is not None and int(num_shards) != tdp * tmp:
                raise ValueError(
                    f"restore mesh dp{tdp}xmp{tmp} implies "
                    f"{tdp * tmp} shards but num_shards={num_shards} "
                    f"was also passed; drop one or make them agree")
            num_shards = tdp * tmp
        step_dir = os.path.join(self.directory, manifest["dir"])
        missing = [f for f in manifest["files"]
                   if not os.path.exists(os.path.join(step_dir, f))]
        if missing:
            raise FileNotFoundError(
                f"step {step} manifest lists {len(manifest['files'])} "
                f"file(s) but {missing} are missing from {step_dir}: "
                f"the checkpoint is damaged; refusing a partial restore")
        n = int(manifest["num_shards"])
        leaves = manifest.get("leaves", {})
        bytes_read = 0
        per_shard: Dict[int, Dict[str, np.ndarray]] = {}
        for fname, info in manifest["files"].items():
            path = os.path.join(step_dir, fname)
            bytes_read += os.path.getsize(path)
            if "shard" in info:
                with np.load(path) as z:
                    per_shard[int(info["shard"])] = {
                        k: z[k] for k in z.files}
        shards_dict: Dict[str, torch.Tensor] = {}
        if per_shard:
            present = sorted(per_shard)
            if present != list(range(n)):
                raise FileNotFoundError(
                    f"step {step}: manifest promises shards 0..{n - 1} "
                    f"but only {present} are on disk")
            for key in per_shard[0]:
                shards_dict[key] = _to_tensor(
                    np.stack([per_shard[s][key] for s in range(n)], axis=0),
                    leaves.get(key, {}).get("dtype"))
        m = num_shards or n
        if shards_dict and m != n:
            shards_dict = {
                key: _reshard(key, arr, m,
                              leaves.get(key, {}).get("unpadded"))
                for key, arr in shards_dict.items()}
        replicated_dict: Dict[str, torch.Tensor] = {}
        if "replicated.npz" in manifest["files"]:
            with np.load(os.path.join(step_dir, "replicated.npz")) as z:
                replicated_dict = {
                    k: _to_tensor(z[k], leaves.get(k, {}).get("dtype"))
                    for k in z.files}
        shards_out = (_unflatten_like(shards_template, shards_dict)
                      if shards_template is not None else shards_dict)
        rep_out = (_unflatten_like(replicated_template, replicated_dict)
                   if replicated_template is not None else replicated_dict)
        dt = time.perf_counter() - t0
        _metrics.histogram("checkpoint_restore_seconds",
                           kind="shard").observe(dt)
        _metrics.gauge("checkpoint_restored_step", kind="shard").set(step)
        _metrics._timeline_marker(
            "CHECKPOINT", category="checkpoint", phase="restore",
            step=step, num_shards=m, bytes=bytes_read)
        _record_recovery(manifest)
        return Restored(step=step, shards=shards_out, replicated=rep_out,
                        meta=dict(manifest.get("meta", {})),
                        manifest=manifest)


#: how long after init()'s stash a restore still counts as THE recovery;
#: anything later is an eval/rollback restore.
RECOVERY_STAMP_STALE_S = 900.0

#: [(failed_at_wall, stashed_monotonic)] -- filled by stash_failure_stamp.
_RECOVERY_STASH: List = []


def stash_failure_stamp() -> None:
    """Consume ``HVD_TPU_ELASTIC_FAILED_AT`` process-wide (called by
    ``init()``): the stamp is held for the first restore to measure
    recovery against, then discarded."""
    v = os.environ.pop("HVD_TPU_ELASTIC_FAILED_AT", None)
    if not v:
        return
    try:
        _RECOVERY_STASH[:] = [(float(v), time.monotonic())]
    except ValueError:
        _RECOVERY_STASH[:] = []


def _record_recovery(manifest: Dict[str, Any]) -> None:
    """When the elastic launcher stamped the failure instant
    (``HVD_TPU_ELASTIC_FAILED_AT``), the gap to now -- restore complete,
    training about to resume -- is the recovery time:
    ``elastic_recovery_seconds``. Recorded at most once per stamp, and only
    while the stamp is fresh."""
    if _RECOVERY_STASH:
        failed_at, stashed = _RECOVERY_STASH.pop()
        if time.monotonic() - stashed > RECOVERY_STAMP_STALE_S:
            return
    else:
        v = os.environ.pop("HVD_TPU_ELASTIC_FAILED_AT", None)
        if not v:
            return
        try:
            failed_at = float(v)
        except ValueError:
            return
    dt = max(0.0, time.time() - failed_at)
    from horovod_tpu_torch import metrics as _metrics
    _metrics.gauge("elastic_recovery_seconds").set(dt)
    _metrics.event("elastic_recovery", seconds=round(dt, 3),
                   restored_step=manifest.get("step"))


def _reshard(key: str, arr: torch.Tensor, m: int,
             unpadded: Optional[int]) -> torch.Tensor:
    """``(n, ...)`` shard-major leaf -> ``(m, ...)`` for the new world."""
    n = arr.shape[0]
    if arr.ndim == 1:
        # Per-shard counters advance in lockstep: collapse and refill.
        return torch.full((m,), arr.max().item(), dtype=arr.dtype)
    if arr.ndim != 2:
        raise ValueError(
            f"cannot reshard leaf {key} of shape {tuple(arr.shape)} from "
            f"{n} to {m} shards: only flat (n, c) layouts reshard; restore "
            f"at the original world size instead")
    flat = arr.reshape(-1)
    length = int(unpadded) if unpadded else flat.shape[0]
    flat = flat[:length]
    c = -(-length // m)
    out = torch.zeros(m * c, dtype=arr.dtype)
    out[:length] = flat
    return out.reshape(m, c)


# ---------------------------------------------------------------------------
# ZeRO-1 adapters
# ---------------------------------------------------------------------------

def pack_opt_state(opt_state, unpadded_len: Optional[int] = None):
    """``ShardedAdamWState`` -> ``(shards_tree, unpadded, info)`` in the
    manager's shard-major layout: a rank's row ((1,) step, (c,) moments)
    gives ``(1, ...)`` leaves, the one shard it owns (save them with
    ``num_shards=n, owned=[rank]``); a global state ((n,) step, (n*c,)
    moments) gives ``(n, ...)``. ``info["error_feedback"]`` is always
    false: the port has no ``ErrorFeedbackState``."""
    from horovod_tpu_torch.optimizer_sharded import ShardedAdamWState
    if not isinstance(opt_state, ShardedAdamWState):
        raise TypeError(f"pack_opt_state expects a ShardedAdamWState; got "
                        f"{type(opt_state)!r}")
    n = int(opt_state.step.shape[0])
    total = int(opt_state.mu.shape[0])
    if total % n:
        raise ValueError(
            f"ShardedAdamWState moments ({total}) are not divisible by "
            f"the shard count ({n})")
    c = total // n
    shards = {"step": opt_state.step,
              "mu": opt_state.mu.reshape(n, c),
              "nu": opt_state.nu.reshape(n, c)}
    unpadded = {}
    if unpadded_len is not None:
        unpadded = {"['mu']": int(unpadded_len), "['nu']": int(unpadded_len)}
    return shards, unpadded, {"error_feedback": False}


def _gather_rows(state, ps):
    """The global ``ShardedAdamWState`` of the rows of the set's ranks (an
    in-step all-gather, on the card for NCCL)."""
    from horovod_tpu_torch import collective as C
    from horovod_tpu_torch import core
    from horovod_tpu_torch.optimizer_sharded import ShardedAdamWState
    dev = state.mu.device
    if core.backend() == "nccl" and not state.mu.is_cuda:
        dev = core.device()
    return ShardedAdamWState(*(
        C._in_step_allgather(t.to(dev), ps, name="reshard_opt_state")
        for t in state))


def reshard_opt_state(opt_state, num_shards: int,
                      unpadded_len: Optional[int] = None,
                      process_set=None):
    """In-memory N->M reshard of a ``ShardedAdamWState``: the transform a
    manifest restore applies (strip to the unpadded length, re-pad, re-chunk;
    the step counters collapse to their max). A rank's row is first
    gathered with the other rows of ``process_set`` (default: the global
    set), which must be the set that made them; a global state is taken as
    it is. Returns the global state for ``num_shards`` on the CPU ((m,)
    step, (m*c,) moments); ``unpack_opt_state(pack_opt_state(g)[0],
    rank=r)`` is rank r's row of it."""
    from horovod_tpu_torch import collective as C
    from horovod_tpu_torch import core
    if int(opt_state.step.shape[0]) == 1 and core.is_initialized():
        ps = C._resolve_ps(process_set)
        if ps.size() > 1:
            opt_state = _gather_rows(opt_state, ps)
    packed, unpadded, _ = pack_opt_state(opt_state,
                                         unpadded_len=unpadded_len)
    out = {key: _reshard(key, packed[key].detach().cpu(), num_shards,
                         unpadded.get(f"['{key}']"))
           for key in ("step", "mu", "nu")}
    return unpack_opt_state(out)


def unpack_opt_state(shards, params=None, error_feedback: bool = False, *,
                     rank: Optional[int] = None):
    """Inverse of :func:`pack_opt_state` for restored (possibly resharded)
    arrays, a dict or a state of ``step`` (m,) and ``mu``, ``nu`` (m, c):
    the global ``ShardedAdamWState``, or with ``rank`` that shard's row
    ((1,) step, (c,) moments), as CPU tensors. ``params`` and
    ``error_feedback`` keep the reference's signature: the port has no
    ``ErrorFeedbackState``, so a step saved with it restores without it."""
    from horovod_tpu_torch.optimizer_sharded import ShardedAdamWState

    def get(k):
        v = shards[k] if isinstance(shards, dict) else getattr(shards, k)
        return v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))

    step = get("step").to(torch.int32).reshape(-1)
    mu, nu = get("mu").to(torch.float32), get("nu").to(torch.float32)
    if rank is None:
        return ShardedAdamWState(step=step, mu=mu.reshape(-1),
                                 nu=nu.reshape(-1))
    m = step.shape[0]
    return ShardedAdamWState(step=step[rank:rank + 1].clone(),
                             mu=mu.reshape(m, -1)[rank].clone(),
                             nu=nu.reshape(m, -1)[rank].clone())


# ---------------------------------------------------------------------------
# elastic-state bridge (hot-spare adoption path)
# ---------------------------------------------------------------------------

def _committed_trees(state) -> Dict[str, Any]:
    """The last commit of a ``TorchState`` (``model`` / ``optimizer``
    state dicts) or a ``TensorState`` (its named tensor trees)."""
    trees = getattr(state, "_saved_pytrees", None)
    return trees if trees is not None else state._saved


def _skeleton(node, prefix: str, leaves: List[Tuple[str, torch.Tensor]]):
    """JSON form of a commit's containers and non-tensor values; tensor
    leaves are appended to ``leaves`` under their key path and stand in
    the skeleton as ``{"a": keystr}``."""
    if isinstance(node, (torch.Tensor, np.ndarray)):
        leaves.append((prefix, node))
        return {"a": prefix}
    if isinstance(node, dict):
        kind = "o" if isinstance(node, OrderedDict) else "d"
        return {kind: [[k, _skeleton(v, prefix + f"[{k!r}]", leaves)]
                       for k, v in node.items()]}
    if isinstance(node, (list, tuple)):
        return {"t" if isinstance(node, tuple) else "l":
                [_skeleton(v, prefix + f"[{i}]", leaves)
                 for i, v in enumerate(node)]}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"v": node}
    raise TypeError(f"elastic state value at {prefix or 'the root'} is a "
                    f"{type(node).__name__}: a checkpoint holds tensors, "
                    f"containers and JSON scalars")


def _from_skeleton(sk, arrays: Dict[str, torch.Tensor]):
    if "a" in sk:
        return arrays[sk["a"]]
    if "v" in sk:
        return sk["v"]
    if "d" in sk or "o" in sk:
        out = OrderedDict() if "o" in sk else {}
        for k, v in sk.get("d", sk.get("o")):
            out[k] = _from_skeleton(v, arrays)
        return out
    items = [_from_skeleton(v, arrays) for v in sk.get("l", sk.get("t"))]
    return tuple(items) if "t" in sk else items


def _is_sharded_value(v) -> bool:
    from horovod_tpu_torch.optimizer_sharded import ShardedAdamWState
    return isinstance(v, ShardedAdamWState)


def _flat_len(tree) -> int:
    return sum(int(t.numel()) for _, t in _flatten_with_keys(tree)
               if isinstance(t, torch.Tensor))


def _infer_unpadded_len(state, row, n: int) -> Optional[int]:
    """The true flat parameter length behind a committed ZeRO-1 row, so an
    N->M restore re-chunks to exactly what ``sharded_adamw(...).init``
    would make in the new world: the one other committed tree whose flat
    length is consistent with ``n`` rows of the row's width (None keeps
    the padded length; the values still align)."""
    total = n * int(row.mu.shape[0])
    candidates = set()
    for other in _committed_trees(state).values():
        if _is_sharded_value(other):
            continue
        flat = _flat_len(other)
        if 0 < flat <= total and -(-flat // n) * n == total:
            candidates.add(flat)
    return candidates.pop() if len(candidates) == 1 else None


def save_state(mgr: ShardedCheckpointManager, step: int, state, *,
               meta: Optional[Dict[str, Any]] = None,
               wait: bool = False) -> None:
    """Persist an elastic ``TorchState`` / ``TensorState``'s **last
    commit** through the sharded manager: a committed ``ShardedAdamWState``
    goes down the shard path (each rank writes the row it owns), the other
    tensors ride the rank-0 replicated file, and the containers and
    non-tensor values (the skeleton) and the plain attributes plus ``meta``
    publish in the manifest. The commit is a private snapshot, so the
    device-to-host copies run behind the caller's stream without holding
    it."""
    n, rank = _world()
    leaves: List[Tuple[str, torch.Tensor]] = []
    shard_flat: List[Tuple[str, Any]] = []
    trees, info, unpadded = {}, {}, {}
    for name, tree in _committed_trees(state).items():
        if _is_sharded_value(tree):
            packed, leaf_unpadded, info[name] = pack_opt_state(
                tree, unpadded_len=_infer_unpadded_len(state, tree, n))
            shard_flat += _flatten_with_keys(packed, f"[{name!r}]")
            unpadded.update({f"[{name!r}]{k}": v
                             for k, v in leaf_unpadded.items()})
        else:
            trees[name] = _skeleton(tree, f"[{name!r}]", leaves)
    attrs = {}
    for k, v in state._saved_attrs.items():
        try:
            json.dumps(v)
            attrs[k] = v
        except TypeError:
            logger.warning(
                "sharded checkpoint: attribute %r is not JSON-able; "
                "excluded from the manifest", k)
    full_meta = {"attrs": attrs, "sharded": info,
                 "commit_count": getattr(state, "commit_count", 0),
                 "trees": trees}
    full_meta.update(meta or {})
    mgr._save_flat(step, shard_flat, leaves or None, full_meta,
                   unpadded=unpadded or None,
                   num_shards=n if shard_flat else None,
                   owned=[rank] if shard_flat else None, mutable=False,
                   wait=wait)


def _holds_rows(state) -> bool:
    """Does an elastic state's last commit hold a ZeRO-1 row? Such a state
    is adopted on every rank together (:func:`adopt_state`), each rank
    taking its own row; any other on rank 0 alone, before ``sync()``."""
    return any(_is_sharded_value(v)
               for v in _committed_trees(state).values())


def adopt_state(mgr: ShardedCheckpointManager, state,
                step: Optional[int] = None) -> int:
    """Hot-spare adoption: load a published manifest (default the newest)
    into an elastic state's committed snapshot and restore it. Runs inside
    the ``@hvd.elastic.run`` re-init path (before ``state.sync()``) or in
    a relaunched process: on rank 0 alone, or, for a state that commits a
    ZeRO-1 row (``_holds_rows``), on every rank together. Then every
    rank takes its own row of the manifest resharded for the current
    world, rank 0 picking the step. A newer in-memory commit than the
    manifest's is kept; for ZeRO-1 rows only when every rank still holds
    the row it committed in this world (:func:`_reshard_committed`), and
    otherwise every rank adopts the manifest. Returns the adopted step."""
    n, rank = _world()
    every = n > 1 and _holds_rows(state)
    target = step if step is not None else mgr.latest_step()
    if every and step is None:
        from horovod_tpu_torch.collective import broadcast_object
        target = broadcast_object(target, 0)
    if target is None:
        raise FileNotFoundError(
            f"no published checkpoint in {mgr.directory}")
    man_cc = mgr.read_manifest(target).get("meta", {}).get(
        "commit_count", -1)
    mem_cc = int(getattr(state, "commit_count", 0) or 0)
    # The in-memory commit outran the last published manifest (commit
    # cadence faster than save cadence, or an in-flight save died
    # unpublished): an in-process survivor keeps its newer commit.
    keep = man_cc >= 0 and mem_cc > man_cc and _reshard_committed(state, n)
    if every:
        from horovod_tpu_torch.collective import allgather_object
        keep = all(allgather_object(keep))
    if keep:
        state.restore()
        return target
    r = mgr.restore(step=target, num_shards=n)
    trees = _committed_trees(state)
    info = r.meta.get("sharded") or {}
    for name in info:
        prefix = f"[{name!r}]"
        # keys look like "['opt_state']['mu']": strip the name prefix,
        # then the quoting around the leaf name.
        packed = {key[len(prefix):].strip("[]'"): v
                  for key, v in r.shards.items() if key.startswith(prefix)}
        trees[name] = unpack_opt_state(packed, rank=rank)
    skeletons = r.meta.get("trees") or {}
    for name in list(dict.fromkeys(list(skeletons) + list(trees))):
        if name in info:
            continue
        prefix = f"[{name!r}]"
        if name in skeletons:
            trees[name] = _from_skeleton(skeletons[name], r.replicated)
            continue
        sub = {k[len(prefix):]: v for k, v in r.replicated.items()
               if k.startswith(prefix)}
        if sub:
            trees[name] = _unflatten_like(trees[name], sub)
    for k, v in r.meta.get("attrs", {}).items():
        state._saved_attrs[k] = v
    if info:
        state._commit_world = (n, rank)
    state.restore()
    return r.step


def _reshard_committed(state, num_shards: Optional[int] = None) -> bool:
    """The port's side of the reference's in-memory reshard of committed
    ZeRO-1 state. A rank holds only its own row, so a row cannot be
    re-chunked for another world without the other ranks' rows, and a
    lost rank's are gone. The committed rows stand as they are when this
    rank committed them as rank ``rank`` of ``num_shards`` (default: the
    current world) ranks; otherwise this returns False and the caller
    adopts the manifest on every rank instead. True for a state without
    rows."""
    n, rank = _world()
    return not _holds_rows(state) or getattr(
        state, "_commit_world", None) == (num_shards or n, rank)
