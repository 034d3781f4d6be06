"""Elastic state with commit/restore semantics.

Port of ``horovod_tpu/elastic/state.py`` (upstream
``horovod/common/elastic.py:State`` / ``ObjectState``): ``State``;
``TorchState``, a model and an optimizer (the reference's own torch state,
whose behaviour this one keeps: its snapshots are ``copy.deepcopy`` of the
state dicts, on the tensors' own device); and ``TensorState``, the
counterpart of the reference's ``JaxState``: any number of named trees of
tensors plus plain attributes, snapshotted to host memory. ``sync()``
broadcasts the commit from rank 0 through ``broadcast_object`` and zeros
the error-feedback residuals of the quantized wire, as the reference's
``JaxState.sync`` does through ``reset_error_feedback``.

A ``TensorState`` may commit a ZeRO-1 ``ShardedAdamWState`` (each rank's
row, with the world it was committed in: ``checkpoint_sharded.save_state``
writes it, ``adopt_state`` adopts it on every rank, and ``sync()`` keeps
it, refusing a row of another world). ``FsdpState`` is the state of
FSDP / ZeRO-3 training (``parallel/fsdp.py``): its commit is the
layout-free canonical form, gathered over the ranks, so it restores at
any world size. The reference's ``TensorFlowKerasState`` waits for the
frontends (``ROADMAP.md`` §A item 11).
"""

from __future__ import annotations

import copy
import logging
import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["State", "TensorState", "TorchState", "FsdpState"]

logger = logging.getLogger("horovod_tpu_torch")


def _copy_attrs(attrs: Dict[str, Any], warned: set):
    """Deep-copy tracked attributes, falling back to by-reference (with a
    one-time warning) for values deepcopy cannot handle (locks, loggers,
    loader handles): every public attribute is tracked so counters roll
    back on restore(), but a stateful helper must not turn commit() into a
    crash.

    Returns ``(copied, uncopyable_keys)``: the caller records which keys
    fell back by reference so ``restore()`` can say, every time, that
    rolling those attributes back is a no-op."""
    out = {}
    failed = []
    for k, v in attrs.items():
        try:
            out[k] = copy.deepcopy(v)
        except Exception:
            failed.append(k)
            if k not in warned:
                warned.add(k)
                logger.warning(
                    "elastic state attribute %r is not deep-copyable; it "
                    "is kept by reference and will NOT roll back on "
                    "restore()", k)
            out[k] = v
    return out, failed


def _warn_no_rollback(no_rollback: set) -> None:
    """Per-restore (not once-per-process) warning that some attributes
    cannot roll back."""
    if no_rollback:
        logger.warning(
            "elastic restore(): attribute(s) %s could not be deep-copied "
            "at commit; their rollback is a NO-OP — the live (possibly "
            "post-failure) object is kept by reference",
            sorted(no_rollback))


def _picklable_attrs(attrs: Dict[str, Any], warned: set) -> Dict[str, Any]:
    """Subset of attributes that survive pickling (save()/sync() wire
    format); the rest are dropped with a one-time warning."""
    out = {}
    for k, v in attrs.items():
        try:
            pickle.dumps(v)
            out[k] = v
        except Exception:
            key = ("pickle", k)
            if key not in warned:
                warned.add(key)
                logger.warning(
                    "elastic state attribute %r is not picklable; it is "
                    "excluded from save()/sync()", k)
    return out


def _rank() -> int:
    from horovod_tpu_torch import core
    return core.rank() if core.is_initialized() else 0


def _world() -> int:
    from horovod_tpu_torch import core
    return core.size() if core.is_initialized() else 1


def _rank_of_world() -> tuple:
    """(size, rank) of the current world; (1, 0) before ``hvd.init()``."""
    from horovod_tpu_torch import core
    return (core.size(), core.rank()) if core.is_initialized() else (1, 0)


def _sync_attrs(saved: Dict[str, Any], warned: set,
                broadcast_fn=None) -> Dict[str, Any]:
    """Broadcast committed attrs from the coordinator. The coordinator also
    announces which keys its pickle filter dropped: every rank keeps its
    local value for exactly those keys, keys picklable on the coordinator
    converge on all ranks, and keys the coordinator never had are
    removed."""
    if broadcast_fn is None:
        from horovod_tpu_torch.collective import broadcast_object
        broadcast_fn = broadcast_object
    if _rank() == 0:
        filtered = _picklable_attrs(saved, warned)
        payload = (filtered, sorted(set(saved) - set(filtered)))
    else:
        payload = ({}, [])   # ignored: broadcast ships the root's payload
    wire, dropped = broadcast_fn(payload, 0)
    merged = dict(wire)
    for k in dropped:
        if k in saved:
            merged[k] = saved[k]
    return merged


def _is_tree(v) -> bool:
    if isinstance(v, dict):
        return all(_is_tree(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return all(_is_tree(x) for x in v)
    return isinstance(v, torch.Tensor)


def _has_tensor(v) -> bool:
    if isinstance(v, dict):
        return any(_has_tensor(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return any(_has_tensor(x) for x in v)
    return isinstance(v, torch.Tensor)


def _is_tree_of_tensors(v) -> bool:
    """A non-empty tree whose every leaf is a tensor (the reference's
    ``_is_pytree_of_arrays``)."""
    return _has_tensor(v) and _is_tree(v)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        items = [_tree_map(fn, v) for v in tree]
        # named tuples (ZeRO-1's ShardedAdamWState) take fields, not a list
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    return fn(tree)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _zero_error_feedback(opt_state):
    """An optimizer state dict with its error-feedback residuals (the
    port's ``DistributedOptimizer.state_dict()["error_feedback"]``) at
    zero: they are local error of the previous world."""
    if isinstance(opt_state, dict) and opt_state.get("error_feedback"):
        opt_state = dict(opt_state)
        opt_state["error_feedback"] = [
            None if r is None else torch.zeros_like(r)
            for r in opt_state["error_feedback"]]
    return opt_state


class State:
    """Interface: ``commit`` snapshots, ``restore`` rolls back to the last
    commit, ``sync`` re-broadcasts from the coordinator after a re-init."""

    def commit(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError

    def check_host_updates(self) -> None:
        """Raise HostsUpdatedInterrupt if membership changed (wired up by
        the elastic driver; standalone states never raise)."""
        from horovod_tpu_torch.elastic.driver import _check_host_updates
        _check_host_updates()


class TensorState(State):
    """Elastic state of named trees of tensors (``params``, ``buffers``,
    ...) plus plain attributes (``epoch``, ``step``): the reference's
    ``JaxState``. Snapshots are host copies, so a commit survives the loss
    of the device; ``restore`` puts each tensor back on the device it was
    committed from."""

    def __init__(self, **kwargs: Any):
        self._pytrees: Dict[str, Any] = {}
        self._attrs: Dict[str, Any] = {}
        self._saved_pytrees: Dict[str, Any] = {}
        self._saved_attrs: Dict[str, Any] = {}
        self._devices: Dict[str, Any] = {}
        self._warn: set = set()
        for k, v in kwargs.items():
            if _is_tree_of_tensors(v):
                self._pytrees[k] = v
            else:
                self._attrs[k] = v
        self.commit_count = 0
        self.commit()

    def __getattr__(self, name):
        pytrees = object.__getattribute__(self, "_pytrees")
        attrs = object.__getattribute__(self, "_attrs")
        if name in pytrees:
            return pytrees[name]
        if name in attrs:
            return attrs[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name.startswith("_") or name == "commit_count":
            object.__setattr__(self, name, value)
        elif "_pytrees" in self.__dict__ and name in self._pytrees:
            self._pytrees[name] = value
        elif _is_tree_of_tensors(value) and "_pytrees" in self.__dict__:
            self._pytrees[name] = value
        elif "_attrs" in self.__dict__:
            # Every public attribute is tracked state: an untracked
            # counter would survive restore() with its post-failure value.
            self._attrs[name] = value
        else:
            object.__setattr__(self, name, value)

    def commit(self) -> None:
        self._saved_pytrees = {k: _tree_map(_to_host, v)
                               for k, v in self._pytrees.items()}
        self._devices = {k: _tree_map(lambda t: t.device, v)
                         for k, v in self._pytrees.items()}
        self._saved_attrs, failed = _copy_attrs(self._attrs, self._warn)
        self._no_rollback = set(failed)
        self._commit_world = _rank_of_world()
        self.commit_count += 1

    def _placed(self, name: str, tree):
        devs = self._devices.get(name)
        if devs is None:
            return _tree_map(lambda t: t.clone(), tree)
        flat = []
        _tree_map(flat.append, devs)
        it = iter(flat)
        return _tree_map(lambda t: t.to(next(it), copy=True), tree)

    def restore(self) -> None:
        self._pytrees = {k: self._placed(k, v)
                         for k, v in self._saved_pytrees.items()}
        attrs, failed = _copy_attrs(self._saved_attrs, self._warn)
        self._attrs = attrs
        _warn_no_rollback(getattr(self, "_no_rollback", set())
                          | set(failed))

    def sync(self) -> None:
        """After re-init: broadcast the committed state from the
        coordinator so joiners agree, then restore locally. A committed
        ZeRO-1 ``ShardedAdamWState`` is each rank's own row and is not
        broadcast: it must be the row this rank committed in this world,
        or one ``checkpoint_sharded.adopt_state`` took from a manifest
        (``hvd.elastic.run(checkpoint=...)``); a row of another world
        raises, since its chunks are not this world's."""
        from horovod_tpu_torch.checkpoint_sharded import _is_sharded_value
        rows = {k: v for k, v in self._saved_pytrees.items()
                if _is_sharded_value(v)}
        world, now = getattr(self, "_commit_world", None), _rank_of_world()
        stale = bool(rows) and world != now
        if rows and _world() > 1:
            from horovod_tpu_torch.collective import allgather_object
            stale = any(allgather_object(stale))
        if stale:
            raise RuntimeError(
                f"elastic TensorState.sync: the ZeRO-1 rows {sorted(rows)} "
                f"were committed as (size, rank) {world}, and this world is "
                f"{now} (or another rank's rows are stale): a rank holds "
                f"only its own row, so the rows cannot be resharded in "
                f"memory; pass checkpoint= to hvd.elastic.run so that "
                f"every rank adopts its row of the last manifest")
        if _world() > 1:
            from horovod_tpu_torch.collective import broadcast_object
            shared = broadcast_object(
                {k: v for k, v in self._saved_pytrees.items()
                 if k not in rows}, 0)
            self._saved_pytrees = {**shared, **rows}
            self._saved_attrs = _sync_attrs(self._saved_attrs, self._warn)
        self.restore()

    def save(self, path: str) -> None:
        """Persist the last commit to disk (atomic write): ``run_elastic``
        relaunches processes, so the commit must survive their death."""
        tmp = path + ".tmp"
        torch.save({"pytrees": self._saved_pytrees,
                    "attrs": _picklable_attrs(self._saved_attrs,
                                              self._warn),
                    "commit_count": self.commit_count,
                    "world": self._commit_world}, tmp)
        os.replace(tmp, path)

    def load(self, path: str) -> None:
        """Load a saved commit (see :meth:`save`) and restore it."""
        blob = torch.load(path, map_location="cpu", weights_only=False)
        self._saved_pytrees = blob["pytrees"]
        self._saved_attrs = blob["attrs"]
        self.commit_count = blob["commit_count"]
        world = blob.get("world")
        self._commit_world = tuple(world) if world is not None else None
        self.restore()


class _AttrState(State):
    """Plain-attribute bookkeeping (epoch/step counters) for the framework
    states, committed, restored and synced beside the framework objects
    (upstream ``ObjectState``)."""

    def __init__(self, **kwargs: Any):
        self._attrs: Dict[str, Any] = dict(kwargs)
        self._saved_attrs: Dict[str, Any] = {}
        self._warn: set = set()

    def save(self, path: str) -> None:
        """Persist the last commit to disk (atomic write)."""
        tmp = path + ".tmp"
        torch.save({"saved": self._saved,
                    "attrs": _picklable_attrs(self._saved_attrs,
                                              self._warn),
                    "commit_count": self.commit_count}, tmp)
        os.replace(tmp, path)

    def load(self, path: str) -> None:
        """Load a saved commit (see :meth:`save`) and restore it."""
        blob = torch.load(path, map_location="cpu", weights_only=False)
        self._saved = blob["saved"]
        self._saved_attrs = blob["attrs"]
        self.commit_count = blob["commit_count"]
        self.restore()

    def __getattr__(self, name):
        attrs = object.__getattribute__(self, "_attrs")
        if name in attrs:
            return attrs[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name.startswith("_") or name in ("model", "optimizer",
                                            "commit_count"):
            object.__setattr__(self, name, value)
        elif "_attrs" in self.__dict__:
            self._attrs[name] = value
        else:
            object.__setattr__(self, name, value)


class TorchState(_AttrState):
    """Elastic state for torch training (upstream
    ``horovod/torch/elastic/state.py:TorchState``): snapshots
    ``model.state_dict()`` + ``optimizer.state_dict()`` (deep copies, on
    the tensors' device); ``restore`` loads them back, ``sync`` broadcasts
    the committed snapshot from rank 0 so restarted or joining workers
    agree, with error-feedback residuals at zero."""

    def __init__(self, model=None, optimizer=None, **kwargs: Any):
        super().__init__(**kwargs)
        self.model = model
        self.optimizer = optimizer
        self._saved: Dict[str, Any] = {}
        self.commit_count = 0
        self.commit()

    def _snapshot(self) -> Dict[str, Any]:
        snap: Dict[str, Any] = {}
        if self.model is not None:
            snap["model"] = copy.deepcopy(self.model.state_dict())
        if self.optimizer is not None:
            snap["optimizer"] = copy.deepcopy(self.optimizer.state_dict())
        return snap

    def commit(self) -> None:
        self._saved = self._snapshot()
        self._saved_attrs, failed = _copy_attrs(self._attrs, self._warn)
        self._no_rollback = set(failed)
        self.commit_count += 1

    def restore(self) -> None:
        if "model" in self._saved and self.model is not None:
            self.model.load_state_dict(copy.deepcopy(self._saved["model"]))
        if "optimizer" in self._saved and self.optimizer is not None:
            self.optimizer.load_state_dict(
                copy.deepcopy(self._saved["optimizer"]))
        attrs, failed = _copy_attrs(self._saved_attrs, self._warn)
        self._attrs = attrs
        _warn_no_rollback(getattr(self, "_no_rollback", set())
                          | set(failed))

    def sync(self) -> None:
        if _world() > 1:
            from horovod_tpu_torch.collective import broadcast_object
            # Host copies on the wire: a receiver must not unpickle
            # tensors onto the root's card.
            host = self._saved if _rank() != 0 else _tree_map(
                lambda v: _to_host(v) if isinstance(v, torch.Tensor)
                else v, self._saved)
            self._saved = broadcast_object(host, 0)
            self._saved_attrs = _sync_attrs(self._saved_attrs, self._warn,
                                            broadcast_fn=broadcast_object)
        if "optimizer" in self._saved:
            self._saved["optimizer"] = _zero_error_feedback(
                self._saved["optimizer"])
        self.restore()


class FsdpState(State):
    """Elastic state of FSDP / ZeRO-3 training (``parallel/fsdp.py``), the
    reference's ``FsdpState``.

    The training state is in the shard domain: this rank's ``(c,)`` row
    of the padded fp32 parameter vector (or ``(layers, c)`` rows of
    ``stack_layer_shards``) in ``shard``, and a ``ShardedAdamWState``
    whose ``mu`` / ``nu`` share that layout and whose ``step`` is this
    rank's (1,) counter in ``opt_state``. ``c = ceil(L / n)`` depends on
    the world size, so a commit cannot be replayed row by row in another
    world.

    ``commit()`` therefore gathers the rows over the world (every rank
    calls it at the same point: it is collective) and keeps the canonical
    form on the host: padding stripped to ``flat_size(template)``, the
    step counters collapsed to one int. Every rank holds it, so after a
    rank is lost the survivors restore for the smaller world from memory.
    ``restore(num_shards=None)`` pads it again for ``num_shards`` (default:
    the current world) and gives this rank its row, on the device the
    rows were committed from (else ``hvd.device()``). ``sync()``
    broadcasts rank 0's commit (joiners have none), then restores. The
    AdamW arithmetic is elementwise over the flat domain, so a resumed
    run equals one that never changed its world.

    ``template`` fixes the unpadded length: the full parameter tree for a
    ``(c,)`` row, or ONE layer's tree for ``(layers, c)`` rows; a full
    template with per-layer rows raises at ``commit``. Plain attributes
    (epoch, step, ...) are tracked as in ``TensorState``. ``save`` /
    ``load`` write the reference's pickle (``saved`` with ``shard``,
    ``mu``, ``nu`` as NumPy arrays and ``step``; ``attrs``, ``flat_len``,
    ``commit_count``), so a file written by either package loads in the
    other; ``load`` refuses another model by its flat length.
    """

    def __init__(self, template: Any, shard=None, opt_state=None,
                 **kwargs: Any):
        from horovod_tpu_torch.parallel.fsdp import flat_size
        object.__setattr__(self, "_flat_len", flat_size(template))
        object.__setattr__(self, "_attrs", dict(kwargs))
        object.__setattr__(self, "_saved", {})
        object.__setattr__(self, "_saved_attrs", {})
        object.__setattr__(self, "_warn", set())
        object.__setattr__(self, "_device", None)
        self.shard = shard
        self.opt_state = opt_state
        self.commit_count = 0
        self.commit()

    def __getattr__(self, name):
        attrs = object.__getattribute__(self, "_attrs")
        if name in attrs:
            return attrs[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if (name.startswith("_")
                or name in ("shard", "opt_state", "commit_count")):
            object.__setattr__(self, name, value)
        elif "_attrs" in self.__dict__:
            self._attrs[name] = value
        else:
            object.__setattr__(self, name, value)

    # -- canonical form ---------------------------------------------------
    @staticmethod
    def _gathered(row: torch.Tensor) -> torch.Tensor:
        """Every rank's row side by side: ``(c,) -> (n*c,)``, ``(layers,
        c) -> (layers, n*c)`` (an eager allgather over the world)."""
        if _world() == 1:
            return row.detach()
        from horovod_tpu_torch.collective import allgather
        row = row.detach()
        if row.dim() == 2:
            return allgather(row.t().contiguous(), name="fsdp_state").t()
        return allgather(row.contiguous(), name="fsdp_state")

    def _strip(self, arr) -> np.ndarray:
        """Host copy with the world-size-dependent padding removed:
        ``(n*c,) -> (L,)`` or ``(layers, n*c) -> (layers, L)``."""
        a = arr.detach().to("cpu", torch.float32).numpy() \
            if isinstance(arr, torch.Tensor) else np.asarray(arr, np.float32)
        if a.ndim > 2:
            raise ValueError(
                f"FSDP shard arrays are (n*c,) or (layers, n*c); got "
                f"shape {a.shape}")
        if a.shape[-1] < self._flat_len:
            raise ValueError(
                f"shard width {a.shape[-1]} < template flat length "
                f"{self._flat_len}; for stacked per-layer rows the "
                "template must be ONE layer's pytree")
        return a[..., :self._flat_len].copy()

    @staticmethod
    def _pad(a: np.ndarray, n: int) -> np.ndarray:
        length = a.shape[-1]
        c = -(-length // n)
        pad = [(0, 0)] * (a.ndim - 1) + [(0, n * c - length)]
        return np.pad(a, pad)

    def commit(self) -> None:
        """Collective when it holds rows: gathers them over the world."""
        snap: Dict[str, Any] = {}
        if self.shard is not None:
            snap["shard"] = self._strip(self._gathered(self.shard))
            self._device = self.shard.device
        if self.opt_state is not None:
            snap["mu"] = self._strip(self._gathered(self.opt_state.mu))
            snap["nu"] = self._strip(self._gathered(self.opt_state.nu))
            # per-rank counters advance in lockstep -> one scalar
            snap["step"] = int(self._gathered(
                self.opt_state.step.reshape(-1)).max())
            self._device = self.opt_state.mu.device
        self._saved = snap
        self._saved_attrs, failed = _copy_attrs(self._attrs, self._warn)
        self._no_rollback = set(failed)
        self.commit_count += 1

    def _row(self, a: np.ndarray, n: int, r: int, dev) -> torch.Tensor:
        padded = self._pad(a, n)
        c = padded.shape[-1] // n
        return torch.from_numpy(np.ascontiguousarray(
            padded[..., r * c:(r + 1) * c])).to(dev)

    def restore(self, num_shards: Optional[int] = None) -> None:
        """Rebuild ``shard`` / ``opt_state`` as this rank's rows of the
        commit padded for ``num_shards`` (default: the current world)."""
        from horovod_tpu_torch import core
        from horovod_tpu_torch.optimizer_sharded import ShardedAdamWState
        n = num_shards or _world()
        r = _rank()
        if r >= n:
            raise ValueError(f"rank {r} has no row among {n} shards")
        dev = self._device or (core.device() if core.is_initialized()
                               else torch.device("cpu"))
        if "shard" in self._saved:
            self.shard = self._row(self._saved["shard"], n, r, dev)
        if "mu" in self._saved:
            self.opt_state = ShardedAdamWState(
                step=torch.full((1,), self._saved["step"],
                                dtype=torch.int32, device=dev),
                mu=self._row(self._saved["mu"], n, r, dev),
                nu=self._row(self._saved["nu"], n, r, dev))
        attrs, failed = _copy_attrs(self._saved_attrs, self._warn)
        self._attrs = attrs
        _warn_no_rollback(getattr(self, "_no_rollback", set())
                          | set(failed))

    def sync(self, num_shards: Optional[int] = None) -> None:
        """After re-init in the new world: broadcast the canonical commit
        from rank 0 (joiners have none), then restore for the new world.
        The arrays travel as tensor broadcasts on this rank's device (they
        are the size of the model), the rest as one object."""
        if _world() > 1:
            from horovod_tpu_torch import core
            from horovod_tpu_torch.collective import (broadcast,
                                                      broadcast_object)
            meta = broadcast_object(
                {k: ("array", v.shape) if isinstance(v, np.ndarray)
                 else ("value", v) for k, v in self._saved.items()}, 0)
            saved = {}
            for k, (kind, v) in meta.items():
                if kind == "value":
                    saved[k] = v
                    continue
                buf = (torch.from_numpy(self._saved[k]).to(core.device())
                       if _rank() == 0 else
                       torch.empty(v, dtype=torch.float32,
                                   device=core.device()))
                saved[k] = broadcast(buf, 0, name=f"fsdp_state/{k}").cpu() \
                    .numpy()
            self._saved = saved
            self._saved_attrs = _sync_attrs(self._saved_attrs, self._warn)
        self.restore(num_shards)

    def save(self, path: str) -> None:
        """Persist the canonical commit (atomic write), in the reference's
        pickle layout."""
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"saved": self._saved,
                         "attrs": _picklable_attrs(self._saved_attrs,
                                                   self._warn),
                         "flat_len": self._flat_len,
                         "commit_count": self.commit_count}, f)
        os.replace(tmp, path)

    def load(self, path: str, num_shards: Optional[int] = None) -> None:
        """Load a saved commit and restore it for ``num_shards``."""
        with open(path, "rb") as f:
            blob = pickle.load(f)
        if blob["flat_len"] != self._flat_len:
            raise ValueError(
                f"checkpoint flat length {blob['flat_len']} != this "
                f"template's {self._flat_len} — different model")
        self._saved = blob["saved"]
        self._saved_attrs = blob["attrs"]
        self.commit_count = blob["commit_count"]
        self.restore(num_shards)
