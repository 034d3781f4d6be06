"""Full-state checkpoint / resume.

Port of ``horovod_tpu/checkpoint.py``. The reference sits on orbax; here a
checkpoint is one ``torch.save`` file a step, ``<directory>/step-<step>.pt``,
written atomically (tmp + rename) by a writer thread, so the training loop
pays only for the host snapshot. Rank 0 writes (the state is replicated);
every rank can restore. Same API as the reference: ``CheckpointManager``
(``save``, ``restore``, ``latest_step``, ``wait``, ``close``,
``max_to_keep``), ``save_checkpoint``, ``restore_checkpoint`` and
``latest_step``, and the same metrics: ``checkpoint_save_seconds{kind=full}``
(the dispatch, what the loop pays), ``checkpoint_restore_seconds{kind=full}``,
``checkpoint_bytes_total{kind=full}``, ``checkpoint_last_step``,
``checkpoint_interval_seconds{kind=full}`` (per directory) and timeline
``CHECKPOINT`` markers.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
import time
from typing import Any, Optional

import torch

from horovod_tpu_torch.elastic.state import _tree_map

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]

#: last full-save wall time per checkpoint directory (module-level so the
#: cadence gauge survives one-shot save_checkpoint()'s throwaway managers)
_LAST_SAVE_WALL: dict = {}


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True)
    return v


def _tree_bytes(state: Any) -> int:
    total = [0]

    def add(v):
        if isinstance(v, torch.Tensor):
            total[0] += v.numel() * v.element_size()
        return v

    _tree_map(add, state)
    return total[0]


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step-{step:08d}.pt")


def _rank() -> int:
    from horovod_tpu_torch import core
    return core.rank() if core.is_initialized() else 0


class CheckpointManager:
    """Full-state checkpoints of a tree (dicts, lists, tuples) of tensors
    and plain values, ``max_to_keep`` newest kept, one writer thread."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max(1, int(max_to_keep))
        os.makedirs(self.directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, state: Any, wait: bool = False) -> None:
        from horovod_tpu_torch import metrics as _metrics
        self._raise_pending()
        t0 = time.perf_counter()
        if _rank() == 0:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._writer_loop, daemon=True,
                    name="hvd-full-ckpt-writer")
                self._thread.start()
            self._q.put((int(step), _tree_map(_host, state)))
            if wait:
                self.wait()
        _metrics.histogram("checkpoint_save_seconds", kind="full").observe(
            time.perf_counter() - t0)
        _metrics.counter("checkpoint_bytes_total", kind="full").inc(
            _tree_bytes(state))
        _metrics.gauge("checkpoint_last_step", kind="full").set(step)
        now = time.time()
        prev = _LAST_SAVE_WALL.get(self.directory)
        if prev is not None:
            _metrics.gauge("checkpoint_interval_seconds", kind="full").set(
                now - prev)
        _LAST_SAVE_WALL[self.directory] = now
        _metrics._timeline_marker("CHECKPOINT", category="checkpoint",
                                  phase="save", kind="full", step=step)

    def _writer_loop(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, host = item
                path = _path(self.directory, step)
                torch.save(host, path + ".tmp")
                os.replace(path + ".tmp", path)
                for old in self.all_steps()[:-self.max_to_keep]:
                    try:
                        os.remove(_path(self.directory, old))
                    except FileNotFoundError:
                        pass
            except BaseException as e:   # noqa: BLE001 -- raised on wait()
                self._error = e
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(f"checkpoint writer failed: {err!r}") from err

    def restore(self, step: Optional[int] = None,
                template: Optional[Any] = None) -> Any:
        """The state saved at ``step`` (default the newest). With a
        ``template``, each tensor takes the template leaf's dtype and
        device; without, tensors come back on the CPU."""
        from horovod_tpu_torch import metrics as _metrics
        t0 = time.perf_counter()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        out = torch.load(_path(self.directory, step), map_location="cpu",
                         weights_only=False)
        if template is not None:
            out = _like(template, out)
        _metrics.histogram("checkpoint_restore_seconds",
                           kind="full").observe(time.perf_counter() - t0)
        _metrics.gauge("checkpoint_restored_step", kind="full").set(step)
        _metrics._timeline_marker("CHECKPOINT", category="checkpoint",
                                  phase="restore", kind="full", step=step)
        return out

    def all_steps(self) -> list:
        out = []
        for p in glob.glob(os.path.join(self.directory, "step-*.pt")):
            try:
                out.append(int(os.path.basename(p)[5:-3]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        if self._thread is not None:
            self._q.put(None)
            self._thread.join()
            self._thread = None
        self._raise_pending()


def _like(template, tree):
    """``tree`` in ``template``'s structure: every tensor leaf cast to the
    template leaf's dtype and moved to its device."""
    if isinstance(template, dict):
        missing = sorted(set(template) - set(tree), key=str)
        if missing:
            raise KeyError(f"checkpoint lacks {missing}")
        return type(template)((k, _like(v, tree[k]))
                              for k, v in template.items())
    if isinstance(template, (list, tuple)):
        return type(template)(_like(t, v) for t, v in zip(template, tree))
    if isinstance(template, torch.Tensor):
        return tree.to(dtype=template.dtype, device=template.device)
    return tree


def save_checkpoint(directory: str, state: Any, step: int,
                    max_to_keep: int = 3) -> None:
    """One-shot save (blocks until durable)."""
    m = CheckpointManager(directory, max_to_keep)
    m.save(step, state, wait=True)
    m.close()


def restore_checkpoint(directory: str, template: Optional[Any] = None,
                       step: Optional[int] = None) -> Any:
    m = CheckpointManager(directory)
    try:
        return m.restore(step, template)
    finally:
        m.close()


def latest_step(directory: str) -> Optional[int]:
    m = CheckpointManager(directory)
    try:
        return m.latest_step()
    finally:
        m.close()
