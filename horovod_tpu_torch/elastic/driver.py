"""Elastic driver: run-with-retries around membership changes.

Port of ``horovod_tpu/elastic/driver.py`` (upstream
``horovod/common/elastic.py:run_fn``, ``horovod/runner/elastic/driver.py``
and ``WorkerNotificationManager``)::

    @hvd.elastic.run
    def train(state): ...
    train(TorchState(model, optimizer, epoch=0))

On a membership change the decorated function is re-entered after
re-discovering devices, re-forming the process group (``shutdown()`` then
``init()`` over the rendezvous the environment names: a new NCCL or gloo
group, ``init_epoch()`` + 1), adopting the last published checkpoint on
rank 0 when ``checkpoint=`` is given (on every rank, each taking its own
row, when the commit holds ZeRO-1 rows), and ``state.sync()`` (restore
the last commit and broadcast it). Between processes, relaunch by
``runner.run_elastic`` is the recovery, as in the reference; hot spares
(``standby``) wait in it without touching a GPU and take ``LOCAL_RANK``'s
card only when promoted.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time
from typing import Callable, Optional

from horovod_tpu_torch import metrics as _metrics
from horovod_tpu_torch.elastic.discovery import DeviceDiscovery

__all__ = ["run", "HostsUpdatedInterrupt", "WorkerNotificationManager",
           "notification_manager", "is_spare", "standby",
           "standby_if_spare", "promote_spare", "list_spares"]


class HostsUpdatedInterrupt(Exception):
    """Raised at commit boundaries when the device/host set changed
    (upstream ``horovod/common/exceptions.py:HostsUpdatedInterrupt``)."""


class WorkerNotificationManager:
    """Watches discovery in a background thread; flags membership changes.

    Upstream runs an HTTP notification service pushed to by the rendezvous
    server; here a thread polls discovery directly.
    """

    def __init__(self, discovery: Optional[DeviceDiscovery] = None,
                 poll_interval_s: float = 1.0):
        self._discovery = discovery
        self._interval = poll_interval_s
        self._known = None
        self._changed = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def init(self, discovery: Optional[DeviceDiscovery] = None) -> None:
        if discovery is not None:
            self._discovery = discovery
        if self._discovery is None:
            self._discovery = DeviceDiscovery()
        self._known = self._snapshot()
        self._changed.clear()
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _snapshot(self):
        return tuple(str(d) for d in self._discovery.find_available_devices())

    def _loop(self):
        while not self._stop.wait(self._interval):
            try:
                now = self._snapshot()
            except Exception:
                continue
            if now != self._known:
                self._known = now
                self._changed.set()
                # Membership telemetry: counted + timeline-marked the
                # moment discovery sees the change, not when the training
                # loop reaches its next commit boundary.
                _metrics.gauge("elastic_devices").set(len(now))
                _metrics.event("elastic_membership_change",
                               devices=len(now))

    @property
    def changed(self) -> bool:
        return self._changed.is_set()

    def acknowledge(self) -> None:
        self._changed.clear()


notification_manager = WorkerNotificationManager()


def _check_host_updates() -> None:
    if notification_manager.changed:
        raise HostsUpdatedInterrupt("device membership changed")


def run(func: Callable) -> Callable:
    """Decorator: elastic retry loop (``hvd.elastic.run``).

    The wrapped ``func(state, *args)`` is re-entered after membership
    changes; ``reset_limit``/``min_size`` mirror the upstream knobs.
    """

    @functools.wraps(func)
    def wrapper(state, *args, reset_limit: Optional[int] = None,
                min_size: int = 1, discovery: Optional[DeviceDiscovery] = None,
                checkpoint=None, **kwargs):
        resets = 0
        if notification_manager._thread is None:
            notification_manager.init(discovery)
        try:
            while True:
                try:
                    return func(state, *args, **kwargs)
                except HostsUpdatedInterrupt:
                    t0 = time.monotonic()
                    resets += 1
                    _metrics.event("elastic_reset", resets=resets)
                    if reset_limit is not None and resets > reset_limit:
                        raise RuntimeError(
                            f"elastic reset limit ({reset_limit}) exceeded")
                    notification_manager.acknowledge()
                    _reinitialize(min_size, discovery)
                    if checkpoint is not None:
                        _adopt(checkpoint, state)
                    state.sync()
                    dt = time.monotonic() - t0
                    _metrics.gauge("elastic_recovery_seconds").set(dt)
                    _metrics.event("elastic_recovery",
                                   seconds=round(dt, 3))
        finally:
            notification_manager.stop()

    return wrapper


def _adopt(checkpoint, state) -> None:
    """Adoption under the new world, before ``sync()``: the coordinator
    reads the manifest and ``sync()`` broadcasts its commit; a commit that
    holds ZeRO-1 rows is adopted on every rank, each taking its own row,
    at the step rank 0 sees."""
    from horovod_tpu_torch import checkpoint_sharded as _cs
    from horovod_tpu_torch import collective as _coll
    from horovod_tpu_torch import core as _core
    every = _core.size() > 1 and _cs._holds_rows(state)
    if not every and _core.rank() != 0:
        return
    step = checkpoint.latest_step()
    if every:
        step = _coll.broadcast_object(step, 0)
    if step is not None:
        step = _cs.adopt_state(checkpoint, state, step=step)
        _metrics.event("elastic_shard_adoption", step=step)


# ---------------------------------------------------------------------------
# hot-spare (standby rank) semantics
# ---------------------------------------------------------------------------
#
# A spare is a warm process provisioned alongside the job: it has paid the
# interpreter and torch import cost, registered itself with discovery (a
# heartbeat file in the elastic state dir), and idles at the standby
# barrier without a CUDA context. When a peer dies, the launcher
# *promotes* it: hands it the dead rank's slot in the relaunched world,
# whose rank 0 adopts the last published manifest. The protocol is
# file-based for the same reason the two-phase checkpoint commit is: a
# process that has not joined a process group cannot ride collectives.

def _spares_dir(state_dir: str) -> str:
    return os.path.join(state_dir, "spares")


def is_spare() -> bool:
    """Was this process launched as a hot spare
    (``HVD_TPU_ELASTIC_SPARE=1``, set by ``run_elastic(spares=N)``)?"""
    return os.environ.get("HVD_TPU_ELASTIC_SPARE", "") == "1"


def standby(state_dir: Optional[str] = None, poll_s: float = 0.2,
            timeout_s: Optional[float] = None) -> dict:
    """Register with discovery and idle at the standby barrier until
    promoted.

    Writes ``spares/spare-<pid>.json`` (heartbeat: mtime refreshed every
    poll) under the elastic state dir, then blocks until the launcher
    writes the matching ``.promote.json`` naming this spare's rank in the
    relaunched world. On promotion the rendezvous contract (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, ``HVD_TPU_ELASTIC_RESTART``) is installed into the
    environment so the caller's ordinary ``hvd.init()`` joins the new world
    on GPU ``LOCAL_RANK``, and the promotion dict (``rank``, ``world``,
    ``local_rank``, ``local_size``, ``coordinator``, ``restart``,
    ``failed_at``) is returned. Waiting touches no GPU."""
    from horovod_tpu_torch import elastic as _elastic
    sdir = state_dir or _elastic.state_dir()
    if not sdir:
        raise RuntimeError(
            "standby() needs an elastic state dir "
            "(HVD_TPU_ELASTIC_STATE_DIR, set by run_elastic)")
    spdir = _spares_dir(sdir)
    os.makedirs(spdir, exist_ok=True)
    # Identity: the launcher-assigned token when present (the launcher's
    # Popen may be a wrapper script, so its pid is not ours), else pid.
    me = os.environ.get("HVD_TPU_ELASTIC_SPARE_ID") \
        or f"spare-{os.getpid()}"
    reg = os.path.join(spdir, f"{me}.json")
    with open(reg, "w") as f:
        json.dump({"pid": os.getpid(), "registered_at": time.time()}, f)
    _metrics.event("elastic_spare_registered")
    promote_path = os.path.join(spdir, f"{me}.promote.json")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while not os.path.exists(promote_path):
        if deadline is not None and time.monotonic() > deadline:
            try:
                os.remove(reg)
            except OSError:
                pass
            raise TimeoutError(
                f"spare {me}: not promoted within {timeout_s}s")
        os.utime(reg)   # heartbeat: a stale mtime reads as a dead spare
        time.sleep(poll_s)
    with open(promote_path) as f:
        promo = json.load(f)
    addr, _, port = promo["coordinator"].rpartition(":")
    os.environ["MASTER_ADDR"] = addr
    os.environ["MASTER_PORT"] = port
    os.environ["RANK"] = str(promo["rank"])
    os.environ["WORLD_SIZE"] = str(promo["world"])
    os.environ["LOCAL_RANK"] = str(promo.get("local_rank", promo["rank"]))
    os.environ["LOCAL_SIZE"] = str(promo.get("local_size", promo["world"]))
    os.environ["HVD_TPU_ELASTIC_RESTART"] = str(promo["restart"])
    if promo.get("failed_at") is not None:
        os.environ["HVD_TPU_ELASTIC_FAILED_AT"] = str(promo["failed_at"])
    os.environ.pop("HVD_TPU_ELASTIC_SPARE", None)
    os.environ.pop("HVD_TPU_ELASTIC_SPARE_ID", None)
    try:
        os.remove(reg)
        os.remove(promote_path)
    except OSError:
        pass
    _metrics.event("elastic_spare_promoted", rank=promo.get("rank"))
    return promo


def standby_if_spare(**kwargs) -> Optional[dict]:
    """No-op for ordinary workers; spares block in :func:`standby` until
    promoted. Lets one worker script serve both roles::

        hvd.elastic.standby_if_spare()
        hvd.init()   # spares join here with the promoted contract
    """
    if not is_spare():
        return None
    return standby(**kwargs)


def list_spares(state_dir: str, stale_s: float = 5.0) -> list:
    """Registered, live (heartbeat fresher than ``stale_s``) spares in
    promotion-file order — the launcher's discovery view."""
    spdir = _spares_dir(state_dir)
    if not os.path.isdir(spdir):
        return []
    out = []
    now = time.time()
    for name in sorted(os.listdir(spdir)):
        if not name.endswith(".json") or ".promote." in name:
            continue
        path = os.path.join(spdir, name)
        try:
            if now - os.path.getmtime(path) <= stale_s:
                out.append(name[:-len(".json")])
        except OSError:
            continue
    return out


def promote_spare(state_dir: str, spare: str, *, rank: int, world: int,
                  coordinator: str, restart: int,
                  failed_at: Optional[float] = None,
                  local_rank: Optional[int] = None,
                  local_size: Optional[int] = None) -> None:
    """Hand a registered spare a slot in the relaunched world (atomic
    promote-file publish; the spare's :func:`standby` loop picks it up).
    ``local_rank`` / ``local_size`` default to a one-host world: the
    spare's GPU is ``local_rank``."""
    spdir = _spares_dir(state_dir)
    tmp = os.path.join(spdir, f"{spare}.promote.json.tmp")
    with open(tmp, "w") as f:
        json.dump({"rank": rank, "world": world,
                   "local_rank": rank if local_rank is None else local_rank,
                   "local_size": world if local_size is None
                   else local_size,
                   "coordinator": coordinator, "restart": restart,
                   "failed_at": failed_at}, f)
    os.replace(tmp, tmp[:-len(".tmp")])


def _reinitialize(min_size: int, discovery: Optional[DeviceDiscovery],
                  max_wait_s: float = 600.0, poll_s: float = 1.0) -> None:
    """Wait until >= min_size devices are healthy, then re-form the process
    group on the same kind of device: ``shutdown()`` + ``init()``."""
    from horovod_tpu_torch import core as _core
    kind = _core.device().type if _core.is_initialized() else None
    disco = discovery or DeviceDiscovery(device=kind)
    deadline = time.monotonic() + max_wait_s
    while True:
        devs = disco.find_available_devices()
        if len(devs) >= min_size:
            _core.shutdown()
            _core.init(device=kind)
            _metrics.gauge("elastic_devices").set(len(devs))
            # Epoch boundary in this process's timeline shard (init()
            # also stamps elastic_epoch and a fresh clock anchor).
            _metrics.event("elastic_epoch", epoch=_core.init_epoch(),
                           devices=len(devs))
            return
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"elastic: only {len(devs)} devices available after "
                f"{max_wait_s}s (min_size={min_size})")
        time.sleep(poll_s)
