"""Fault injection for preemption-tolerance tests.

Port of ``horovod_tpu/faults.py``. It turns a declarative schedule,
``HOROVOD_FAULT_PLAN``, into deterministic faults at chosen ranks and
steps, so an elastic run (``runner.run_elastic``; ``chip_smoke.py`` phase
8, ``tests/test_torch_port_launcher.py``) can SIGKILL a rank mid-run on
purpose and show that the job recovers from the last published manifest.

Plan grammar (semicolon-separated actions)::

    HOROVOD_FAULT_PLAN="kill@rank=1,step=5;stall@rank=0,step=7,seconds=2"
    HOROVOD_FAULT_PLAN="partition@rank=2,step=4,seconds=2;drop@rank=0,step=9"

Each action is ``kind@key=value,key=value`` with:

* ``kind`` -- one of ``kill`` (SIGKILL this process: a preempted host
  says no goodbye), ``stall`` (sleep ``seconds``: a degraded peer the
  stall watchdog should name), ``slow_write`` (arm a per-shard-file delay
  of ``seconds`` in the sharded checkpoint writer: a slow durable store
  must not corrupt the two-phase commit), or a **network fault** for a
  serving transport: ``drop`` (serve the RPC but never send the
  response), ``delay`` (sleep ``seconds`` before the response),
  ``partition`` (refuse every inbound connection for ``seconds``),
  ``crash_loop`` (SIGKILL the replica at its Nth inbound RPC on every
  fleet restart whose attempt is below ``count``), or ``flap`` (alternate
  partitioned / reachable half-periods of ``period`` seconds for
  ``seconds`` in all).
* ``rank=R`` -- the rank the action targets (required).
* ``step=S`` -- when it fires (required). Training reports its steps
  through :func:`fault_point`; a transport reports its per-replica RPC
  sequence number through :func:`net_fault`.
* ``space=step|net`` -- which step counter the action is keyed to.
  Network kinds live in (and default to) ``net``; everything else
  defaults to ``step``. The two spaces never cross-fire:
  :func:`fault_point` fires only ``space=step`` actions, :func:`net_fault`
  only ``space=net``. ``kill@rank=1,step=8,space=net`` opts a kill into
  the RPC counter.
* ``seconds=X`` -- duration for ``stall`` / ``slow_write`` / ``delay`` /
  ``partition`` / ``flap`` (default 1.0).
* ``count=N`` -- ``crash_loop`` only: SIGKILL while the fleet restart
  attempt (``HVD_TPU_FLEET_RESTART``) is below ``N``.
* ``period=X`` -- ``flap`` only: half-period of the square wave (0.5 s;
  it starts partitioned).
* ``restart=N`` -- which elastic attempt the action belongs to (default
  ``0``: the first launch only, so a relaunched job does not kill itself
  again; ``restart=*`` fires on every attempt). ``crash_loop`` and
  ``flap`` default to ``*``.

The network kinds are pure host logic, kept for the serving transport
(``ROADMAP.md`` §A item 10), which has no port yet.

Every fired action is timeline-marked (``FAULT``, category ``fault``) and
counted in ``fault_injected_total{kind}``. Before a ``kill`` the timeline
is flushed, best effort: SIGKILL runs no ``atexit`` and no handler.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

__all__ = ["FaultAction", "parse_plan", "get_plan", "fault_point",
           "net_fault", "partitioned", "slow_write_seconds", "reset"]

logger = logging.getLogger("horovod_tpu_torch")

_NET_KINDS = ("drop", "delay", "partition", "crash_loop", "flap")
_KINDS = ("kill", "stall", "slow_write") + _NET_KINDS


@dataclass(frozen=True)
class FaultAction:
    kind: str                      # one of _KINDS
    rank: int                      # process index the action targets
    step: int                      # step (in `space`) it fires at
    seconds: float = 1.0           # stall / slow_write duration
    restart: Optional[int] = 0    # elastic attempt (None = every attempt)
    space: str = "step"           # step counter: training "step" or
                                  # per-replica inbound-RPC "net"
    count: int = 3                # crash_loop: die while attempt < count
    period: float = 0.5           # flap: partition square-wave half-period

    def describe(self) -> str:
        extra = ""
        if self.kind in ("stall", "slow_write", "delay", "partition",
                         "flap"):
            extra = f",seconds={self.seconds:g}"
        if self.kind == "crash_loop":
            extra += f",count={self.count}"
        if self.kind == "flap":
            extra += f",period={self.period:g}"
        if self.kind not in _NET_KINDS and self.space == "net":
            extra += ",space=net"      # non-default: explicit opt-in
        r = "*" if self.restart is None else str(self.restart)
        return (f"{self.kind}@rank={self.rank},step={self.step}"
                f"{extra},restart={r}")


def parse_plan(text: str) -> List[FaultAction]:
    """Parse a ``HOROVOD_FAULT_PLAN`` string; raises ``ValueError`` with
    the offending entry on any grammar violation (config.refresh calls
    this, so a typo'd plan fails at init, not silently never-fires)."""
    actions: List[FaultAction] = []
    for raw in (text or "").split(";"):
        entry = raw.strip()
        if not entry:
            continue
        if "@" not in entry:
            raise ValueError(
                f"HOROVOD_FAULT_PLAN entry {entry!r}: expected "
                f"'kind@rank=R,step=S[,seconds=X][,restart=N|*]'")
        kind, _, rest = entry.partition("@")
        kind = kind.strip().lower()
        if kind not in _KINDS:
            raise ValueError(
                f"HOROVOD_FAULT_PLAN entry {entry!r}: unknown kind "
                f"{kind!r} (expected one of {_KINDS})")
        fields = {}
        for kv in rest.split(","):
            kv = kv.strip()
            if not kv:
                continue
            if "=" not in kv:
                raise ValueError(
                    f"HOROVOD_FAULT_PLAN entry {entry!r}: field {kv!r} "
                    f"is not key=value")
            k, _, v = kv.partition("=")
            fields[k.strip().lower()] = v.strip()
        unknown = set(fields) - {"rank", "step", "seconds", "restart",
                                 "space", "count", "period"}
        if unknown:
            raise ValueError(
                f"HOROVOD_FAULT_PLAN entry {entry!r}: unknown field(s) "
                f"{sorted(unknown)}")
        if "count" in fields and kind != "crash_loop":
            raise ValueError(
                f"HOROVOD_FAULT_PLAN entry {entry!r}: 'count' only "
                f"applies to crash_loop")
        if "period" in fields and kind != "flap":
            raise ValueError(
                f"HOROVOD_FAULT_PLAN entry {entry!r}: 'period' only "
                f"applies to flap")
        for req in ("rank", "step"):
            if req not in fields:
                raise ValueError(
                    f"HOROVOD_FAULT_PLAN entry {entry!r}: missing "
                    f"required field {req!r}")
        # crash_loop/flap must fire on EVERY restart attempt by default
        # (a crash loop that stops after the first respawn is not a
        # loop); everything else keys to the first launch.
        default_restart = "*" if kind in ("crash_loop", "flap") else "0"
        try:
            rank = int(fields["rank"])
            step = int(fields["step"])
            seconds = float(fields.get("seconds", 1.0))
            count = int(fields.get("count", 3))
            period = float(fields.get("period", 0.5))
            restart: Optional[int]
            if fields.get("restart", default_restart) == "*":
                restart = None
            else:
                restart = int(fields.get("restart", default_restart))
        except ValueError as e:
            raise ValueError(
                f"HOROVOD_FAULT_PLAN entry {entry!r}: {e}") from None
        if rank < 0 or step < 0 or seconds < 0 or (
                restart is not None and restart < 0):
            raise ValueError(
                f"HOROVOD_FAULT_PLAN entry {entry!r}: rank/step/seconds/"
                f"restart must be non-negative")
        if count < 1:
            raise ValueError(
                f"HOROVOD_FAULT_PLAN entry {entry!r}: count must be >= 1")
        if period <= 0:
            raise ValueError(
                f"HOROVOD_FAULT_PLAN entry {entry!r}: period must be > 0")
        default_space = "net" if kind in _NET_KINDS else "step"
        space = fields.get("space", "").lower() or default_space
        if space not in ("step", "net"):
            raise ValueError(
                f"HOROVOD_FAULT_PLAN entry {entry!r}: space must be "
                f"'step' or 'net', got {space!r}")
        if kind in _NET_KINDS and space != "net":
            raise ValueError(
                f"HOROVOD_FAULT_PLAN entry {entry!r}: {kind!r} is a "
                f"transport directive — it only exists in space=net")
        actions.append(FaultAction(kind=kind, rank=rank, step=step,
                                   seconds=seconds, restart=restart,
                                   space=space, count=count,
                                   period=period))
    return actions


# -- module state ------------------------------------------------------------

_LOCK = threading.Lock()
_FIRED: set = set()            # indices into the active plan
_SLOW_WRITE: float = 0.0       # armed per-shard-file write delay
_PARTITION_UNTIL: dict = {}    # rank -> monotonic deadline of a fired
                               # partition (transport refuses conns)
_FLAP: dict = {}               # rank -> (start, period, until) of a fired
                               # flap (partition square wave)
_PLAN_CACHE: tuple = ("", [])  # (plan_text, parsed) — fault_point runs
                               # every step; steady state is one compare


def _cached_plan(text: str) -> List[FaultAction]:
    global _PLAN_CACHE
    if _PLAN_CACHE[0] != text:
        _PLAN_CACHE = (text, parse_plan(text))
    return _PLAN_CACHE[1]


def get_plan() -> List[FaultAction]:
    """The active plan (from the resolved config's ``fault_plan``)."""
    from horovod_tpu_torch.config import get_config
    return _cached_plan(get_config().fault_plan)


def _my_rank() -> int:
    """This process's rank: the initialized world's, else ``RANK``."""
    from horovod_tpu_torch import core
    if core.is_initialized():
        return core.rank()
    return int(os.environ.get("RANK", "0") or 0)


def _restart_count() -> int:
    # The elastic driver and the serving fleet supervisor each stamp
    # their respawns; whichever is set is the attempt the plan keys to.
    return int(os.environ.get("HVD_TPU_FLEET_RESTART",
                              os.environ.get("HVD_TPU_ELASTIC_RESTART",
                                             "0")))


def fault_point(step: int, rank: Optional[int] = None) -> None:
    """Declare a step boundary: fire every not-yet-fired plan action that
    matches (this rank, this step, this elastic attempt).

    Call once per training step; a no-op (one config read) when no plan
    is set. A matured ``kill`` never returns."""
    from horovod_tpu_torch.config import get_config
    plan_text = get_config().fault_plan
    if not plan_text:
        return
    actions = _cached_plan(plan_text)
    me = _my_rank() if rank is None else rank
    attempt = _restart_count()
    for i, a in enumerate(actions):
        if a.space != "step":
            continue               # RPC-sequence step space (net_fault)
        if a.rank != me or a.step != step:
            continue
        if a.restart is not None and a.restart != attempt:
            continue
        with _LOCK:
            key = (i, attempt)
            if key in _FIRED:
                continue
            _FIRED.add(key)
        _fire(a)


def net_fault(step: int, rank: int) -> dict:
    """Transport-layer fault point: ``step`` is the replica's inbound RPC
    sequence number, ``rank`` its replica rank. On the legacy wire one
    connection is one RPC; on the v2 multiplexed stream the server calls
    this once per inbound ``request`` FRAME, so the sequence keeps
    counting logical RPCs — faults inject at frame granularity and a
    single multiplexed connection can drop/delay one response while its
    neighbours stream on. Fires every matching not-yet-fired
    ``space=net`` action — the network kinds live there by default, and
    ``kill``/``stall`` can opt in (``kill@...,space=net`` SIGKILLs a
    replica at its Nth RPC; ``partition`` arms :func:`partitioned` for
    ``seconds``, which also SEVERS established v2 streams at the next
    frame or idle tick). Actions keyed to training steps never fire
    here. Returns the directives the caller must apply to THIS rpc::

        {"drop": bool,       # serve it, but never send the response
         "delay_s": float}   # sleep this long before responding

    A no-op returning the empty directives when no plan is set."""
    out = {"drop": False, "delay_s": 0.0}
    from horovod_tpu_torch.config import get_config
    plan_text = get_config().fault_plan
    if not plan_text:
        return out
    actions = _cached_plan(plan_text)
    attempt = _restart_count()
    for i, a in enumerate(actions):
        if a.space != "net":
            continue               # training-step space (fault_point)
        if a.rank != rank or a.step != step:
            continue
        if a.restart is not None and a.restart != attempt:
            continue
        with _LOCK:
            key = ("net", i, attempt)
            if key in _FIRED:
                continue
            _FIRED.add(key)
        _fire(a)                     # a matured kill never returns
        if a.kind == "drop":
            out["drop"] = True
        elif a.kind == "delay":
            out["delay_s"] = max(out["delay_s"], a.seconds)
    return out


def partitioned(rank: int) -> bool:
    """Is a fired ``partition@`` (or the partitioned half-period of a
    fired ``flap@``) still in force for this rank? The transport checks
    per inbound connection and closes without reading while True — the
    peer sees connection resets, not slow replies."""
    now = time.monotonic()
    with _LOCK:
        if now < _PARTITION_UNTIL.get(rank, 0.0):
            return True
        flap = _FLAP.get(rank)
    if flap is None:
        return False
    start, period, until = flap
    if now >= until:
        return False
    # Square wave starting partitioned: half-periods 0, 2, 4, ... are
    # dark, odd ones reachable.
    return int((now - start) / period) % 2 == 0


def _flush_evidence(action: FaultAction) -> None:
    """Best-effort forensics before a SIGKILL: flush the timeline shard,
    so that the survivors' merge shows where the victim went dark."""
    try:
        from horovod_tpu_torch import timeline as _tl
        t = _tl.get_timeline()
        if t is not None:
            t.flush()
    except Exception:
        pass


def _fire(action: FaultAction) -> None:
    from horovod_tpu_torch import metrics as _metrics
    _metrics.counter("fault_injected_total", kind=action.kind).inc()
    _metrics._timeline_marker("FAULT", category="fault",
                              kind=action.kind, rank=action.rank,
                              step=action.step,
                              seconds=action.seconds)
    logger.warning("horovod_tpu_torch.faults: injecting %s",
                   action.describe())
    if action.kind == "crash_loop":
        # Die only while the fleet restart attempt is below `count`:
        # the supervisor either out-waits the loop (count < its
        # quarantine threshold) or must quarantine (count above it).
        if _restart_count() < action.count:
            _flush_evidence(action)
            os.kill(os.getpid(), signal.SIGKILL)
        return
    if action.kind == "kill":
        # Die the way a preempted host dies: no atexit, no finally
        # blocks; only the pre-kill evidence flush above survives.
        _flush_evidence(action)
        os.kill(os.getpid(), signal.SIGKILL)
    elif action.kind == "stall":
        time.sleep(action.seconds)
    elif action.kind == "slow_write":
        global _SLOW_WRITE
        with _LOCK:
            _SLOW_WRITE = max(_SLOW_WRITE, action.seconds)
    elif action.kind == "partition":
        with _LOCK:
            _PARTITION_UNTIL[action.rank] = max(
                _PARTITION_UNTIL.get(action.rank, 0.0),
                time.monotonic() + action.seconds)
    elif action.kind == "flap":
        now = time.monotonic()
        with _LOCK:
            _FLAP[action.rank] = (now, action.period,
                                  now + action.seconds)
    # "drop" and "delay" are directives applied by net_fault's caller.


def slow_write_seconds() -> float:
    """The armed per-shard-file write delay (consumed by the sharded
    checkpoint writer thread; 0.0 = no fault armed)."""
    with _LOCK:
        return _SLOW_WRITE


def reset() -> None:
    """Clear fired-action memory and armed delays/partitions (tests)."""
    global _SLOW_WRITE
    with _LOCK:
        _FIRED.clear()
        _SLOW_WRITE = 0.0
        _PARTITION_UNTIL.clear()
        _FLAP.clear()
