"""Health watchdog: detect a stalled training loop.

Port of ``horovod_tpu/utils/stall.py`` (upstream ``horovod/common/
stall_inspector.cc`` semantics): per-collective stall detection is
``metrics.StallWatchdog``; this module adds the host-side heartbeat
watchdog (no step progress within ``timeout_s`` fires a warning callback,
the analogue of upstream's HOROVOD_STALL_CHECK_TIME warnings).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger("horovod_tpu_torch")

__all__ = ["HealthWatchdog"]


class HealthWatchdog:
    """Call ``beat()`` every step; if no beat arrives within ``timeout_s``
    the ``on_stall(seconds_since_beat)`` callback fires (once per stall)."""

    def __init__(self, timeout_s: Optional[float] = None,
                 on_stall: Optional[Callable[[float], None]] = None,
                 poll_s: float = 1.0):
        if timeout_s is None:
            # HOROVOD_STALL_CHECK_TIME_SECONDS (upstream stall_inspector.cc
            # warning threshold), 60s default.
            from horovod_tpu_torch.config import get_config
            timeout_s = get_config().stall_check_time_seconds
        self.timeout_s = timeout_s
        self._on_stall = on_stall or (lambda dt: logger.warning(
            "horovod_tpu_torch: no training progress for %.1fs — one or more "
            "workers may be stalled or the input pipeline starved", dt))
        self._poll_s = poll_s
        self._last = time.monotonic()
        self._fired = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stall_count = 0

    def start(self) -> "HealthWatchdog":
        from horovod_tpu_torch.config import get_config
        if get_config().stall_check_disable:
            # HOROVOD_STALL_CHECK_DISABLE=1 (upstream stall_inspector.cc
            # gate): no watchdog thread, beats become no-ops.
            return self
        self._last = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def beat(self) -> None:
        self._last = time.monotonic()
        self._fired = False

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            dt = time.monotonic() - self._last
            if dt > self.timeout_s and not self._fired:
                self._fired = True
                self.stall_count += 1
                try:
                    self._on_stall(dt)
                except Exception:
                    logger.exception("stall callback failed")

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
