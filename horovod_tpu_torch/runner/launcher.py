"""Local process launcher: ``python -m horovod_tpu_torch.runner -np N ...``.

Port of the local mode of ``horovod_tpu/runner/launcher.py``. It spawns N
processes of a Python script on this machine, each with the rendezvous
contract ``horovod_tpu_torch.init()`` reads: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_SIZE``, ``MASTER_ADDR`` (127.0.0.1) and
``MASTER_PORT`` (a free local port). Rank r drives GPU r when it calls
``init()``; ``init(device="cpu")`` keeps every rank on the CPU with gloo.
When one rank fails, the others are stopped and its exit code is returned.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

__all__ = ["free_port", "worker_env", "run"]


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env(rank: int, np_: int, port: int,
               base_env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    env = dict(os.environ if base_env is None else base_env)
    env.update({
        "RANK": str(rank),
        "WORLD_SIZE": str(np_),
        "LOCAL_RANK": str(rank),
        "LOCAL_SIZE": str(np_),
        "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(port),
    })
    return env


def run(script: str, np_: int, args: Sequence[str] = (),
        env: Optional[Dict[str, str]] = None,
        timeout_s: Optional[float] = None) -> int:
    """Run ``python script args...`` as ``np_`` ranks; return 0 when every
    rank exits 0, else the first failing rank's exit code (124 when
    ``timeout_s`` ran out)."""
    if np_ < 1:
        raise ValueError(f"-np must be >= 1, got {np_}")
    port = free_port()
    procs: List[subprocess.Popen] = [
        subprocess.Popen([sys.executable, script, *args],
                         env=worker_env(r, np_, port, env))
        for r in range(np_)
    ]
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    rc = 0
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                rc = failed[0]
                break
            if all(c == 0 for c in codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                rc = 124
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return rc
