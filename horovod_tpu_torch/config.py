"""The knobs this port reads, from the environment.

Port of the slice of ``horovod_tpu/config.py`` that the data-parallel path
uses: the fusion threshold, hierarchical Adasum and the rendezvous
contract. Each is read by :func:`get_config` (cached; :func:`refresh`
re-reads) and validated when read, so a bad value fails at ``init()`` and
not at the first collective.

* ``HOROVOD_FUSION_THRESHOLD`` -- bytes per fusion bucket (default 64 MB).
  Parsed as the reference parses it: ``int(value)`` when set and non-empty.
* ``HOROVOD_HIERARCHICAL_ALLREDUCE`` -- Adasum averages within each node
  before combining across nodes (``1``, ``true`` or ``yes``; as the
  reference reads it).
* ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``LOCAL_SIZE`` -- this
  process's place in the job (defaults 0 / 1 / ``RANK`` / ``WORLD_SIZE``),
  integers with ``0 <= rank < world_size`` and
  ``0 <= local_rank < local_size <= world_size``.
* ``MASTER_ADDR`` / ``MASTER_PORT`` -- the rendezvous store. Both or neither;
  a world of more than one process needs both.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

__all__ = ["Config", "get_config", "refresh"]

_MB = 1024 * 1024


def _env_bytes(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v.strip() == "":
        return default
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name}={v!r} is not an integer") from None


@dataclass(frozen=True)
class Config:
    fusion_threshold_bytes: int = 64 * _MB
    hierarchical_allreduce: bool = False
    rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    local_size: int = 1
    master_addr: Optional[str] = None
    master_port: Optional[int] = None


def _read() -> Config:
    world = _env_int("WORLD_SIZE", 1)
    rank = _env_int("RANK", 0)
    if world < 1:
        raise ValueError(f"WORLD_SIZE={world} must be >= 1")
    if not 0 <= rank < world:
        raise ValueError(f"RANK={rank} is outside [0, WORLD_SIZE={world})")
    local_size = _env_int("LOCAL_SIZE", world)
    local_rank = _env_int("LOCAL_RANK", rank % local_size
                          if local_size > 0 else 0)
    if not 1 <= local_size <= world:
        raise ValueError(f"LOCAL_SIZE={local_size} is outside "
                         f"[1, WORLD_SIZE={world}]")
    if not 0 <= local_rank < local_size:
        raise ValueError(f"LOCAL_RANK={local_rank} is outside "
                         f"[0, LOCAL_SIZE={local_size})")
    addr = os.environ.get("MASTER_ADDR") or None
    port_s = os.environ.get("MASTER_PORT") or None
    if (addr is None) != (port_s is None):
        raise ValueError("MASTER_ADDR and MASTER_PORT must be set together")
    port = None
    if port_s is not None:
        port = _env_int("MASTER_PORT", 0)
        if not 0 < port < 65536:
            raise ValueError(f"MASTER_PORT={port} is not a TCP port")
    if world > 1 and addr is None:
        raise ValueError(f"WORLD_SIZE={world} needs MASTER_ADDR and "
                         "MASTER_PORT (the launcher sets them)")
    return Config(
        fusion_threshold_bytes=_env_bytes("HOROVOD_FUSION_THRESHOLD",
                                          64 * _MB),
        hierarchical_allreduce=os.environ.get(
            "HOROVOD_HIERARCHICAL_ALLREDUCE", "").lower() in ("1", "true",
                                                              "yes"),
        rank=rank, world_size=world, local_rank=local_rank,
        local_size=local_size, master_addr=addr, master_port=port)


_CONFIG: Optional[Config] = None


def get_config() -> Config:
    global _CONFIG
    if _CONFIG is None:
        _CONFIG = _read()
    return _CONFIG


def refresh() -> Config:
    """Re-read the environment (``init()`` does, like upstream's
    ``horovod_init``)."""
    global _CONFIG
    _CONFIG = _read()
    return _CONFIG
