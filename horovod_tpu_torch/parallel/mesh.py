"""Topology of the world, for the ``_2d`` allreduce lowerings.

Port of ``parse_topology``, ``detect_topology`` and ``parse_mesh`` (the
``"dpXxmpY"`` grammar that sharded checkpoints record) of
``horovod_tpu/parallel/mesh.py``; the rest of that module (named meshes,
dp x mp) is not ported yet (ROADMAP.md section A item 8a-ii).

The reference reads a TPU slice's torus dims from the devices'
coordinates. A GPU job has two tiers instead: NVLink inside a host and the
network between hosts. :func:`detect_topology` resolves, in order:

* the ``HOROVOD_TOPOLOGY`` override (``"2x2"``), whose product must equal
  the world;
* ``(cross_size, local_size)`` when both are above 1: the network tier
  outside, the NVLink tier inside, ranks packed host by host (rank =
  cross_rank * local_size + local_rank, row-major as the reference lays
  its torus out);
* else the flat ring ``(world,)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["parse_topology", "detect_topology", "parse_mesh"]


def parse_topology(spec: str) -> Tuple[int, ...]:
    """Parse a ``HOROVOD_TOPOLOGY`` spec like ``"2x2"`` or ``"4x8x2"``
    into a dims tuple. Every dim must be a positive integer."""
    parts = str(spec).strip().lower().split("x")
    try:
        dims = tuple(int(p) for p in parts)
    except ValueError:
        dims = ()
    if not dims or any(d < 1 for d in dims):
        raise ValueError(
            f"invalid HOROVOD_TOPOLOGY {spec!r}; expected positive torus "
            f"dims like '2x2' or '4x8'")
    return dims


def parse_mesh(spec: str) -> Tuple[int, int]:
    """Parse a ``HOROVOD_MESH`` spec like ``"dp2xmp4"`` into ``(dp, mp)``
    (data-parallel degree first, model-parallel last)."""
    import re
    m = re.fullmatch(r"dp(\d+)xmp(\d+)", str(spec).strip().lower())
    if not m:
        raise ValueError(
            f"invalid HOROVOD_MESH {spec!r}; expected 'dpXxmpY' like "
            f"'dp2xmp4' (data-parallel degree X, model-parallel degree Y)")
    dp, mp = int(m.group(1)), int(m.group(2))
    if dp < 1 or mp < 1:
        raise ValueError(
            f"invalid HOROVOD_MESH {spec!r}: both degrees must be >= 1")
    return dp, mp


def detect_topology(world: int, local_size: int = 1,
                    override: Optional[str] = None) -> Tuple[int, ...]:
    """The dims of the ``world``-rank job (see the module docstring)."""
    if override:
        dims = parse_topology(override)
        prod = 1
        for d in dims:
            prod *= d
        if prod != world:
            raise ValueError(
                f"HOROVOD_TOPOLOGY {override!r} describes {prod} devices "
                f"but the world has {world}")
        return dims
    if world <= 1:
        return (max(world, 1),)
    local = max(1, int(local_size))
    cross = -(-world // local)
    if cross > 1 and local > 1 and cross * local == world:
        return (cross, local)
    return (world,)
