"""Named meshes over the world's ranks, and the topology of the world.

Port of ``horovod_tpu/parallel/mesh.py``: ``make_mesh``, ``make_mesh2d``,
``parse_mesh`` / ``format_mesh`` / ``validate_mesh`` (the ``"dpXxmpY"``
grammar of ``HOROVOD_MESH``), ``torus_groups``, ``parse_topology`` and
``detect_topology``, with the reference's arithmetic and errors.

A reference ``Mesh`` is an array of devices with named axes, and its
collectives name an axis inside ``shard_map``. Here one process drives one
device, so a :class:`Mesh` is an array of **global ranks** laid out as the
reference lays out its devices (row-major over the given order), and an
axis is reached through :meth:`Mesh.process_set`: this rank's line along
the axis (every other coordinate fixed), or its plane over a tuple of
axes, where the reference names a tuple of axes in a ``psum``.
``make_mesh`` registers one process set for each line of each axis and
each plane of each tuple of axes, on every rank in the same order
(``add_process_set`` is collective over the world); a line of one rank
gets a one-rank set whose group that rank makes alone, a line that spans
the whole world is the global set, and a plane with the ranks of a line
is that line's set. The lines (and planes) of one axis (or tuple) share
one ``line_key``, so an eager op that each rank issues over its own line
negotiates as one op. The reference's TPU-only
``allow_split_physical_axes`` path (``mesh_utils.create_device_mesh``, a
device order that follows the physical torus) has no counterpart: ranks
are laid out in the given order.

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

import itertools
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Mesh", "make_mesh", "parse_topology", "detect_topology",
           "torus_groups", "parse_mesh", "format_mesh", "validate_mesh",
           "make_mesh2d"]


class Mesh:
    """Global ranks with named axes (the reference's ``jax.sharding.Mesh``
    over one device a process).

    ``axis_names``: the axes, outermost first; ``shape``: name -> size;
    ``devices``: the ranks as an int array of that shape;
    :meth:`process_set` gives this rank's line along an axis."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...],
                 sets: Optional[Dict[str, object]] = None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self._sets = dict(sets or {})

    def coords(self, rank: int) -> Dict[str, int]:
        """``rank``'s coordinate along each axis."""
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in the mesh "
                             f"{self.devices.tolist()}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def process_set(self, axis):
        """This rank's line along ``axis``, or with a tuple of axes its
        plane over them (every other coordinate fixed): the process set
        its collectives over that axis, or that tuple of axes, run on (the
        reference names the axis, or the tuple, inside ``shard_map``)."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"mesh has no axis {a!r}; axes "
                                 f"{self.axis_names}")
        if len(set(names)) != len(names) or not names:
            raise ValueError(f"axes {axis!r} must name distinct axes")
        key = tuple(a for a in self.axis_names if a in names)
        if key not in self._sets:
            raise ValueError(f"this rank is not in the mesh "
                             f"{self.devices.tolist()}")
        return self._sets[key]

    def __repr__(self) -> str:
        shape = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({shape}, ranks={self.devices.tolist()})"


def _sizes(axes: Dict[str, int], count: int) -> List[int]:
    """The reference's arithmetic: one inferred ``-1`` axis at most, and
    the product must equal the device count."""
    names = tuple(axes.keys())
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    known = int(np.prod([s for s in sizes if s != -1]))
    if -1 in sizes:
        if count % known:
            raise ValueError(
                f"cannot infer axis: {count} devices not divisible by {known}")
        sizes[sizes.index(-1)] = count // known
    total = int(np.prod(sizes))
    if total != count:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} needs {total} devices, "
            f"have {count}")
    return sizes


def _line_set(line: Sequence[int], world: int, rank: int):
    """The process set of one line: the global set for the whole world; a
    one-rank set, not registered, for a single rank (its group made by
    that rank alone); else a registered set (every rank calls this, in
    one order)."""
    import torch.distributed as dist
    from horovod_tpu_torch import process_set as _ps
    line = sorted(int(r) for r in line)
    if len(line) == world:
        return _ps.global_process_set()
    if len(line) == 1:
        if line[0] != rank:
            return None
        return _ps.ProcessSet(line, dist.new_group(
            line, use_local_synchronization=True), -1)
    return _ps.add_process_set(line)


def make_mesh(axes: Dict[str, int],
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """Build a named mesh, e.g. ``make_mesh({"dp": 4, "tp": 2})``, over
    ``devices`` (global ranks; default every rank in order).

    An axis size of ``-1`` is inferred from the rank count (at most one).
    Rank ``devices[i]`` sits at the i-th coordinate in row-major order.
    Collective over the world once it is initialized: every rank makes
    the same call (it registers the lines' process sets)."""
    from horovod_tpu_torch import core
    devs = list(range(core.size()) if devices is None else devices)
    names = tuple(axes.keys())
    sizes = _sizes(axes, len(devs))
    arr = np.asarray([int(d) for d in devs], dtype=np.int64).reshape(
        tuple(sizes))
    world, rank = core.size(), core.rank()
    if arr.size and int(arr.max()) >= world:
        raise ValueError(f"mesh ranks {sorted(devs)} are outside the world "
                         f"of {world}")
    sets, made = {}, {}
    for k in range(1, len(names) + 1):
        for axes_ in itertools.combinations(range(len(names)), k):
            rest = [j for j in range(len(names)) if j not in axes_]
            width = int(np.prod([sizes[j] for j in axes_]))
            lines = np.transpose(arr, rest + list(axes_)).reshape(-1, width)
            which = tuple(names[j] for j in axes_)
            key = ("line", which[0] if k == 1 else which, names,
                   tuple(sizes), tuple(int(d) for d in arr.ravel()))
            for line in lines:
                ranks = tuple(sorted(int(r) for r in line))
                # A plane with the ranks of a line (an axis of size 1
                # beside it) is that line's set.
                if ranks not in made:
                    made[ranks] = ps = _line_set(ranks, world, rank)
                    if ps is not None and ps.ranks is not None:
                        ps.line_key = key
                if rank in ranks:
                    sets[which] = made[ranks]
    return Mesh(arr, names, sets)


# ---------------------------------------------------------------------------
# dp x mp mesh specs (the HOROVOD_MESH axis)
# ---------------------------------------------------------------------------

def parse_mesh(spec: str) -> Tuple[int, int]:
    """Parse a ``HOROVOD_MESH`` spec like ``"dp2xmp4"`` into ``(dp, mp)``
    (data-parallel degree first, model-parallel last)."""
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


def format_mesh(dp: int, mp: int) -> str:
    """``(dp, mp)`` -> the canonical ``"dpXxmpY"`` spec string."""
    return f"dp{int(dp)}xmp{int(mp)}"


def validate_mesh(dp: int, mp: int, world: int,
                  topology: Optional[Sequence[int]] = None
                  ) -> Tuple[int, int]:
    """Check a dp x mp request against the world size and the detected
    topology. ``dp * mp`` must equal ``world`` exactly, and when the
    topology has two or more dims the mp degree must nest with the
    innermost one (here the GPUs of a host): fill whole inner lines
    (``mp % inner == 0``) or subdivide one (``inner % mp == 0``)."""
    if dp * mp != world:
        raise ValueError(
            f"HOROVOD_MESH {format_mesh(dp, mp)} needs {dp * mp} devices "
            f"but the world has {world}; the mesh must factor the world "
            f"exactly")
    dims = tuple(int(d) for d in (topology or ()))
    if mp > 1 and len(dims) > 1:
        inner = dims[-1]
        if mp % inner != 0 and inner % mp != 0:
            raise ValueError(
                f"HOROVOD_MESH {format_mesh(dp, mp)}: mp={mp} does not "
                f"nest with the detected topology {'x'.join(map(str, dims))} "
                f"(innermost dim {inner}); pick mp dividing {inner} or a "
                f"multiple of it so tp collectives stay on ICI")
    return dp, mp


def make_mesh2d(dp: int, mp: int,
                devices: Optional[Sequence[int]] = None) -> Mesh:
    """The 2-D ``("dp", "mp")`` mesh of a validated dp x mp spec: global
    rank ``r`` sits at ``(dp=r // mp, mp=r % mp)``, so each mp set is a
    contiguous run of ranks (``[(r // mp) * mp, ..., (r // mp) * mp + mp -
    1]``) and each dp set is ``{r % mp + k * mp}``."""
    return make_mesh({"dp": int(dp), "mp": int(mp)}, devices)


# ---------------------------------------------------------------------------
# topology of the world (the `algorithm=` topology axis)
# ---------------------------------------------------------------------------

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


def torus_groups(dims: Sequence[int]) -> List[List[List[int]]]:
    """Per-dim groups of a flat rank axis laid out row-major over
    ``dims``: entry ``j`` partitions the ranks into lines along dim ``j``
    (every other coordinate fixed, dim ``j``'s increasing)."""
    dims = tuple(int(d) for d in dims)
    ranks = np.arange(int(np.prod(dims))).reshape(dims)
    out = []
    for j in range(len(dims)):
        moved = np.moveaxis(ranks, j, -1).reshape(-1, dims[j])
        out.append([[int(r) for r in row] for row in moved])
    return out
