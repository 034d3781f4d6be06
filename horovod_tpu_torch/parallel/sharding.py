"""Parameter sharding rules: map parameter-path regexes to PartitionSpecs.

Port of ``horovod_tpu/parallel/sharding.py``. ``PartitionRules`` and
``apply_rules`` are the reference's: an ordered list of ``(path regex,
PartitionSpec)``, first match wins, replication by default; a path is the
leaf's keys joined by ``"/"`` (``"h/0/attn/qkv/weight"``; a flat dict of
``named_parameters()`` gives its dotted names as they are).

The reference's ``shard_pytree`` device-puts each leaf with a
``NamedSharding``, a global array whose block on device r is that
device's shard. One process drives one device here, so
:func:`shard_pytree` returns **this rank's block** of each leaf: each dim
split evenly over the mesh axes its spec names, at this rank's
coordinate on the mesh (``parallel/mesh.py``).
"""

from __future__ import annotations

import re
from typing import Any, List, Sequence, Tuple

import torch

__all__ = ["PartitionSpec", "P", "PartitionRules", "apply_rules",
           "shard_pytree"]


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry a dim, an axis name, a
    tuple of axis names (the dim split over their product, the first
    outermost) or None (not split); missing trailing dims are not
    split."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class PartitionRules:
    """Ordered list of ``(path_regex, PartitionSpec)``; first match wins,
    default is replication (``P()``)."""

    def __init__(self, rules: Sequence[Tuple[str, PartitionSpec]]):
        self.rules: List[Tuple[re.Pattern, PartitionSpec]] = [
            (re.compile(pat), spec) for pat, spec in rules]

    def spec_for(self, path: str) -> PartitionSpec:
        for pat, spec in self.rules:
            if pat.search(path):
                return spec
        return P()


def _map_with_path(fn, tree, path=()):
    """``jax.tree_util.tree_map_with_path`` over nested dicts, lists and
    tuples; None is an empty subtree."""
    if tree is None:
        return None
    if isinstance(tree, PartitionSpec):
        return fn(path, tree)
    if isinstance(tree, dict):
        return type(tree)((k, _map_with_path(fn, v, path + (k,)))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def apply_rules(tree: Any, rules: PartitionRules) -> Any:
    """Tree of PartitionSpecs, one per leaf, by path match."""
    return _map_with_path(lambda path, leaf: rules.spec_for(_path_str(path)),
                          tree)


def _local_block(leaf: torch.Tensor, spec: PartitionSpec, mesh,
                 coords) -> torch.Tensor:
    if len(spec) > leaf.dim():
        raise ValueError(f"spec {spec} has more entries than the leaf's "
                         f"{leaf.dim()} dims")
    index = []
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        parts, at = 1, 0
        for ax in axes:
            if ax not in mesh.shape:
                raise ValueError(f"spec {spec} names axis {ax!r}, not one "
                                 f"of the mesh's {mesh.axis_names}")
            parts, at = parts * mesh.shape[ax], at * mesh.shape[ax] + \
                coords[ax]
        size = leaf.shape[d]
        if size % parts:
            raise ValueError(f"dim {d} of size {size} does not split "
                             f"evenly over {parts} ({spec})")
        step = size // parts
        index.append(slice(at * step, (at + 1) * step))
    return leaf[tuple(index)].contiguous()


def shard_pytree(tree: Any, mesh, rules: PartitionRules) -> Any:
    """This rank's block of every leaf under its matched spec."""
    from horovod_tpu_torch import core
    coords = mesh.coords(core.rank())
    return _map_with_path(
        lambda path, leaf: _local_block(
            leaf, rules.spec_for(_path_str(path)), mesh, coords), tree)
