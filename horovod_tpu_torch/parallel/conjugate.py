"""Megatron's conjugate communication operators, as public API.

Port of ``horovod_tpu/parallel/conjugate.py``. A tensor-parallel block
reduces partial results over its tp ranks. Differentiated through an
allreduce whose backward is itself an allreduce of the cotangent (a bare
``lax.psum`` under ``shard_map(check_vma=False)`` in the reference;
``torch.distributed.nn.functional.all_reduce`` here), every such
reduction multiplies its cotangents by the tp size, compounding through
depth. The fix is the conjugate pair Megatron calls f and g
(arXiv:1909.08053 §3), each a ``torch.autograd.Function``:

- :func:`identity_fwd_psum_bwd` (``f``): place at a column-parallel
  region's INPUT: identity forward, sum over the set backward (each
  member back-propagates only its shard's contribution).
- :func:`psum_fwd_identity_bwd` (``g``): place at a row-parallel
  region's OUTPUT: sum over the set forward, identity backward (the
  replicated cotangent reaches each member's partial unchanged).

``process_set=`` (default: the global set; the tp set of a mesh is
``hvd.mesh2d().process_set("mp")``) takes the place of the reference's
``axis_name``. The sums are in-step allreduces
(``collective._in_step_allreduce``): no negotiation round, as the
reference's in-program psum takes none. Over a one-rank set both are the
identity. FSDP composes with them (``parallel/fsdp.py``).
"""

from __future__ import annotations

import torch

__all__ = ["identity_fwd_psum_bwd", "psum_fwd_identity_bwd"]


def _psum(x: torch.Tensor, ps, name: str) -> torch.Tensor:
    from horovod_tpu_torch import collective as C
    if ps.size() == 1:
        return x.clone()
    return C._in_step_allreduce(x.contiguous(), C.Sum, ps, name=name)


def identity_fwd_psum_bwd(process_set=None):
    """Megatron's ``f``: identity forward, sum over ``process_set``
    backward. Apply to the replicated input of a column-parallel block."""
    from horovod_tpu_torch import collective as C
    ps = C._resolve_ps(process_set)

    class _F(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return _psum(g, ps, "conjugate/f")

    return _F.apply


def psum_fwd_identity_bwd(process_set=None):
    """Megatron's ``g``: sum over ``process_set`` forward, identity
    backward. Apply to the partial output of a row-parallel block."""
    from horovod_tpu_torch import collective as C
    ps = C._resolve_ps(process_set)

    class _G(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return _psum(x, ps, "conjugate/g")

        @staticmethod
        def backward(ctx, ct):
            return ct

    return _G.apply
