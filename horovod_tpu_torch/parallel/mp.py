"""ZeRO-2 and ZeRO-3 over the named ``dp x mp`` mesh (``HOROVOD_MESH``).

Port of the ZeRO part of ``horovod_tpu/parallel/mp.py``: gradients
reduce-scatter to their owner's flat chunk, and parameters all-gather just
in time per block. ZeRO-3 is ``parallel/fsdp.py``'s machinery under the
``zero3_*`` names, with a ``wire=`` option that puts the parameter
all-gathers on the bf16 wire or the int8 / fp8 block formats of
``ops/quantized.py`` (lossy; the exact fp32 path is the default).
``process_set=`` (default: the global set) takes the place of
``axis_name=``, and every state is this rank's row, as in ZeRO-1
(``optimizer_sharded.py``).

The tensor-parallel part of the reference's ``mp.py`` (``validate_tp``,
``mp_partition_rules``, ``split_params`` / ``merge_params``, the
tensor-parallel decode steps, ``mp_stack`` / ``wrap_spmd``) waits for
item 8b of ``ROADMAP.md``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from horovod_tpu_torch.optimizer_sharded import (ShardedAdamWState,
                                                 _adamw_chunk_update,
                                                 _flatten, _unflatten)
from horovod_tpu_torch.parallel import fsdp as _fsdp
from horovod_tpu_torch.parallel.fsdp import (fsdp_adamw, fsdp_apply,
                                             fsdp_scan_blocks,
                                             fsdp_shard_params,
                                             stack_layer_shards)

__all__ = [
    "MP_AXIS", "gather_shard",
    "zero3_shard_params", "zero3_apply", "zero3_scan_blocks",
    "zero3_stack_layer_shards", "zero3_adamw",
    "zero2_grad_shard", "zero2_update",
]

#: name of the model-parallel axis of ``core.mesh2d()``
MP_AXIS = "mp"

# ZeRO-3 is fsdp under the one sharding story: the same flat-chunk layout,
# the same gather-is-the-remat Function, the same no-update-gather AdamW.
zero3_shard_params = fsdp_shard_params
zero3_scan_blocks = fsdp_scan_blocks
zero3_stack_layer_shards = stack_layer_shards
zero3_adamw = fsdp_adamw


def gather_shard(shard: torch.Tensor, process_set=None,
                 wire: Optional[str] = None) -> torch.Tensor:
    """``(c,)`` row -> the ``(n * c,)`` vector over ``process_set``,
    optionally on a reduced-precision wire: None / ``"fp32"`` is the exact
    all-gather, ``"bf16"`` casts the payload around it, ``"int8"`` /
    ``"fp8"`` ship the 1-byte block format with one fp32 scale per 256
    values (``ops/quantized.py``), gathered as per-rank rows so each
    rank's ragged scale tail stays with its payload (lossy: bit-exact
    checks stay on the default wire). In-step all-gathers: no negotiation
    round."""
    return _fsdp._gather(shard, _fsdp._set(process_set), wire,
                         "gather_shard")


def zero3_apply(block_fn: Callable, template: Any, shard: torch.Tensor, x,
                process_set=None, wire: Optional[str] = None):
    """ZeRO-3 block apply: :func:`parallel.fsdp.fsdp_apply` (the exact
    fp32 path) unless ``wire`` picks a reduced-precision gather; then the
    forward's gather and the backward's gather-again ride that wire (the
    recompute sees the forward's weights) and the gradient's
    reduce-scatter stays fp32."""
    if not wire or wire == "fp32":
        return fsdp_apply(block_fn, template, shard, x,
                          process_set=process_set)
    ps = _fsdp._set(process_set)
    length = _fsdp._check(template, shard.shape[-1], ps.size())
    return _fsdp._apply(block_fn, _fsdp._as_struct(template), length, shard,
                        x, ps, wire)


def zero2_grad_shard(grads, process_set=None) -> torch.Tensor:
    """ZeRO-2 gradient ownership: a tree of this rank's gradients -> its
    ``(c,)`` chunk of their mean over ``process_set``, by one
    reduce-scatter: the data-parallel sync and the sharding are the same
    collective."""
    from horovod_tpu_torch import collective as C
    from horovod_tpu_torch.ops.quantized import true_div
    ps = _fsdp._set(process_set)
    n = ps.size()
    flat = _flatten(grads)
    c = -(-flat.shape[0] // n)
    flat = torch.nn.functional.pad(flat, (0, n * c - flat.shape[0]))
    return true_div(C._in_step_reducescatter(flat, ps, "zero2/grads",
                                                trace_one=True), n)


def zero2_update(params, g_shard: torch.Tensor, state: ShardedAdamWState,
                 *, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, process_set=None,
                 wire: Optional[str] = None):
    """One ZeRO-2 step: AdamW on this rank's owned chunk (its state stays
    ``(c,)``), then one all-gather of the update, optionally on a
    reduced-precision wire (:func:`gather_shard`), added to the still
    replicated parameters. Returns ``(new_params, new_state)``: new
    tensors in ``params``' structure and dtypes.

    The stage between ``sharded_adamw`` (ZeRO-1) and :func:`zero3_apply`
    (parameters sharded too): parameters replicated, gradients and
    optimizer state owned. ``state`` is this rank's row of
    ``zero3_adamw(...).init``'s layout."""
    ps = _fsdp._set(process_set)
    n, r = ps.size(), ps.rank()
    flat_p = _flatten(params)
    c = g_shard.shape[0]
    p_pad = torch.nn.functional.pad(flat_p, (0, n * c - flat_p.shape[0]))
    upd, (step, mu, nu) = _adamw_chunk_update(
        g_shard, state, p_pad[r * c:(r + 1) * c], learning_rate, b1, b2,
        eps, weight_decay)
    full_upd = _fsdp._gather(upd, ps, wire, "zero2/updates")[
        :flat_p.shape[0]]
    return _unflatten(flat_p + full_upd, params), \
        ShardedAdamWState(step=step, mu=mu, nu=nu)

