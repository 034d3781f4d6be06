"""FSDP / ZeRO-3: parameters sharded across ranks, gathered just in time
per block. Use the ``zero3_*`` surface of ``parallel/mp.py``; this module
is its engine room.

Port of ``horovod_tpu/parallel/fsdp.py``. It extends the weight-update
sharding ladder (ZeRO-1 is ``optimizer_sharded.py``) to ZeRO-3: each rank
stores 1/n of the parameters, each block's weights are **all-gathered
just in time** for its forward, dropped, gathered again in the backward
(the gather is the remat), and the parameters' gradients leave the block
as **one reduce-scatter**: the data-parallel gradient sync and the
resharding are the same collective. Peak parameter memory is
``|params| / n + one block`` instead of ``|params|``; the wire bytes a
step equal a plain allreduce's (all-gather + reduce-scatter).

The layout is ZeRO-1's: a block's leaves flattened to fp32 in the
reference's order (``optimizer_sharded._flatten``: dict keys sorted),
padded to ``n * c`` with ``c = ceil(L / n)``, and **this rank's row**: a
``(c,)`` chunk (:func:`fsdp_shard_params`), or ``(L_layers, c)`` stacked
rows, one a layer (:func:`stack_layer_shards`). The reference's eager
functions return the global ``(n * c,)`` / ``(L_layers, n * c)`` arrays
that ``shard_map`` splits; its rows are the concatenation of the ranks'.
``process_set=`` (default: the global set; a mesh's data-parallel set is
``hvd.mesh2d().process_set("dp")``) takes the place of ``axis_name=``.

:func:`fsdp_apply` is a ``torch.autograd.Function``. Its forward gathers
the shard (an in-step all-gather: no negotiation round), unflattens it
into the template, runs ``block_fn`` without a graph and saves **only the
shard and the inputs**: never the gathered block, which is what keeps one
block gathered at a time. Its backward gathers again, rebuilds the leaves
as tensors that require grad, recomputes the block and takes the
gradients of the leaves and of the floating inputs; the leaves' gradients,
flattened and padded, are reduce-scattered (in step) and divided by n. So
the shard's gradient is already the data-parallel mean, resharded: feed
it to :func:`fsdp_adamw`, never through ``DistributedOptimizer`` or
``allreduce_gradients``. The block runs twice a step, as under
``remat="full"``.

:func:`fsdp_scan_blocks` runs a stack of identical blocks over stacked
rows, one :func:`fsdp_apply` a layer (a Python loop takes the place of
``lax.scan``). :func:`fsdp_adamw` is AdamW over the shard domain, with
ZeRO-1's ``_adamw_chunk_update`` as its arithmetic: no update is ever
gathered (the next forward's gathers read the new rows).

Composition: FSDP shards over one set (the mesh's dp); a block may use
another (Megatron-split matmuls over mp), with its tp reductions through
the conjugate operators of ``parallel/conjugate.py``, not a
differentiable allreduce whose backward multiplies the cotangents by the
tp size.

Usage (a GPT-2 medium's blocks; ``module_block_fn`` runs a module whose
forward returns ``(x, aux)``, as the port's ``Block`` does)::

    rows = stack_layer_shards(stacked).requires_grad_()   # (24, c)
    h = fsdp_scan_blocks(module_block_fn(block), template, rows, h)
    loss.backward()                      # rows.grad: the dp mean, (24, c)
    upd, state = fsdp_adamw(1e-4).update(rows.grad, state, rows)
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from horovod_tpu_torch.checkpoint_sharded import (_flatten_with_keys,
                                                  _unflatten_like)
from horovod_tpu_torch.optimizer_sharded import (GradientTransformation,
                                                 ShardedAdamWState, _flatten,
                                                 _unflatten)

__all__ = ["fsdp_shard_params", "fsdp_apply", "fsdp_scan_blocks",
           "fsdp_adamw", "flat_size", "stack_layer_shards",
           "module_block_fn"]


def flat_size(tree) -> int:
    """Total element count of a tree (the flat fp32 length)."""
    return sum(int(t.numel()) for _, t in _flatten_with_keys(tree))


def _chunk(length: int, n: int) -> int:
    return -(-length // n)


def _set(process_set):
    from horovod_tpu_torch import collective as C
    ps = C._resolve_ps(process_set)
    if not ps.included():
        raise ValueError(f"fsdp: this rank is not in {ps}")
    return ps


def fsdp_shard_params(params, *, num_shards: Optional[int] = None,
                      process_set=None) -> torch.Tensor:
    """This rank's ``(c,)`` row of ``params`` flattened to fp32 and padded
    to ``n * c`` (``n``: ``num_shards``, default the size of
    ``process_set``; the row is this rank's index in the set). The
    original tree (or meta tensors of its shapes) is the template every
    :func:`fsdp_apply` needs."""
    ps = _set(process_set)
    n = num_shards or ps.size()
    r = ps.rank()
    if r >= n:
        raise ValueError(f"rank {r} of {ps} has no row among {n} shards")
    flat = _flatten(params)
    c = _chunk(flat.shape[0], n)
    flat = torch.nn.functional.pad(flat, (0, n * c - flat.shape[0]))
    return flat[r * c:(r + 1) * c].clone()


def stack_layer_shards(stacked_params, *, num_shards: Optional[int] = None,
                       process_set=None) -> torch.Tensor:
    """A layer-stacked tree (every leaf ``(L, ...)``) -> this rank's
    ``(L, c)`` rows, row i layer i's padded flat chunk, so the scan
    gathers one layer at a time."""
    leaves = _flatten_with_keys(stacked_params)
    layers = leaves[0][1].shape[0]
    return torch.stack([
        fsdp_shard_params(
            _unflatten_like(stacked_params, {k: t[i] for k, t in leaves}),
            num_shards=num_shards, process_set=process_set)
        for i in range(layers)])


def _as_struct(template):
    """The template's leaves as meta tensors: shapes and dtypes only, so
    a saved template holds no memory (the reference's ``_as_struct``)."""
    leaves = {k: torch.empty(t.shape, dtype=t.dtype, device="meta")
              for k, t in _flatten_with_keys(template)}
    return _unflatten_like(template, leaves)


def _check(template, width: int, n: int) -> int:
    """Flat length of ``template``; raises unless a row of ``width``
    over ``n`` ranks holds it as ``fsdp_shard_params`` pads it."""
    length = flat_size(template)
    if width * n < length:
        raise ValueError(
            f"shard width {width} x {n} ranks < template flat length "
            f"{length}; for stacked per-layer rows the template must be "
            "ONE layer's pytree")
    if width != _chunk(length, n):
        raise ValueError(
            f"shard width {width} is not ceil({length}/{n}) for a template "
            f"of {length} elements over {n} ranks")
    return length


def _gather(shard: torch.Tensor, ps, wire: Optional[str],
            name: str = "fsdp/params") -> torch.Tensor:
    """``(c,)`` row -> the ``(n * c,)`` vector over ``ps``, on ``wire``
    (see ``mp.gather_shard``): in-step all-gathers, traced on one rank
    too."""
    from horovod_tpu_torch import collective as C
    if not wire or wire == "fp32":
        return C._in_step_allgather(shard, ps, name, trace_one=True)
    if wire == "bf16":
        g = C._in_step_allgather(shard.to(torch.bfloat16), ps, name,
                                 trace_one=True)
        return g.to(shard.dtype)
    if wire not in ("int8", "fp8"):
        raise ValueError(f"gather_shard wire={wire!r}: expected fp32, "
                         f"bf16, int8 or fp8")
    from horovod_tpu_torch.ops.quantized import (dequantize_blocks,
                                                 quantize_blocks)
    n = ps.size()
    q, scale = quantize_blocks(shard.to(torch.float32), wire=wire)
    # Per-rank rows, not one tiled vector: each rank's ragged scale tail
    # stays aligned with its own payload through the dequantize.
    gq = C._in_step_allgather(q.view(torch.uint8), ps, name + "/codes",
                              trace_one=True).view(q.dtype).view(n, -1)
    gs = C._in_step_allgather(scale, ps, name + "/scales",
                              trace_one=True).view(n, -1)
    return dequantize_blocks(gq, gs).reshape(-1).to(shard.dtype)


def _split_inputs(x):
    """``x`` -> (spec, its tensors): a tensor, or a tuple / list whose
    tensors are the Function's inputs and whose other items ride in the
    spec."""
    if isinstance(x, torch.Tensor):
        return None, (x,)
    if isinstance(x, (tuple, list)):
        kinds = tuple(isinstance(v, torch.Tensor) for v in x)
        return ((type(x), kinds, tuple(None if k else v
                                       for k, v in zip(kinds, x))),
                tuple(v for v in x if isinstance(v, torch.Tensor)))
    raise TypeError(f"fsdp_apply: x must be a tensor or a tuple, got "
                    f"{type(x).__name__}")


def _join_inputs(spec, tensors):
    if spec is None:
        return tensors[0]
    typ, kinds, others = spec
    it = iter(tensors)
    return typ(next(it) if k else o for k, o in zip(kinds, others))


def _run_block(block_fn, params, x):
    y = block_fn(params, x)
    if not isinstance(y, torch.Tensor):
        raise TypeError(f"fsdp block_fn must return one tensor, got "
                        f"{type(y).__name__}")
    return y


class _FsdpCall(torch.autograd.Function):
    """One block over a gathered shard. Saves only the shard and the
    inputs; the backward gathers again and recomputes (module
    docstring)."""

    @staticmethod
    def forward(ctx, meta, shard, *xs):
        block_fn, template, length, ps, wire, spec = meta
        full = _gather(shard, ps, wire)
        y = _run_block(block_fn, _unflatten(full[:length], template),
                       _join_inputs(spec, xs))
        ctx.meta = meta
        ctx.save_for_backward(shard, *xs)
        return y

    @staticmethod
    def backward(ctx, ct):
        from horovod_tpu_torch.collective import _in_step_reducescatter
        from horovod_tpu_torch.ops.quantized import true_div
        block_fn, template, length, ps, wire, spec = ctx.meta
        shard, *xs = ctx.saved_tensors
        n = ps.size()
        full = _gather(shard, ps, wire)
        keys, leaves, off = [], [], 0
        for key, t in _flatten_with_keys(template):
            k = t.numel()
            keys.append(key)
            leaves.append(full[off:off + k].view(t.shape).to(t.dtype)
                          .detach().requires_grad_(True))
            off += k
        diff = [i for i, x in enumerate(xs) if x.is_floating_point()
                and ctx.needs_input_grad[2 + i]]
        xs_in = [x.detach().requires_grad_(True) if i in diff else x
                 for i, x in enumerate(xs)]
        with torch.enable_grad():
            y = _run_block(block_fn,
                           _unflatten_like(template, dict(zip(keys, leaves))),
                           _join_inputs(spec, xs_in))
            grads = torch.autograd.grad(
                y, leaves + [xs_in[i] for i in diff], ct, allow_unused=True)
        del full, y
        parts = [(torch.zeros_like(p) if g is None else g).reshape(-1)
                 .to(torch.float32) for p, g in zip(leaves, grads)]
        pad = n * shard.shape[0] - length
        if pad:
            parts.append(shard.new_zeros(pad))
        g_full = torch.cat(parts)
        del parts, leaves
        # The data-parallel mean and the resharding in one collective.
        g_shard = true_div(_in_step_reducescatter(
            g_full, ps, "fsdp/grads", trace_one=True), n)
        g_xs = [None] * len(xs)
        for i, g in zip(diff, grads[len(keys):]):
            g_xs[i] = g
        return (None, g_shard, *g_xs)


def _apply(block_fn, struct, length, shard, x, ps, wire):
    spec, xs = _split_inputs(x)
    return _FsdpCall.apply((block_fn, struct, length, ps, wire, spec),
                           shard, *xs)


def fsdp_apply(block_fn: Callable, template: Any, shard: torch.Tensor, x,
               process_set=None):
    """``block_fn(params, x)`` with ``params`` stored as this rank's
    ``(c,)`` row of :func:`fsdp_shard_params`.

    The gradient of ``shard`` is already the data-parallel mean over
    ``process_set``, resharded: feed it to :func:`fsdp_adamw`, not to an
    allreduce.

    Args:
      block_fn: ``(params tree, x) -> y``, one tensor (a module's forward
        through :func:`module_block_fn`).
      template: a tree of the block's leaves (real tensors or meta
        tensors: shapes and dtypes only).
      shard: this rank's (c,) fp32 row.
      x: the block's input: a tensor, or a tuple whose floating tensors
        get gradients and whose other items (integer segment ids, None,
        flags) ride along without one.
      process_set: the set the parameters are sharded over (default: the
        global set).
    """
    ps = _set(process_set)
    length = _check(template, shard.shape[-1], ps.size())
    return _apply(block_fn, _as_struct(template), length, shard, x, ps, None)


def fsdp_scan_blocks(block_fn: Callable, template: Any,
                     layer_shards: torch.Tensor, x, process_set=None):
    """A stack of identical blocks over ``x`` with one layer gathered at
    a time: ``layer_shards`` is this rank's ``(L, c)`` rows of
    :func:`stack_layer_shards` and ``template`` describes ONE layer. A
    tuple ``x`` carries its first item from layer to layer and hands its
    other items (segment ids) to every layer unchanged."""
    ps = _set(process_set)
    length = _check(template, layer_shards.shape[-1], ps.size())
    struct = _as_struct(template)
    carry, rest = (x[0], tuple(x[1:])) if isinstance(x, (tuple, list)) \
        else (x, None)
    for row in layer_shards.unbind(0):
        carry = _apply(block_fn, struct, length, row,
                       carry if rest is None else (carry,) + rest, ps, None)
    return carry


def module_block_fn(module: torch.nn.Module) -> Callable:
    """``block_fn`` of a module: ``functional_call(module, params, x)``
    (``x`` a tensor or a tuple of positional inputs). A forward that
    returns ``(y, aux)``, as the port's transformer blocks do, gives
    ``y``; an aux that is not None (an MoE block's load-balance loss)
    raises: MoE under FSDP is not supported."""
    from torch.func import functional_call

    def fn(params, x):
        out = functional_call(module, params,
                              tuple(x) if isinstance(x, (tuple, list))
                              else (x,))
        if isinstance(out, tuple):
            y, *aux = out
            if any(a is not None for a in aux):
                raise ValueError(
                    "fsdp: the block returned an aux loss (an MoE block); "
                    "MoE under FSDP is not supported")
            return y
        return out
    return fn


def fsdp_adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, weight_decay: float = 0.0
               ) -> GradientTransformation:
    """AdamW over the shard domain: state, gradient, update and
    parameters are all this rank's rows (``(c,)`` or ``(L, c)``): no
    update is gathered (the next forward's gathers read the new rows).

    ``init(rows)`` gives a (1,) int32 step and mu, nu of the rows' shape;
    ``update(g, state, rows)`` returns ``(update, state)`` through
    ZeRO-1's ``_adamw_chunk_update``."""

    def init(flat_params):
        return ShardedAdamWState(
            step=torch.zeros((1,), dtype=torch.int32,
                             device=flat_params.device),
            mu=torch.zeros_like(flat_params, dtype=torch.float32),
            nu=torch.zeros_like(flat_params, dtype=torch.float32))

    def update(g, state, params=None):
        if weight_decay and params is None:
            raise ValueError(
                "fsdp_adamw with weight_decay requires params in update()")
        from horovod_tpu_torch import optimizer_sharded as S
        upd, (step, mu, nu) = S._adamw_chunk_update(
            g, state, params.detach() if params is not None else 0.0,
            learning_rate, b1, b2, eps, weight_decay)
        return upd, ShardedAdamWState(step=step, mu=mu, nu=nu)

    return GradientTransformation(init, update)
