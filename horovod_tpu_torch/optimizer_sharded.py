"""Cross-replica sharded weight update (ZeRO-1).

Port of ``horovod_tpu/optimizer_sharded.py``. Instead of every rank
holding the whole optimizer state and applying the whole update after an
allreduce, the gradient is reduce-scattered (each rank owns 1/n of the
flattened gradient), AdamW's moments live only for the owned chunk (1/n of
the memory), the update is computed on the chunk, and the updated chunks
are all-gathered back. The bytes on the wire equal the allreduce's they
replace; the gain is n times less optimizer state.

``sharded_adamw(...)`` returns the optax-shaped pair ``(init, update)``:

    opt = hvd.sharded_adamw(1e-4, weight_decay=1e-4)
    state = opt.init(params)                 # this rank's row
    updates, state = opt.update(grads, state, params)
    for p, u in zip(params.values(), updates.values()):
        p.add_(u)                            # optax.apply_updates

``params`` and ``grads`` are trees of tensors (nested dicts, lists,
tuples). Leaves are flattened in the reference's order
(``checkpoint_sharded._flatten_with_keys``: dict keys sorted, as
``jax.tree_util`` flattens them; ``named_parameters()`` gives registration
order), so chunk boundaries, and with them
each rank's moments and the checkpoint's shards, are the reference's: the
reference's global ``(n*c,)`` moments are the concatenation of the ranks'
``(c,)`` rows. ``process_set=`` (default: the global set) takes the place
of the reference's ``axis_name=``. The reduce-scatter and the all-gather
are in-step collectives (``collective._in_step_reducescatter`` /
``_in_step_allgather``: NCCL's ``reduce_scatter_tensor`` and
``all_gather_into_tensor`` on the card), the reference's in-program
``psum_scatter`` and ``all_gather``: no negotiation round.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from horovod_tpu_torch.checkpoint_sharded import (_flatten_with_keys,
                                                  _unflatten_like)

__all__ = ["ShardedAdamWState", "GradientTransformation", "sharded_adamw"]


class ShardedAdamWState(NamedTuple):
    step: torch.Tensor   # (1,) int32: this rank's step count
    mu: torch.Tensor     # (c,) fp32: first moment of the owned chunk
    nu: torch.Tensor     # (c,) fp32: second moment of the owned chunk


class GradientTransformation(NamedTuple):
    """optax's ``GradientTransformation``: ``init(params) -> state``,
    ``update(grads, state, params) -> (updates, state)``."""
    init: Callable
    update: Callable


def _numel(tree) -> int:
    return sum(t.numel() for _, t in _flatten_with_keys(tree))


def _flatten(tree) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for _, t in _flatten_with_keys(tree)])


def _unflatten(flat: torch.Tensor, tree):
    out, off = {}, 0
    for key, t in _flatten_with_keys(tree):
        n = t.numel()
        out[key] = flat[off:off + n].view(t.shape).to(t.dtype)
        off += n
    return _unflatten_like(tree, out)


def _adamw_chunk_update(g, state: ShardedAdamWState, p, learning_rate,
                        b1, b2, eps, weight_decay):
    """AdamW's elementwise arithmetic over one owned chunk, the single
    definition of the Adam math (the reference's, in its order of
    operations). Returns ``(update, (step, mu, nu))``."""
    step = state.step + 1
    stepf = step.to(torch.float32)[0]
    mu = b1 * state.mu + (1 - b1) * g
    nu = b2 * state.nu + (1 - b2) * torch.square(g)
    mu_hat = mu / (1 - b1 ** stepf)
    nu_hat = nu / (1 - b2 ** stepf)
    upd = -learning_rate * (mu_hat / (torch.sqrt(nu_hat) + eps)
                            + weight_decay * p)
    return upd, (step, mu, nu)


def sharded_adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8, weight_decay: float = 0.0,
                  process_set=None) -> GradientTransformation:
    """AdamW with reduce-scattered gradients and 1/n-sharded moments over
    the ``n`` ranks of ``process_set``.

    ``init(params)`` returns this rank's row: ``step`` (1,) int32 and
    ``mu``, ``nu`` (c,) fp32 zeros on the parameters' device, c =
    ceil(L/n) for L parameter elements. ``update(grads, state, params)``
    flattens the gradients to fp32, pads them to n*c, reduce-scatters the
    sum and divides it by n, runs the AdamW arithmetic on this rank's
    chunk of the padded parameters, all-gathers the updated chunks, drops
    the padding and returns the updates in the gradients' structure, each
    leaf in its gradient's dtype."""
    from horovod_tpu_torch import collective as C
    from horovod_tpu_torch.ops.quantized import true_div

    def _set():
        ps = C._resolve_ps(process_set)
        if not ps.included():
            raise ValueError(f"sharded_adamw: this rank is not in {ps}")
        return ps

    def init(params):
        n = _set().size()
        c = -(-_numel(params) // n)
        dev = _flatten_with_keys(params)[0][1].device
        return ShardedAdamWState(
            step=torch.zeros((1,), dtype=torch.int32, device=dev),
            mu=torch.zeros((c,), dtype=torch.float32, device=dev),
            nu=torch.zeros((c,), dtype=torch.float32, device=dev))

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("sharded_adamw requires params in update()")
        ps = _set()
        n, rank = ps.size(), ps.rank()
        c = state.mu.shape[0]
        flat_g = _flatten(grads)
        length = flat_g.shape[0]
        if c != -(-length // n):
            raise ValueError(
                f"sharded_adamw: the state's chunks of {c} are not "
                f"ceil({length}/{n}) for {length} gradient elements over "
                f"{n} ranks; init() the state over this set")
        pad = n * c - length
        # Reduce-scatter: the mean gradient, each rank keeping its chunk.
        g_chunk = C._in_step_reducescatter(
            torch.nn.functional.pad(flat_g, (0, pad)), ps,
            name="sharded_adamw/grads")
        g_chunk = true_div(g_chunk, n)
        p_chunk = torch.nn.functional.pad(_flatten(params), (0, pad))[
            rank * c:(rank + 1) * c]
        upd_chunk, (step, mu, nu) = _adamw_chunk_update(
            g_chunk, state, p_chunk, learning_rate, b1, b2, eps,
            weight_decay)
        # All-gather the updated chunks back to a whole update tree.
        full = C._in_step_allgather(upd_chunk, ps,
                                    name="sharded_adamw/updates")[:length]
        return _unflatten(full, grads), ShardedAdamWState(step, mu, nu)

    return GradientTransformation(init, update)
