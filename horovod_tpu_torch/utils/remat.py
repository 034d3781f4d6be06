"""Rematerialization of transformer blocks: the port of
``horovod_tpu/utils/compat.py``'s ``remat_policy`` and of the models'
``nn.remat`` call sites (GPT-2, Llama, BERT and T5 share :func:`maybe_remat`).

* ``"full"``: the block runs under ``torch.utils.checkpoint.checkpoint``
  (non-reentrant); the backward recomputes the whole block.
* ``"dots"``: the same call with a selective-checkpoint ``context_fn`` whose
  policy saves what ``jax.checkpoint_policies.
  dots_with_no_batch_dims_saveable`` saves: the outputs of matrix products
  with no batch dimension, which in PyTorch are ``aten.mm`` and
  ``aten.addmm`` (a ``Dense`` layer's ``F.linear`` reaches one of the two;
  an einsum with batch dimensions reaches ``aten.bmm``, which is recomputed,
  as are norms, activations and masks).

The flash kernels launch through ``ctypes``, outside the dispatcher, so no
policy sees them: under either policy the forward kernel runs again in the
backward (as the reference's ``pallas_call`` does, not being a dot).
Anything a block returns besides its output (the MoE aux loss) must leave
through the checkpointed function's return value.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

__all__ = ["SAVED_OPS", "dots_policy", "remat_context", "maybe_remat"]

# Matrix products without a batch dimension: what "dots" saves.
SAVED_OPS = frozenset({torch.ops.aten.mm.default,
                       torch.ops.aten.addmm.default})


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Selective-checkpoint policy: save ``mm``/``addmm`` outputs, recompute
    everything else."""
    if op in SAVED_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(dots_policy)


def remat_context(cfg):
    """The ``context_fn`` of ``cfg.remat_policy`` (None for ``"full"``);
    any other name raises the reference's ``ValueError``."""
    if cfg.remat_policy == "dots":
        return _dots_context
    if cfg.remat_policy == "full":
        return None
    raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}: "
                     "expected 'full' or 'dots'")


def maybe_remat(cfg, block):
    """``block`` itself without ``cfg.remat``; else a callable with its
    signature that runs it under the checkpoint of ``cfg.remat_policy``."""
    if not cfg.remat:
        return block
    context_fn = remat_context(cfg)
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return functools.partial(checkpoint, block, use_reentrant=False, **kw)
