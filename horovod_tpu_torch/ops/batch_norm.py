"""Batch norm with flax's semantics and a tunable statistics dtype, and the
space-to-depth stem transform.

Port of ``horovod_tpu/ops/batch_norm.py`` and ``ops/sync_batch_norm.py``
for NCHW tensors:

* :func:`space_to_depth` re-lays (N, C, H, W) as (N, b·b·C, H/b, W/b) with
  output channel order ``(a, b, c)``, the order
  ``models.resnet.convert_stem_weights`` relies on.
* :class:`TunableBatchNorm` is flax's ``BatchNorm`` (the JAX ResNet's
  ``nn.BatchNorm``, ``SyncBatchNorm`` and ``TunableBatchNorm``): the
  moments are E[x] and E[x²] taken in ``stats_dtype``, var = max(E[x²] −
  E[x]², 0), the running statistics are fp32 and move as ``ra = m·ra +
  (1 − m)·batch`` with the *biased* batch variance (torch's ``BatchNorm``
  uses the unbiased one and momentum 1 − m, so the statistics are this
  module's own code), and the output is in ``dtype``. A ``process_set``
  averages E[x] and E[x²] over the set's ranks (the reference's
  ``axis_name`` pmean); the backward averages their cotangents over the
  same set, the transpose of that mean.

This path has no TPU kernel: the reference computes it outside Pallas.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from horovod_tpu_torch import collective as C

__all__ = ["space_to_depth", "TunableBatchNorm"]


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(N, C, H, W) -> (N, b·b·C, H/b, W/b); output channel ``(a, b, c)``
    row-major: row offset ``a``, column offset ``b``, then the original
    channel."""
    n, c, h, w = x.shape
    if h % block or w % block:
        raise ValueError(f"spatial dims {(h, w)} not divisible by "
                         f"block {block}")
    x = x.reshape(n, c, h // block, block, w // block, block)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, block * block * c, h // block, w // block)


class _SetMean(torch.autograd.Function):
    """The mean of a tensor over a process set's ranks; its backward takes
    the mean of the cotangents over the same set."""

    @staticmethod
    def forward(ctx, x, process_set):
        ctx.process_set = process_set
        return _average(x, process_set)

    @staticmethod
    def backward(ctx, g):
        return _average(g.contiguous(), ctx.process_set), None


def _average(x: torch.Tensor, process_set) -> torch.Tensor:
    # fp32 on the wire whatever the statistics' dtype.
    return C.allreduce(x.float(), op=C.Average,
                       process_set=process_set).to(x.dtype)


class TunableBatchNorm(nn.Module):
    """flax ``BatchNorm`` over dim 1 of an (N, C, ...) tensor.

    ``weight``/``bias`` are fp32 parameters (flax's ``scale``/``bias``;
    ``zero_scale`` starts the scale at 0, ``scale_init=zeros``);
    ``running_mean``/``running_var`` are fp32 buffers (``batch_stats``).
    ``momentum`` is flax's (0.9 keeps 90 % of the old statistics).
    Training mode (``self.training``) normalizes by the batch, eval mode
    by the running statistics.
    """

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 stats_dtype: torch.dtype = torch.float32,
                 process_set=None, zero_scale: bool = False):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.stats_dtype = stats_dtype
        self.process_set = process_set
        self.weight = nn.Parameter(torch.zeros(num_features) if zero_scale
                                   else torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sd = self.stats_dtype
        shape = [1, -1] + [1] * (x.dim() - 2)
        xs = x.to(sd)
        if self.training:
            dims = [0] + list(range(2, x.dim()))
            mean = xs.mean(dims)
            mean2 = (xs * xs).mean(dims)
            if self.process_set is not None:
                mean, mean2 = _SetMean.apply(torch.stack([mean, mean2]),
                                             self.process_set)
            var = (mean2 - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(
                    m * self.running_mean + (1 - m) * mean.float())
                self.running_var.copy_(
                    m * self.running_var + (1 - m) * var.float())
        else:
            mean, var = self.running_mean, self.running_var
        y = (xs - mean.to(sd).view(shape)) * torch.rsqrt(
            var.to(sd).view(shape) + self.eps)
        y = y * self.weight.to(sd).view(shape) + self.bias.to(sd).view(shape)
        return y.to(x.dtype if self.dtype is None else self.dtype)
