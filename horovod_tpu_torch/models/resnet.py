"""ResNet v1.5 as a PyTorch ``nn.Module``.

Port of ``horovod_tpu/models/resnet.py`` (the reference's headline:
ResNet-50 ImageNet training through ``DistributedOptimizer``) with the
reference's numerics:

* parameters are fp32; each conv casts its input and weight to ``dtype``
  (bf16 on the card), as flax ``nn.Conv(dtype=)`` does, and pads as flax's
  default ``"SAME"`` does: the strided 3x3 conv of a stage's first block
  pads (0, 1) on an even input, not (1, 1) (:func:`same_padding`);
* batch norm is ``ops.batch_norm.TunableBatchNorm`` with flax's semantics:
  local by default, cross-replica over ``bn_cross_replica`` (a process
  set), statistics in ``bn_stats_dtype`` (fp32 unless set);
* the last BN of each block starts with a zero scale; the stem is a 7x7/2
  conv (``stem="conv"``) or the space-to-depth 4x4/1 conv (``"s2d"``,
  :func:`convert_stem_weights` moves weights between the two); the 3x3/2
  max-pool pads with -inf; the head is the mean over H and W, then an fp32
  ``Dense``.

Tensors are NCHW; on the card put the input in ``torch.channels_last``
memory and the convolutions (cuDNN, ``F.conv2d``) keep it. The reference
runs this path outside any Pallas kernel, so it has no kernel of its own.
Initial weights follow flax's initializers (lecun normal) from a
``torch.Generator``; the bits differ from JAX's, so parity runs load a JAX
checkpoint with ``models.convert.resnet_params_from_jax``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.models.gpt2 import Dense
from horovod_tpu_torch.ops.batch_norm import TunableBatchNorm, space_to_depth

__all__ = ["same_padding", "Conv", "BottleneckBlock", "BasicBlock", "ResNet",
           "ResNet18", "ResNet50", "ResNet101", "ResNet152",
           "convert_stem_weights"]


def same_padding(n: int, k: int, s: int) -> Tuple[int, int]:
    """(low, high) padding of flax/XLA ``"SAME"`` for size ``n``, kernel
    ``k`` and stride ``s``."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal of variance 1/fan_in. (On a
    CPU this takes ~20 s for ResNet-50; build it on the card, under
    ``torch.device("cuda")`` with a CUDA generator.)"""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), (s, s), padding, use_bias,
    dtype)``: fp32 parameters, ``weight`` (out, in, k, k), the product in
    ``dtype``. ``padding`` is ``"SAME"`` or ((lo, hi), (lo, hi))."""

    def __init__(self, d_in: int, d_out: int, kernel: int, stride: int = 1,
                 padding="SAME", bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None
        self.stride = stride
        self.padding = padding
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, k, s = self.dtype, self.weight.shape[-1], self.stride
        if self.padding == "SAME":
            ph, pw = (same_padding(n, k, s) for n in x.shape[-2:])
        else:
            ph, pw = self.padding
        x = x.to(dt)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            pad = 0
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x, self.weight.to(dt), bias, s, pad)


class BottleneckBlock(nn.Module):
    """1x1, 3x3 (strided), 1x1 to 4x the filters; a projection where the
    shape changes."""
    expansion = 4

    def __init__(self, d_in: int, filters: int, stride: int, norm,
                 dtype: torch.dtype):
        super().__init__()
        d_out = filters * self.expansion
        self.conv0 = Conv(d_in, filters, 1, dtype=dtype)
        self.bn0 = norm(filters)
        self.conv1 = Conv(filters, filters, 3, stride, dtype=dtype)
        self.bn1 = norm(filters)
        self.conv2 = Conv(filters, d_out, 1, dtype=dtype)
        self.bn2 = norm(d_out, zero_scale=True)
        if d_in != d_out or stride != 1:
            self.conv_proj = Conv(d_in, d_out, 1, stride, dtype=dtype)
            self.norm_proj = norm(d_out)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        y = F.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        if hasattr(self, "conv_proj"):
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


class BasicBlock(nn.Module):
    """Two 3x3 convs (the first strided); a projection where the shape
    changes."""
    expansion = 1

    def __init__(self, d_in: int, filters: int, stride: int, norm,
                 dtype: torch.dtype):
        super().__init__()
        self.conv0 = Conv(d_in, filters, 3, stride, dtype=dtype)
        self.bn0 = norm(filters)
        self.conv1 = Conv(filters, filters, 3, dtype=dtype)
        self.bn1 = norm(filters, zero_scale=True)
        if d_in != filters or stride != 1:
            self.conv_proj = Conv(d_in, filters, 1, stride, dtype=dtype)
            self.norm_proj = norm(filters)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        y = self.bn1(self.conv1(y))
        if hasattr(self, "conv_proj"):
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


class ResNet(nn.Module):
    """``forward(images)`` -> fp32 logits (N, num_classes); ``images`` is
    (N, 3, H, W). Train or eval mode (``model.train()``/``.eval()``) picks
    batch or running statistics, as the reference's ``train`` argument.

    ``bn_cross_replica``: a process set whose ranks share the BN moments
    (None: local BN). ``bn_stats_dtype``: the moments' dtype (None: fp32,
    flax's ``BatchNorm``). ``generator`` (default: a CPU generator seeded
    with 0) draws the initial weights."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 bn_cross_replica=None,
                 bn_stats_dtype: Optional[torch.dtype] = None,
                 stem: str = "conv",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stem not in ("conv", "s2d"):
            raise ValueError(f"unknown stem {stem!r}; expected 'conv' or "
                             "'s2d'")
        self.dtype = dtype
        self.stem = stem
        norm = partial(TunableBatchNorm, momentum=0.9, eps=1e-5, dtype=dtype,
                       stats_dtype=bn_stats_dtype or torch.float32,
                       process_set=bn_cross_replica)
        if stem == "s2d":
            self.conv_init = Conv(12, num_filters, 4, 1, ((2, 1), (2, 1)),
                                  dtype=dtype)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2, ((3, 3), (3, 3)),
                                  dtype=dtype)
        self.bn_init = norm(num_filters)
        blocks, d_in = [], num_filters
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                filters = num_filters * 2 ** i
                blocks.append(block_cls(d_in, filters,
                                        2 if i > 0 and j == 0 else 1, norm,
                                        dtype))
                d_in = filters * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(d_in, num_classes, torch.float32)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (Conv, Dense)):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.stem == "s2d":
            x = space_to_depth(x, 2)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean(dim=(2, 3)))


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3],
                   block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3],
                    block_cls=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3],
                    block_cls=BottleneckBlock)


def convert_stem_weights(w7) -> np.ndarray:
    """Re-lay a (7, 7, C, F) stride-2 stem kernel (flax layout) for the
    space-to-depth stem: the (4, 4, 4C, F) kernel that computes the same
    convolution on ``space_to_depth(x, 2)`` with stride 1 and padding
    ((2, 1), (2, 1)). Tap ``(u, a)`` of the new kernel is tap
    ``di = 2u + a - 1`` of the old (``di = -1`` gets zero weight), and
    likewise for columns. numpy in, numpy out; for the port's (F, C, 7, 7)
    ``weight`` pass ``w.permute(2, 3, 1, 0)`` and permute the result back
    with ``(3, 2, 0, 1)``."""
    kh, kw, c, f = w7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"expected a 7x7 stem kernel, got {(kh, kw)}")
    w7 = np.asarray(w7)
    v = np.zeros((4, 4, 4 * c, f), w7.dtype)
    for u in range(4):
        for a in range(2):
            di = 2 * u + a - 1
            if not 0 <= di < 7:
                continue
            for vv in range(4):
                for b in range(2):
                    dj = 2 * vv + b - 1
                    if not 0 <= dj < 7:
                        continue
                    v[u, vv, (a * 2 + b) * c:(a * 2 + b + 1) * c] = \
                        w7[di, dj]
    return v
