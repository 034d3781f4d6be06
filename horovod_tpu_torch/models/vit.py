"""ViT as a PyTorch ``nn.Module``.

Port of ``horovod_tpu/models/vit.py`` (the reference's "ViT-B/16"
configuration) with the reference's numerics, in the layers of ``gpt2.py``
and ``resnet.py``:

* images are NCHW, as the ResNet port takes them (the reference takes
  NHWC); patchify is one stride-``patch_size`` convolution with a bias, in
  ``cfg.dtype``, whose (H/p, W/p) outputs become the tokens in row-major
  order;
* a learned ``cls`` token (zeros at init) goes first and ``pos_embed``
  covers the ``(image_size / patch_size)^2 + 1`` positions (197 for
  ViT-B/16); both are fp32 parameters added in ``cfg.dtype``;
* the blocks are pre-LN with fp32 LayerNorms (flax's, eps 1e-6), a fused
  ``qkv`` projection, non-causal attention without a mask, a tanh-GELU
  MLP, and the residual stream in ``cfg.dtype``;
* the head reads the ``cls`` token after the final LayerNorm, in fp32.

``models/convert.py`` carries the reference's parameters over
(``vit_params_from_jax``: flax's (16, 16, 3, 768) patchify kernel becomes
torch's (768, 3, 16, 16)).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.models.gpt2 import Dense, LayerNorm
from horovod_tpu_torch.models.resnet import Conv
from horovod_tpu_torch.ops.attention import (ATTENTION_IMPLS,
                                             multihead_attention)

__all__ = ["ViTConfig", "ViTBlock", "ViT"]

# flax nn.LayerNorm's default epsilon.
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    mlp_dim: int = 3072
    dtype: torch.dtype = torch.bfloat16
    attention: str = "dense"         # "dense" | "flash"
    flash_blocks: Optional[tuple] = None

    @staticmethod
    def b16(**kw) -> "ViTConfig":
        return ViTConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "ViTConfig":
        return ViTConfig(image_size=32, patch_size=8, num_classes=10,
                         num_layers=2, num_heads=4, d_model=64, mlp_dim=128,
                         **kw)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.ln1 = LayerNorm(d, LN_EPS)
        self.qkv = Dense(d, 3 * d, cfg.dtype)
        self.out = Dense(d, d, cfg.dtype)
        self.ln2 = LayerNorm(d, LN_EPS)
        self.fc = Dense(d, cfg.mlp_dim, cfg.dtype)
        self.proj = Dense(cfg.mlp_dim, d, cfg.dtype)

    def forward(self, x):
        cfg = self.cfg
        b, t, d = x.shape
        h = cfg.num_heads
        q, k, v = self.qkv(self.ln1(x)).split(d, dim=-1)
        att = multihead_attention(
            q.reshape(b, t, h, d // h), k.reshape(b, t, h, d // h),
            v.reshape(b, t, h, d // h), impl=cfg.attention, causal=False,
            out_dtype=cfg.dtype, flash_blocks=cfg.flash_blocks)
        x = x + self.out(att.reshape(b, t, d))
        y = self.fc(self.ln2(x))
        return x + self.proj(F.gelu(y, approximate="tanh"))


class ViT(nn.Module):
    """``forward(images)`` on NCHW images -> fp32 logits (B, classes).

    ``generator`` (default: a CPU generator seeded with 0) draws the
    initial weights as the reference's initializers shape them.
    """

    def __init__(self, cfg: ViTConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.attention not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention impl {cfg.attention!r}; "
                             f"expected one of {ATTENTION_IMPLS}")
        if cfg.d_model % cfg.num_heads:
            raise ValueError(f"d_model {cfg.d_model} is not a multiple of "
                             f"num_heads {cfg.num_heads}")
        self.cfg = cfg
        d = cfg.d_model
        tokens = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.patchify = Conv(3, d, cfg.patch_size, cfg.patch_size,
                             bias=True, dtype=cfg.dtype)
        self.cls = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, tokens, d))
        self.block = nn.ModuleList(ViTBlock(cfg)
                                   for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(d, LN_EPS)
        self.head = Dense(d, cfg.num_classes, torch.float32)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.patchify.reset_parameters(generator)
        with torch.no_grad():
            self.cls.zero_()
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        for m in self.modules():
            if isinstance(m, Dense):
                m.reset_parameters(generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b = images.shape[0]
        x = self.patchify(images).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls.to(cfg.dtype).expand(b, 1, cfg.d_model), x],
                      dim=1)
        x = x + self.pos_embed.to(cfg.dtype)
        for block in self.block:
            x = block(x)
        x = self.ln_f(x)
        return self.head(x[:, 0].float())
