"""Parameter conversion from the JAX package's models to this port's.

``gpt2_params_from_jax`` maps the flax parameter tree of
``horovod_tpu.models.gpt2.GPT2`` (``model.init(...)["params"]``, as numpy
arrays; nested dicts or "/"-joined keys) onto the ``state_dict`` of
``horovod_tpu_torch.models.gpt2.GPT2``. Flax ``Dense`` kernels are
(in, out); the port stores ``nn.Linear``-style (out, in) weights, so kernels
are transposed. LayerNorm ``scale`` becomes ``weight``.

``bert_params_from_jax``, ``vit_params_from_jax`` and
``llama_params_from_jax`` do the same for the reference's ``Bert``, ``ViT``
and ``Llama``: a numbered module (``layer3``, ``block3``, ``h3``) becomes a
list entry (``layer.3``), RMSNorm ``scale`` becomes ``weight``, and ViT's
patchify kernel (kh, kw, in, out) becomes (out, in, kh, kw).

``resnet_params_from_jax`` and ``mnist_params_from_jax`` do the same for
``horovod_tpu.models.resnet.ResNet`` (with its ``batch_stats``) and
``horovod_tpu.models.mnist.MnistCNN``: conv kernels (kh, kw, in, out)
become (out, in, kh, kw), ``Dense`` kernels are transposed, BN ``scale``
becomes ``weight`` and ``batch_stats`` ``mean``/``var`` become the
``running_mean``/``running_var`` buffers. Nothing here imports JAX: the
caller hands over numpy arrays.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["gpt2_params_from_jax", "bert_params_from_jax",
           "vit_params_from_jax", "llama_params_from_jax",
           "resnet_params_from_jax", "mnist_params_from_jax", "flatten_tree"]


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested mapping -> {"a/b/c": leaf}."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, key + "/"))
        else:
            out[key] = v
    return out


def _port_name(key: str) -> str:
    parts = key.split("/")
    numbered = re.fullmatch(r"([a-z]+)(\d+)", parts[0])
    if numbered:
        parts = list(numbered.groups()) + parts[1:]
    leaf = parts[-1]
    if leaf == "kernel":
        parts[-1] = "weight"
    elif leaf == "scale":
        parts[-1] = "weight"
    return ".".join(parts)


def _flat(tree: Mapping[str, Any]) -> Dict[str, Any]:
    return flatten_tree(tree) if any(
        isinstance(v, Mapping) for v in tree.values()) else dict(tree)


def gpt2_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax GPT-2, BERT, ViT or Llama params -> the port's ``state_dict``
    (fp32 tensors): one mapping serves the four models."""
    return {_port_name(key): _tensor(key, val)
            for key, val in _flat(params).items()}


# The same mapping under each model's name.
bert_params_from_jax = vit_params_from_jax = llama_params_from_jax = \
    gpt2_params_from_jax


def _tensor(key: str, val) -> torch.Tensor:
    """A flax leaf in the port's layout: conv kernels (kh, kw, in, out) ->
    (out, in, kh, kw), ``Dense`` kernels (in, out) -> (out, in)."""
    arr = np.asarray(val, dtype=np.float32)
    if key.endswith("/kernel"):
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:
            arr = arr.T
        else:
            raise ValueError(f"{key}: expected a conv or Dense kernel, got "
                             f"shape {arr.shape}")
    return torch.tensor(np.ascontiguousarray(arr))


_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}

# flax's auto-names for a block's convs and norms: Conv_i, and BatchNorm_i,
# SyncBatchNorm_i or TunableBatchNorm_i by the BN in use.
_BLOCK_PART = re.compile(r"(Conv|BatchNorm|SyncBatchNorm|TunableBatchNorm)"
                         r"_(\d+)$")


def _resnet_name(key: str) -> str:
    *path, leaf = key.split("/")
    if path == ["Dense_0"]:
        path = ["head"]
    elif len(path) == 2 and re.fullmatch(r"(Bottleneck|Basic)Block_\d+",
                                         path[0]):
        m = _BLOCK_PART.match(path[1])
        part = path[1] if m is None else (
            ("conv" if m.group(1) == "Conv" else "bn") + m.group(2))
        path = ["blocks", path[0].rsplit("_", 1)[1], part]
    elif path not in (["conv_init"], ["bn_init"]):
        raise ValueError(f"{key}: not a parameter of the JAX ResNet")
    return ".".join(path + [_LEAF[leaf]])


def resnet_params_from_jax(params: Mapping[str, Any],
                           batch_stats: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """flax ResNet ``params`` and ``batch_stats`` -> the port's
    ``state_dict`` (fp32 tensors), for ``load_state_dict(strict=True)``."""
    out: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for key, val in _flat(tree).items():
            out[_resnet_name(key)] = _tensor(key, val)
    return out


def mnist_params_from_jax(params: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """flax ``MnistCNN`` params -> the port's ``state_dict``: ``Conv_i`` ->
    ``conv{i}``, ``Dense_i`` -> ``dense{i}``."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in _flat(params).items():
        mod, leaf = key.split("/")
        kind, i = mod.split("_")
        out[f"{kind.lower()}{i}.{_LEAF[leaf]}"] = _tensor(key, val)
    return out
