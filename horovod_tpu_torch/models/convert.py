"""Parameter conversion from the JAX package's GPT-2 to this port's.

``gpt2_params_from_jax`` maps the flax parameter tree of
``horovod_tpu.models.gpt2.GPT2`` (``model.init(...)["params"]``, as numpy
arrays; nested dicts or "/"-joined keys) onto the ``state_dict`` of
``horovod_tpu_torch.models.gpt2.GPT2``. Flax ``Dense`` kernels are
(in, out); the port stores ``nn.Linear``-style (out, in) weights, so kernels
are transposed. LayerNorm ``scale`` becomes ``weight``. Nothing here imports
JAX: the caller hands over numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["gpt2_params_from_jax", "flatten_tree"]


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
    if parts[0].startswith("h") and parts[0][1:].isdigit():
        parts = ["h", parts[0][1:]] + parts[1:]
    leaf = parts[-1]
    if leaf == "kernel":
        parts[-1] = "weight"
    elif leaf == "scale":
        parts[-1] = "weight"
    return ".".join(parts)


def gpt2_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax GPT-2 params -> the port's ``state_dict`` (fp32 tensors)."""
    flat = flatten_tree(params) if any(
        isinstance(v, Mapping) for v in params.values()) else dict(params)
    out: Dict[str, torch.Tensor] = {}
    for key, val in flat.items():
        arr = np.asarray(val, dtype=np.float32)
        if key.endswith("/kernel"):
            if arr.ndim != 2:
                raise ValueError(f"{key}: expected a 2-D Dense kernel, got "
                                 f"shape {arr.shape}")
            arr = arr.T
        out[_port_name(key)] = torch.tensor(np.ascontiguousarray(arr))
    return out
