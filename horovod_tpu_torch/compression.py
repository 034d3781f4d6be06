"""Gradient compression for collectives.

Port of ``horovod_tpu/compression.py``. The cast compressors put floating
tensors on the wire as fp16 or bf16 and cast the result back. The quantized
wire formats (``int8``, ``fp8``) are markers: a cast cannot express them
(the sum of quantized values overflows and mixes scales), so the
collective layer (``collective.py``) reroutes a marked allreduce through
the two-phase quantized allreduce of ``ops/quantized.py``. Float tensors
are quantized with per-block scales, each padded to whole blocks; integer
tensors take the exact reduction. The same wires are spelled on the
``algorithm=`` axis too (``algorithm="chunked_rs_ag_int8"``,
``HOROVOD_ALLREDUCE_WIRE``).
"""

from __future__ import annotations

import torch

__all__ = ["Compressor", "NoneCompressor", "FP16Compressor", "BF16Compressor",
           "Int8Compressor", "FP8Compressor", "Compression"]


class Compressor:
    """Interface: ``compress(tensor) -> (compressed, ctx)``;
    ``decompress(compressed, ctx) -> tensor``."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    _wire_dtype: torch.dtype = None

    @classmethod
    def compress(cls, tensor):
        ctx = tensor.dtype
        if tensor.is_floating_point() and ctx != cls._wire_dtype:
            return tensor.to(cls._wire_dtype), ctx
        return tensor, ctx

    @classmethod
    def decompress(cls, tensor, ctx):
        if ctx is not None and tensor.dtype != ctx:
            return tensor.to(ctx)
        return tensor


class FP16Compressor(_CastCompressor):
    _wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    _wire_dtype = torch.bfloat16


class _QuantizedMarker(Compressor):
    """Marker of a quantized wire format; the collective layer reads
    ``wire`` and quantizes inside the reduction, so the compressor itself
    passes tensors through."""
    wire = None  # "int8" | "fp8"

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class Int8Compressor(_QuantizedMarker):
    wire = "int8"


class FP8Compressor(_QuantizedMarker):
    wire = "fp8"


class Compression:
    """Namespace matching ``hvd.Compression``."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    fp8 = FP8Compressor
