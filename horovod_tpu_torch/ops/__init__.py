"""Operators of the port: attention dispatch and the flash-attention
kernels (CUDA C++ under ``csrc/``, built at first use by ``_build.py``)."""
