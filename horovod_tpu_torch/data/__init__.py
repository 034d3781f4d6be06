"""Data utilities of the port: sequence packing."""

from horovod_tpu_torch.data.packing import pack_documents, pack_rows

__all__ = ["pack_documents", "pack_rows"]
