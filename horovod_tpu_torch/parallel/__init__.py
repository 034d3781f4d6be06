"""Parallel layouts of the port. Only the topology part of
``horovod_tpu/parallel/mesh.py`` is ported so far (``mesh.py``)."""
