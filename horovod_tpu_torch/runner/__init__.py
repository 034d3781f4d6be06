"""Local launcher for multi-process runs (``python -m
horovod_tpu_torch.runner -np N script.py``)."""

from horovod_tpu_torch.runner.launcher import free_port, run, worker_env

__all__ = ["free_port", "run", "worker_env"]
