"""The launcher: ``python -m horovod_tpu_torch.runner`` (``horovodrun``),
``run``, ``run_func`` and ``run_elastic`` (see ``launcher.py``)."""

from horovod_tpu_torch.runner.launcher import (
    HostSpec, WorkerFailed, build_worker_env, free_port, parse_hosts, run,
    run_elastic, run_func, worker_commands)

__all__ = ["HostSpec", "WorkerFailed", "build_worker_env", "free_port",
           "parse_hosts", "run", "run_elastic", "run_func",
           "worker_commands"]
