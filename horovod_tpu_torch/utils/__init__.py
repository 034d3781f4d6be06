"""Utilities of the port: the training-loop heartbeat watchdog."""

from horovod_tpu_torch.utils.stall import HealthWatchdog

__all__ = ["HealthWatchdog"]
