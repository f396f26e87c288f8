"""Checkpoints, metrics logging and debugging helpers (counterpart of
``gpflow_slim_tpu.utils``)."""

from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .logging import MetricsLogger
from .misc import check_determinism, debug_nans, named_scope, print_summary

__all__ = [
    "save_checkpoint", "load_checkpoint", "latest_checkpoint",
    "MetricsLogger", "named_scope", "debug_nans", "check_determinism",
    "print_summary",
]
