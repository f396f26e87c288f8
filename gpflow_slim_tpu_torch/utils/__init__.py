"""Checkpoints, metrics logging, program spans and debugging helpers (counterpart of
``gpflow_slim_tpu.utils``)."""

from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .logging import MetricsLogger
from . import trace
from .misc import check_determinism, debug_nans, print_summary
from .trace import named_scope, traced

__all__ = [
    "save_checkpoint", "load_checkpoint", "latest_checkpoint",
    "MetricsLogger", "named_scope", "traced", "trace", "debug_nans",
    "check_determinism", "print_summary",
]
