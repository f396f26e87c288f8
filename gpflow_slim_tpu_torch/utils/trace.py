"""Program spans and a host-sync counter, off unless turned on.

The port names its layers in ``torch.profiler``'s trace with spans
``gfs.<layer>[.fwd|.bwd]`` (``named_scope``), on the same timeline as the
CUDA runtime calls and the device's kernels. Spans cost nothing but one
check of a module-level flag until ``enable()`` (or ``traced()``) turns
them on; then each is a ``torch.profiler.record_function``.

Spans, and what each holds:

- ``gfs.gram.fwd``/``.bwd``, ``gfs.gram_lower.fwd``/``.bwd``,
  ``gfs.gram_operand.fwd``/``.bwd``, ``gfs.nkn_operand.fwd``/``.bwd``,
  ``gfs.cholesky.fwd``/``.bwd``, ``gfs.chol_solve_logdet.fwd``/``.bwd``,
  ``gfs.trsm.fwd``/``.bwd``: the forward and the backward of each autograd
  Function of ``ops.gram``, ``ops.nkn``, ``ops.cholesky`` and ``ops.trsm``
  (the cross Gram, the lower-tile Gram, the Cholesky operand, the NKN's
  Cholesky operand, the factor-only Cholesky, the fused
  factor/solve/logdet, the TRSM). A backward runs on autograd's device
  thread for CUDA tensors, so its span lies on that thread; ``_Trsm``'s
  backward nests a ``gfs.trsm.fwd``.
- ``gfs.gpr.likelihood`` (``GPR.build_likelihood``), ``gfs.gpr.posterior``
  (``GPR.posterior``), ``gfs.posterior.predict_f``
  (``GPRPosterior.predict_f``), ``gfs.step.update`` (the optimizer's step
  in ``training.optimize.make_step_fn``).

``host_syncs`` counts, while tracing is on, every call that makes the host
wait for the card (``.item()``, ``bool()``, a device-to-host copy, also
inside a torch op) made while one of the program's spans is open on the
calling thread: the card's sync debug mode is set to "warn" while on, and
its warnings are counted (and not shown) instead of printed. Syncs outside
every program span, a caller's own ``.cpu()`` included, are not counted.
On a machine without a card it stays 0.

An operator runs their own loop under the profiler with tracing on::

    from torch.profiler import ProfilerActivity, profile
    from gpflow_slim_tpu_torch import utils

    with utils.traced(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            step_fn()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20))
    print(utils.trace.host_syncs)

This module imports nothing else of the package, so ``ops`` can import it.
"""

from __future__ import annotations

import contextlib
import threading
import warnings

import torch

__all__ = ["named_scope", "enable", "disable", "traced", "enabled", "host_syncs"]

# the warning torch gives for each synchronizing call in sync debug mode "warn"
SYNC_WARNING = "called a synchronizing CUDA operation"

host_syncs = 0
_on = False
_NOOP = contextlib.nullcontext()
_local = threading.local()  # .depth: program spans open on this thread
_restore = None  # (warnings' saved state, the sync debug mode) while on with a card


class _Span:
    """A program span: a ``record_function`` that also marks the thread as
    inside the program, for ``host_syncs``."""

    __slots__ = ("_rf",)

    def __init__(self, name):
        self._rf = torch.profiler.record_function(name)

    def __enter__(self):
        _local.depth = getattr(_local, "depth", 0) + 1
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        _local.depth -= 1
        return False


def named_scope(name: str):
    """A named range of the program in ``torch.profiler``'s trace
    (``jax.named_scope``'s role): ``with named_scope("gfs.gram.fwd"): ...``.
    With tracing off, one shared no-op context."""
    if not _on:
        return _NOOP
    return _Span(name)


def enabled() -> bool:
    return _on


def _count_sync(show):
    def showwarning(message, category, filename, lineno, file=None, line=None):
        global host_syncs
        if str(message).startswith(SYNC_WARNING):
            if getattr(_local, "depth", 0):
                host_syncs += 1
            return
        show(message, category, filename, lineno, file, line)

    return showwarning


def enable():
    """Turn the program's spans and its host-sync counter on."""
    global _on, _restore
    if _on:
        return
    if torch.cuda.is_available():
        saved = warnings.catch_warnings()
        saved.__enter__()
        # every sync reaches the counter: no "once per location"
        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.showwarning = _count_sync(warnings.showwarning)
        _restore = (saved, torch.cuda.get_sync_debug_mode())
        torch.cuda.set_sync_debug_mode("warn")
    _on = True


def disable():
    """Turn spans and the counter off, and restore the card's sync debug
    mode and the warnings' filters as ``enable()`` found them."""
    global _on, _restore
    _on = False
    if _restore is not None:
        saved, mode = _restore
        _restore = None
        torch.cuda.set_sync_debug_mode(mode)
        saved.__exit__(None, None, None)


@contextlib.contextmanager
def traced():
    """Tracing on inside the block, as it was after it."""
    was = _on
    enable()
    try:
        yield
    finally:
        if not was:
            disable()
