"""Global numeric settings (counterpart of ``gpflow_slim_tpu.config``).

One immutable ``Settings`` snapshot plus a context-manager override. There
is no x64 switch: the dtype of every computation is the dtype of the
tensors it is given (float64 for CPU parity, float32 on the card).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Settings:
    """Immutable numeric configuration.

    Attributes:
      jitter: diagonal jitter for float64 factorizations.
      jitter_f32: jitter floor for float32 factorizations.
      positive_minimum: lower shift of the default positive transform.
      num_gauss_hermite_points: quadrature order for likelihood expectations.
      use_kernels: route CUDA float32 tensors through the hand-written CUDA
        kernels (``ops.gram``, ``ops.cholesky``); ``ops.linalg.kernels_active``
        reads it. Off, or for CPU and float64 tensors, ``ops.linalg`` runs the
        plain PyTorch composite instead.
    """

    jitter: float = 1e-6
    jitter_f32: float = 1e-4
    positive_minimum: float = 1e-6
    num_gauss_hermite_points: int = 20
    use_kernels: bool = True


_settings = Settings()


def settings() -> Settings:
    """Current global settings (immutable snapshot)."""
    return _settings


def set_settings(new: Settings) -> None:
    global _settings
    _settings = new


@contextlib.contextmanager
def temp_settings(**overrides):
    """Temporarily override settings fields."""
    global _settings
    old = _settings
    _settings = dataclasses.replace(old, **overrides)
    try:
        yield _settings
    finally:
        _settings = old


def default_jitter(dtype: torch.dtype) -> float:
    """Dtype-aware jitter: 1e-6 for float64, at least 1e-4 for float32."""
    if dtype == torch.float64:
        return _settings.jitter
    return max(_settings.jitter, _settings.jitter_f32)
