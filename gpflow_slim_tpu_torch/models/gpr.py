"""Exact Gaussian-process regression (counterpart of ``gpflow_slim_tpu.models.gpr``).

The log marginal likelihood comes from ``ops.linalg.gpr_chol_terms``: on
CUDA float32 tensors the one-pass operand kernel feeding the fused
factor/solve/logdet kernel, elsewhere the plain ``torch.linalg`` composite.
``posterior`` and ``build_predict`` come with slice 2.
"""

from __future__ import annotations

import math

import torch

from ..likelihoods import Gaussian
from ..ops import linalg
from .model import GPModel


class GPR(GPModel):
    def __init__(self, X, Y, kern, mean_function=None, name="gpr", device=None, dtype=None):
        likelihood = Gaussian(name=f"{name}/likelihood")
        super().__init__(X, Y, kern, likelihood, mean_function, name=name,
                         device=device, dtype=dtype)

    def build_likelihood(self):
        """log p(Y | theta) = MVN(Y; m(X), K + noise I), summed over columns."""
        N = self.X.shape[0]
        d = self.Y - self.mean_function(self.X)
        noise = torch.squeeze(self.likelihood.variance.value)
        half_logdet, quad = linalg.gpr_chol_terms(self.kern, self.X, noise, d)
        num_col = d.shape[1] if d.dim() > 1 else 1
        return (
            -0.5 * N * num_col * math.log(2.0 * math.pi)
            - num_col * half_logdet
            - 0.5 * quad
        )
