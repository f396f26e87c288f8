"""Model base classes (counterpart of ``gpflow_slim_tpu.models.model``).

``Model.objective() = -(build_likelihood() + log_prior())``, the sign
convention of the reference. A training step is plain PyTorch::

    loss = model.objective()
    loss.backward()

``GPModel`` holds the data ``X`` and ``Y`` as buffers and moves itself,
data and parameters, to one explicit device and dtype. The predictive API
comes with slice 2.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mean_functions import Zero
from ..params import Module

_FLOAT_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def _data_dtype(X) -> torch.dtype:
    """The dtype the data was given in; float64 for anything else."""
    if isinstance(X, torch.Tensor) and X.dtype in (torch.float32, torch.float64):
        return X.dtype
    if isinstance(X, np.ndarray):
        return _FLOAT_DTYPES.get(X.dtype, torch.float64)
    return torch.float64


class Model(Module):
    def __init__(self, name="model"):
        super().__init__()
        self.name = name

    def build_likelihood(self):
        raise NotImplementedError

    def objective(self):
        """Negative (log-likelihood + log-prior); minimize this."""
        return -(self.build_likelihood() + self.log_prior())

    def log_posterior(self):
        """build_likelihood + log_prior (for MCMC); = -objective."""
        return self.build_likelihood() + self.log_prior()


class GPModel(Model):
    """A GP model on data ``X`` (N, D) and ``Y`` (N, P).

    ``device`` and ``dtype`` place the data and every parameter; ``dtype``
    defaults to the float dtype the data was given in (float64 otherwise).
    """

    def __init__(self, X, Y, kern, likelihood, mean_function=None, num_latent=None,
                 name="gp_model", device=None, dtype=None):
        super().__init__(name=name)
        dtype = dtype if dtype is not None else _data_dtype(X)
        X = torch.as_tensor(X, dtype=dtype, device=device)
        Y = torch.as_tensor(Y, dtype=dtype, device=device)
        if X.dim() != 2 or Y.dim() != 2:
            raise ValueError(
                f"X and Y must be rank-2 (N, D)/(N, P); got X {tuple(X.shape)}, Y {tuple(Y.shape)}"
            )
        if X.shape[0] != Y.shape[0]:
            raise ValueError(
                f"X and Y must agree on N; got X {tuple(X.shape)}, Y {tuple(Y.shape)}"
            )
        self.register_buffer("X", X)
        self.register_buffer("Y", Y)
        self.kern = kern
        self.likelihood = likelihood
        self.mean_function = mean_function if mean_function is not None else Zero()
        self.num_latent = int(num_latent if num_latent is not None else Y.shape[1])
        self.to(device=X.device, dtype=dtype)
