"""Model base classes (counterpart of ``gpflow_slim_tpu.models.model``).

``Model.objective() = -(build_likelihood() + log_prior())``, the sign
convention of the reference. A training step is plain PyTorch::

    loss = model.objective()
    loss.backward()

``GPModel`` holds the data ``X`` and ``Y`` as buffers and moves itself,
data and parameters, to one device and dtype: the CUDA device unless the
caller asks for another (``device="cpu"``). It adds the
predictive API: ``predict_f`` (-> ``build_predict``), ``predict_f_full_cov``,
``predict_f_samples``, ``predict_y`` and ``predict_density``, routed through
the likelihood as the reference does. ``full_cov=True`` predictions have
shape (P, N, N).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
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


def as_tensor_like(A, like):
    """``A`` (array or tensor) as a tensor of ``like``'s dtype and device."""
    return torch.as_tensor(A, dtype=like.dtype, device=like.device)


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

    # reference-API aliases (GPflow-1.x `compute_*` autoflow names)
    def compute_log_likelihood(self):
        return self.build_likelihood()

    def compute_log_prior(self):
        return self.log_prior()


class GPModel(Model):
    """A GP model on data ``X`` (N, D) and ``Y`` (N, P).

    ``device`` and ``dtype`` place the data and every parameter. ``device``
    defaults to CUDA, and without a CUDA device leaving it out raises: the
    port runs on the card unless the caller asks for the CPU. ``dtype``
    defaults to the float dtype the data was given in (float64 otherwise).
    """

    def __init__(self, X, Y, kern, likelihood, mean_function=None, num_latent=None,
                 name="gp_model", device=None, dtype=None):
        super().__init__(name=name)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError('no CUDA device: pass device="cpu" to build the model on the CPU')
            device = "cuda"
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

    # -- to be provided by concrete models ---------------------------------
    def build_predict(self, Xnew, full_cov=False):
        raise NotImplementedError

    # -- public predictive API (reference names) ---------------------------
    def predict_f(self, Xnew):
        """Mean and variance of the latent f at Xnew: (N*, P), (N*, P)."""
        return self.build_predict(Xnew, full_cov=False)

    def predict_f_full_cov(self, Xnew):
        """Mean (N*, P) and full covariance (P, N*, N*) of latent f."""
        return self.build_predict(Xnew, full_cov=True)

    def predict_f_samples(self, Xnew, num_samples, generator=None):
        """Joint samples of f at Xnew: (num_samples, N*, P). ``generator``
        (a ``torch.Generator`` on the model's device) takes the place of the
        JAX key."""
        mu, var = self.build_predict(Xnew, full_cov=True)  # (N, P), (P, N, N)
        N = mu.shape[0]
        eye = config.default_jitter(mu.dtype) * torch.eye(N, dtype=mu.dtype, device=mu.device)
        L = torch.linalg.cholesky(var + eye)
        V = torch.randn((self.num_latent, N, num_samples), generator=generator, dtype=mu.dtype,
                        device=mu.device)
        samples = mu.T[:, :, None] + L @ V  # (P, N, S)
        return samples.permute(2, 1, 0)  # (S, N, P)

    def predict_y(self, Xnew):
        """Mean and variance of observations y at Xnew."""
        pred_f_mean, pred_f_var = self.build_predict(Xnew, full_cov=False)
        return self.likelihood.predict_mean_and_var(pred_f_mean, pred_f_var)

    def predict_density(self, Xnew, Ynew):
        """Log predictive density of Ynew at Xnew."""
        pred_f_mean, pred_f_var = self.build_predict(Xnew, full_cov=False)
        return self.likelihood.predict_density(pred_f_mean, pred_f_var,
                                                  as_tensor_like(Ynew, self.X))
