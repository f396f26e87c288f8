"""Likelihoods (counterpart of ``gpflow_slim_tpu.likelihoods``).

The base class computes ``predict_mean_and_var``, ``predict_density`` and
``variational_expectations`` by Gauss-Hermite quadrature (20 points by
default), with closed forms where the reference has them (an exp link's
variational expectations of ``Poisson``, ``Exponential`` and ``Gamma``, the
probit ``Bernoulli``'s predictions).

The reference's constants are kept: the probit link's clamp
``(1 - 2e-3) + 1e-3``, RobustMax's CDF clamp ``(1 - 2e-4) + 1e-4``,
Ordinal's ``+1e-6`` inside the log, and the ``_SAFE_Y`` that
``SwitchedLikelihood`` puts at another output's rows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import config, densities
from .quadrature import _grid, ndiagquad
from .params import Module, Param
from .transforms import positive

_ndtr = torch.special.ndtr


def one_hot(idx, K, dtype):
    """(N, K) one-hot rows of the integer column ``idx`` (N, 1), by a
    comparison: ``torch.nn.functional.one_hot`` syncs the host to check the
    indices' range. An index outside [0, K) gives a row of zeros, as
    ``jax.nn.one_hot`` does."""
    return (idx == torch.arange(K, device=idx.device)).to(dtype)

__all__ = ["Likelihood", "Gaussian", "Poisson", "Exponential", "StudentT", "Bernoulli", "Gamma", "Beta",
           "RobustMax", "MultiClass", "SwitchedLikelihood", "Ordinal", "probit",
           "inv_probit"]


class Likelihood(Module):
    def __init__(self, name="likelihood"):
        super().__init__()
        self.name = name
        self.num_gauss_hermite_points = config.settings().num_gauss_hermite_points

    def logp(self, F, Y):
        raise NotImplementedError

    def conditional_mean(self, F):
        raise NotImplementedError

    def conditional_variance(self, F):
        raise NotImplementedError

    # -- quadrature defaults ------------------------------------------------
    def predict_mean_and_var(self, Fmu, Fvar):
        def integrand2(f):
            return self.conditional_variance(f) + torch.square(self.conditional_mean(f))

        E_y, E_y2 = ndiagquad([self.conditional_mean, integrand2], self.num_gauss_hermite_points,
                              Fmu, Fvar)
        return E_y, E_y2 - torch.square(E_y)

    def predict_density(self, Fmu, Fvar, Y):
        return ndiagquad(self.logp, self.num_gauss_hermite_points, Fmu, Fvar, logspace=True, Y=Y)

    def variational_expectations(self, Fmu, Fvar, Y):
        return ndiagquad(self.logp, self.num_gauss_hermite_points, Fmu, Fvar, Y=Y)


def probit(x):
    """The reference's probit link, with its 1e-3 clamp."""
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0))) * (1 - 2e-3) + 1e-3


def inv_probit(x):
    """``probit`` under the reference's other name. A function of its own,
    as in the JAX package: a ``Bernoulli`` given it takes the quadrature
    path, as the JAX package's does."""
    return probit(x)


class Gaussian(Likelihood):
    def __init__(self, variance=1.0, name="gaussian_likelihood"):
        super().__init__(name=name)
        self.variance = Param(variance, transform=positive(), name=f"{name}/variance")

    def logp(self, F, Y):
        return densities.gaussian(Y, F, self.variance.value)

    def conditional_mean(self, F):
        return F

    def conditional_variance(self, F):
        return torch.squeeze(self.variance.value).expand(F.shape).to(F.dtype)

    def predict_mean_and_var(self, Fmu, Fvar):
        return Fmu, Fvar + self.variance.value

    def predict_density(self, Fmu, Fvar, Y):
        return densities.gaussian(Y, Fmu, Fvar + self.variance.value)

    def variational_expectations(self, Fmu, Fvar, Y):
        v = self.variance.value
        return (
            -0.5 * math.log(2.0 * math.pi)
            - 0.5 * torch.log(v)
            - 0.5 * (torch.square(Y - Fmu) + Fvar) / v
        )


class Poisson(Likelihood):
    """Poisson with the exp inverse link and a bin-size offset."""

    def __init__(self, invlink=torch.exp, binsize=1.0, name="poisson_likelihood"):
        super().__init__(name=name)
        self.invlink = invlink
        self.binsize = float(binsize)

    def logp(self, F, Y):
        return densities.poisson(self.invlink(F) * self.binsize, Y)

    def conditional_mean(self, F):
        return self.invlink(F) * self.binsize

    def conditional_variance(self, F):
        return self.invlink(F) * self.binsize

    def variational_expectations(self, Fmu, Fvar, Y):
        if self.invlink is torch.exp:
            return (
                Y * Fmu
                - torch.exp(Fmu + Fvar / 2) * self.binsize
                + Y * math.log(self.binsize)
                - torch.special.gammaln(Y + 1)
            )
        return super().variational_expectations(Fmu, Fvar, Y)


class Exponential(Likelihood):
    def __init__(self, invlink=torch.exp, name="exponential_likelihood"):
        super().__init__(name=name)
        self.invlink = invlink

    def logp(self, F, Y):
        return densities.exponential(self.invlink(F), Y)

    def conditional_mean(self, F):
        return self.invlink(F)

    def conditional_variance(self, F):
        return torch.square(self.invlink(F))

    def variational_expectations(self, Fmu, Fvar, Y):
        if self.invlink is torch.exp:
            return -torch.exp(-Fmu + Fvar / 2) * Y - Fmu
        return super().variational_expectations(Fmu, Fvar, Y)


class StudentT(Likelihood):
    def __init__(self, deg_free=3.0, scale=1.0, name="studentt_likelihood"):
        super().__init__(name=name)
        self.deg_free = float(deg_free)
        self.scale = Param(scale, transform=positive(), name=f"{name}/scale")

    def logp(self, F, Y):
        return densities.student_t(Y, F, self.scale.value, self.deg_free)

    def conditional_mean(self, F):
        return F

    def conditional_variance(self, F):
        var = torch.square(self.scale.value) * (self.deg_free / (self.deg_free - 2.0))
        return torch.squeeze(var).expand(F.shape).to(F.dtype)


class Bernoulli(Likelihood):
    def __init__(self, invlink=probit, name="bernoulli_likelihood"):
        super().__init__(name=name)
        self.invlink = invlink

    def logp(self, F, Y):
        return densities.bernoulli(self.invlink(F), Y)

    def conditional_mean(self, F):
        return self.invlink(F)

    def conditional_variance(self, F):
        p = self.invlink(F)
        return p - torch.square(p)

    def predict_mean_and_var(self, Fmu, Fvar):
        if self.invlink is probit:
            p = probit(Fmu / torch.sqrt(1.0 + Fvar))
            return p, p - torch.square(p)
        return super().predict_mean_and_var(Fmu, Fvar)

    def predict_density(self, Fmu, Fvar, Y):
        p = self.predict_mean_and_var(Fmu, Fvar)[0]
        return densities.bernoulli(p, Y)


class Gamma(Likelihood):
    """Gamma with the exp link on the scale: Y ~ Gamma(shape, scale=invlink(F))."""

    def __init__(self, invlink=torch.exp, shape=1.0, name="gamma_likelihood"):
        super().__init__(name=name)
        self.invlink = invlink
        self.shape = Param(shape, transform=positive(), name=f"{name}/shape")

    def logp(self, F, Y):
        return densities.gamma(self.shape.value, self.invlink(F), Y)

    def conditional_mean(self, F):
        return self.shape.value * self.invlink(F)

    def conditional_variance(self, F):
        return self.shape.value * torch.square(self.invlink(F))

    def variational_expectations(self, Fmu, Fvar, Y):
        if self.invlink is torch.exp:
            shape = self.shape.value
            return (
                -shape * Fmu
                - torch.lgamma(shape)
                + (shape - 1.0) * torch.log(Y)
                - Y * torch.exp(-Fmu + Fvar / 2.0)
            )
        return super().variational_expectations(Fmu, Fvar, Y)


class Beta(Likelihood):
    """Reparameterized Beta: mean = invlink(F), total concentration = scale."""

    def __init__(self, invlink=probit, scale=1.0, name="beta_likelihood"):
        super().__init__(name=name)
        self.invlink = invlink
        self.scale = Param(scale, transform=positive(), name=f"{name}/scale")

    def logp(self, F, Y):
        mean = self.invlink(F)
        alpha = mean * self.scale.value
        bet = self.scale.value - alpha
        return densities.beta(alpha, bet, Y)

    def conditional_mean(self, F):
        return self.invlink(F)

    def conditional_variance(self, F):
        mean = self.invlink(F)
        return (mean - torch.square(mean)) / (self.scale.value + 1.0)


class RobustMax(Module):
    """The robust-max inverse link of ``MultiClass``: probability 1 - epsilon
    on the largest latent, epsilon shared by the others."""

    def __init__(self, num_classes, epsilon=1e-3, name="robustmax"):
        super().__init__()
        self.num_classes = int(num_classes)
        self.epsilon = float(epsilon)
        self.name = name

    def forward(self, F):
        onehot = one_hot(torch.argmax(F, dim=1)[:, None], self.num_classes, F.dtype)
        return onehot * (1.0 - self.epsilon) + (1.0 - onehot) * (self.epsilon / (self.num_classes - 1.0))

    def prob_is_largest(self, Y, mu, var, gh_x, gh_w):
        """P(F_y = max_k F_k) per data point under independent Gaussians.

        mu, var: (N, K); Y: (N, 1) integer labels. Gauss-Hermite over the
        selected latent, a product of clamped normal CDFs over the others;
        gh_w are the weights divided by sqrt(pi), as ``quadrature``'s grid
        gives them (the JAX package divides the sum). Returns (N, 1).
        """
        Y = torch.as_tensor(Y, device=mu.device).to(torch.long).reshape(-1, 1)
        K = mu.shape[1]
        gh_x = torch.as_tensor(gh_x, dtype=mu.dtype, device=mu.device).reshape(1, -1)
        gh_w = torch.as_tensor(gh_w, dtype=mu.dtype, device=mu.device).reshape(-1, 1)

        mu_sel = torch.gather(mu, 1, Y)  # (N, 1)
        var_sel = torch.gather(var, 1, Y)
        X = mu_sel + gh_x * torch.sqrt(torch.clamp(2.0 * var_sel, min=1e-10))  # (N, H)
        dist = (X[:, :, None] - mu[:, None, :]) / torch.sqrt(torch.clamp(var[:, None, :], min=1e-10))  # (N, H, K)
        cdfs = _ndtr(dist) * (1 - 2e-4) + 1e-4  # the reference's clamp
        # the selected class contributes a factor 1
        onehot = one_hot(Y, K, mu.dtype)[:, None, :]  # (N, 1, K)
        cdfs = cdfs * (1.0 - onehot) + onehot
        # the product over K as exp(sum(log)): the clamp keeps every factor
        # >= 1e-4, and torch.prod's backward syncs the host to look for zeros
        prod = torch.exp(torch.sum(torch.log(cdfs), dim=2))  # (N, H)
        return prod @ gh_w


class MultiClass(Likelihood):
    def __init__(self, num_classes, invlink=None, name="multiclass_likelihood"):
        super().__init__(name=name)
        self.num_classes = int(num_classes)
        if invlink is None:
            invlink = RobustMax(num_classes)
        if not isinstance(invlink, RobustMax):
            raise NotImplementedError("MultiClass requires a RobustMax invlink")
        self.invlink = invlink

    def _log_yes_no(self):
        eps = self.invlink.epsilon
        return math.log(1.0 - eps), math.log(eps / (self.num_classes - 1.0))

    def logp(self, F, Y):
        Y = torch.as_tensor(Y, device=F.device)
        hits = torch.argmax(F, dim=1)[:, None] == Y.to(torch.int32)
        yes, no = self._log_yes_no()
        return torch.full(hits.shape, no, dtype=F.dtype, device=F.device).masked_fill_(hits, yes)

    def variational_expectations(self, Fmu, Fvar, Y):
        gh_x, gh_w = _grid(self.num_gauss_hermite_points, 1, Fmu.dtype, Fmu.device)
        p = self.invlink.prob_is_largest(Y, Fmu, Fvar, gh_x, gh_w)
        yes, no = self._log_yes_no()
        return p * yes + (1.0 - p) * no

    def predict_mean_and_var(self, Fmu, Fvar):
        ps = torch.cat([self._density(Fmu, Fvar, torch.full((Fmu.shape[0], 1), i, device=Fmu.device))
                        for i in range(self.num_classes)], dim=1)  # (N, K)
        return ps, ps - torch.square(ps)

    def _density(self, Fmu, Fvar, Y):
        gh_x, gh_w = _grid(self.num_gauss_hermite_points, 1, Fmu.dtype, Fmu.device)
        p = self.invlink.prob_is_largest(Y, Fmu, Fvar, gh_x, gh_w)
        eps = self.invlink.epsilon
        return p * (1.0 - eps) + (1.0 - p) * (eps / (self.num_classes - 1.0))

    def predict_density(self, Fmu, Fvar, Y):
        return torch.log(self._density(Fmu, Fvar, Y))

    def conditional_mean(self, F):
        return self.invlink(F)

    def conditional_variance(self, F):
        p = self.conditional_mean(F)
        return p - torch.square(p)


class SwitchedLikelihood(Likelihood):
    """Per-data-point likelihood selected by the last column of Y.

    Every child is evaluated on all points and the results are combined by
    a mask, as the JAX package does (the reference partitions the data):
    static shapes, no host sync for the partition sizes.
    """

    # a y inside the support of every child (positive, in (0, 1)), put at
    # the rows of the other outputs, so that a Gamma, Beta or Exponential
    # child never sees them: NaN * 0 is NaN in the combine and its gradient
    _SAFE_Y = 0.5

    def __init__(self, likelihood_list, name="switched_likelihood"):
        super().__init__(name=name)
        self.likelihood_list = torch.nn.ModuleList(likelihood_list)

    def _combine(self, method, Y, *fargs):
        ind = Y[..., -1].to(torch.int32)
        Ydata = Y[..., :-1]
        out = None
        for i, lik in enumerate(self.likelihood_list):
            mask = (ind == i)[..., None]
            Ysafe = torch.where(mask, Ydata, self._SAFE_Y)
            contrib = torch.where(mask, getattr(lik, method)(*fargs, Ysafe), 0.0)
            out = contrib if out is None else out + contrib
        return out

    def logp(self, F, Y):
        return self._combine("logp", Y, F)

    def variational_expectations(self, Fmu, Fvar, Y):
        return self._combine("variational_expectations", Y, Fmu, Fvar)

    def predict_density(self, Fmu, Fvar, Y):
        return self._combine("predict_density", Y, Fmu, Fvar)


class Ordinal(Likelihood):
    """Ordinal regression: a latent GP cut by bin edges."""

    def __init__(self, bin_edges, name="ordinal_likelihood"):
        super().__init__(name=name)
        # a buffer: it moves with the model, not from the host each call
        self.register_buffer("bin_edges", torch.as_tensor(np.asarray(bin_edges, dtype=np.float64)))
        self.num_bins = len(self.bin_edges) + 1
        self.sigma = Param(1.0, transform=positive(), name=f"{name}/sigma")

    def _scaled_bins(self, F):
        edges = self.bin_edges.to(F.dtype) / self.sigma.value
        inf = torch.full((1,), math.inf, dtype=F.dtype, device=F.device)
        left = torch.cat([edges, inf])  # the upper edge of each bin
        right = torch.cat([-inf, edges])  # the lower edge of each bin
        return left, right

    def logp(self, F, Y):
        left, right = self._scaled_bins(F)
        Yi = torch.as_tensor(Y, device=F.device).to(torch.long)
        Fs = F / self.sigma.value
        return torch.log(_ndtr(left[Yi] - Fs) - _ndtr(right[Yi] - Fs) + 1e-6)

    def _bin_moments(self, F):
        left, right = self._scaled_bins(F)
        Fs = F / self.sigma.value  # (..., 1)
        probs = _ndtr(left - Fs) - _ndtr(right - Fs)  # P(Y = k | F) for every k: (..., num_bins)
        ys = torch.arange(self.num_bins, dtype=F.dtype, device=F.device)
        Ey = torch.sum(probs * ys, dim=-1, keepdim=True)
        return Ey, torch.sum(probs * torch.square(ys), dim=-1, keepdim=True)

    def conditional_mean(self, F):
        return self._bin_moments(F)[0]

    def conditional_variance(self, F):
        Ey, Ey2 = self._bin_moments(F)
        return Ey2 - torch.square(Ey)
