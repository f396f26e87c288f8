"""Parameter DSL (counterpart of ``gpflow_slim_tpu.params``).

A ``Param`` is an ``nn.Module`` holding one unconstrained ``nn.Parameter``
plus its transform, prior and ``trainable`` flag; ``.value`` is the
constrained tensor. A ``Module`` is an ``nn.Module``, so kernels and models
compose with any PyTorch code (autograd, ``torch.optim``, ``.to(device)``).

``parameters(module)`` lists the Params under dotted names that match
``gpflow_slim_tpu.params.parameters`` one to one (``kern.lengthscales``,
``likelihood.variance``, ...), in the same order. It is a function, not a
method: ``nn.Module.parameters()`` keeps its PyTorch meaning.
"""

from __future__ import annotations

import torch
from torch import nn

from .transforms import Identity, Transform

__all__ = ["Param", "Module", "parameters", "log_prior"]


class Param(nn.Module):
    """A constrained parameter stored as its unconstrained value.

    Construction takes the constrained value; the stored leaf is
    ``transform.backward(value)``. ``prior_logp()`` is
    ``prior.logp(value) + transform.log_jacobian(u)`` when a prior is set,
    else 0: the Jacobian makes densities on unconstrained coordinates right.
    """

    def __init__(
        self,
        value,
        transform: Transform | None = None,
        prior=None,
        trainable: bool = True,
        name: str = "param",
        dtype: torch.dtype = torch.float64,
        device=None,
    ):
        super().__init__()
        self.transform = transform if transform is not None else Identity()
        self.prior = prior
        self.name = name
        value = torch.as_tensor(value, dtype=dtype, device=device)
        self.unconstrained = nn.Parameter(
            self.transform.backward(value).detach().clone(), requires_grad=bool(trainable)
        )

    @property
    def trainable(self) -> bool:
        """Whether optimizers update this Param (its ``requires_grad``)."""
        return self.unconstrained.requires_grad

    @trainable.setter
    def trainable(self, flag: bool):
        self.unconstrained.requires_grad_(bool(flag))

    @property
    def value(self):
        """Constrained tensor."""
        return self.transform.forward(self.unconstrained)

    @property
    def shape(self):
        return self.unconstrained.shape

    @property
    def dtype(self):
        return self.unconstrained.dtype

    def prior_logp(self):
        u = self.unconstrained
        if self.prior is None:
            return torch.zeros((), dtype=u.dtype, device=u.device)
        lp = torch.sum(self.prior.logp(self.value))
        return lp + self.transform.log_jacobian(u)

    def extra_repr(self):
        return (
            f"name={self.name!r}, transform={type(self.transform).__name__},"
            f" trainable={self.trainable}"
        )


class Module(nn.Module):
    """Base class of kernels, likelihoods, mean functions and models."""

    def log_prior(self):
        return log_prior(self)


def _path_key(name: str):
    # attribute names sort as strings, list indices (an ``nn.ModuleList``'s
    # ``kernels.10``) by position, as the JAX package's pytree keys do
    return [(0, int(part), "") if part.isdigit() else (1, 0, part) for part in name.split(".")]


def parameters(module: nn.Module) -> list[tuple[str, Param]]:
    """All Params under ``module`` with dotted path names, in the order of
    ``gpflow_slim_tpu.params.parameters`` (attribute names sorted level by
    level, list children by position). A child of a list is named by its
    index as a path part (``kern.kernels.0.variance``) where the JAX package
    writes ``kern.kernels[0].variance`` (``interop.port_name`` maps one to
    the other)."""
    found = [(n, m) for n, m in module.named_modules() if isinstance(m, Param)]
    return sorted(found, key=lambda item: _path_key(item[0]))


def log_prior(module: nn.Module):
    """Sum of prior log-probs (+ transform Jacobians) over all Params."""
    ps = [p for _, p in parameters(module)]
    if not ps:
        return torch.zeros((), dtype=torch.float64)
    total = ps[0].prior_logp()
    for p in ps[1:]:
        total = total + p.prior_logp()
    return total
