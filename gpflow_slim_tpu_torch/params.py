"""Parameter DSL (counterpart of ``gpflow_slim_tpu.params``).

A ``Param`` is an ``nn.Module`` holding one unconstrained ``nn.Parameter``
plus its transform, prior and ``trainable`` flag; ``.value`` is the
constrained tensor. A ``Module`` is an ``nn.Module``, so kernels and models
compose with any PyTorch code (autograd, ``torch.optim``, ``.to(device)``).

``parameters(module)`` lists the Params under dotted names that match
``gpflow_slim_tpu.params.parameters`` one to one (``kern.lengthscales``,
``likelihood.variance``, ...), in the same order. It is a function, not a
method: ``nn.Module.parameters()`` keeps its PyTorch meaning.

``pack_trainable(module)`` concatenates the trainable Params' unconstrained
values into one 1-D vector, in the order of the JAX package's
``pack_trainable`` (the chain state of ``mcmc``); its ``unpack`` turns a
vector back into the ``{"<name>.unconstrained": tensor}`` dict that
``torch.func.functional_call`` takes.
"""

from __future__ import annotations

import torch
from torch import nn

from .transforms import Identity, Transform

__all__ = ["Param", "Module", "parameters", "trainable_leaves", "log_prior", "pack_trainable", "unpack_trainable"]


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

    @property
    def device(self):
        return self.unconstrained.device

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


def trainable_leaves(module: nn.Module) -> list[tuple[str, torch.Tensor]]:
    """Every tensor an optimizer updates, named: the trainable Params'
    unconstrained values under the Param's name, in ``parameters`` order
    (that of ``pack_trainable``), then every other trainable
    ``nn.Parameter`` under its ``named_parameters`` name (a ``DeepKernel``'s
    warp: ``kern.warp.layers.0.weight``, the names ``interop`` loads)."""
    params = parameters(module)
    held = {id(p.unconstrained) for _, p in params}
    return ([(n, p.unconstrained) for n, p in params if p.trainable]
            + [(n, t) for n, t in module.named_parameters() if t.requires_grad and id(t) not in held])


def log_prior(module: nn.Module):
    """Sum of prior log-probs (+ transform Jacobians) over all Params."""
    ps = [p for _, p in parameters(module)]
    if not ps:
        return torch.zeros((), dtype=torch.float64)
    total = ps[0].prior_logp()
    for p in ps[1:]:
        total = total + p.prior_logp()
    return total


def pack_trainable(module: nn.Module):
    """``(vector, unpack)``: the trainable Params' unconstrained values,
    flattened and concatenated in ``parameters`` order (that of
    ``gpflow_slim_tpu.params.pack_trainable``), detached from autograd.
    ``unpack(v)`` slices a vector of that layout back into
    ``{"<name>.unconstrained": tensor}``, the names ``functional_call``
    takes for ``module``; it works on batched tensors under ``vmap``."""
    infos = [(f"{n}.unconstrained", p.unconstrained.shape) for n, p in parameters(module) if p.trainable]
    if not infos:
        raise ValueError("no trainable parameters in module")
    vec = torch.cat([module.get_parameter(n).detach().reshape(-1) for n, _ in infos])

    def unpack(v):
        out, off = {}, 0
        for name, shape in infos:
            size = shape.numel()
            out[name] = v[off:off + size].reshape(shape)
            off += size
        return out

    return vec, unpack


def unpack_trainable(module: nn.Module, vector):
    """``pack_trainable(module)[1](vector)``."""
    return pack_trainable(module)[1](vector)
