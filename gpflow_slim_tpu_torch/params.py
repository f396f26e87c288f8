"""Parameter DSL (counterpart of ``gpflow_slim_tpu.params``).

A ``Param`` is an ``nn.Module`` holding one unconstrained ``nn.Parameter``
plus its transform, prior and ``trainable`` flag; ``.value`` is the
constrained tensor. A ``Module`` is an ``nn.Module``, so kernels and models
compose with any PyTorch code (autograd, ``torch.optim``, ``.to(device)``).

``parameters(module)`` lists the Params under dotted names that match
``gpflow_slim_tpu.params.parameters`` one to one (``kern.lengthscales``,
``likelihood.variance``, ...), in the same order. It is a function, not a
method: ``nn.Module.parameters()`` keeps its PyTorch meaning.

``pack_trainable(module)`` concatenates every trainable leaf (the
trainable Params' unconstrained values and any other trainable
``nn.Parameter``, such as a ``DeepKernel``'s warp) into one 1-D vector, in
the order and layout of the JAX package's ``pack_trainable`` (the chain
state of ``mcmc``); its ``unpack`` turns a vector back into the dict of
named tensors that ``torch.func.functional_call`` takes.
"""

from __future__ import annotations

import re

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


# an ``nn.Linear`` warp layer's parameters under the JAX package's path:
# ``mlp_warp`` keeps layer i as the dict ``warp_params[i]`` of ``W`` and
# ``b`` (``W`` sorts first: upper case before lower)
_LINEAR_LEAF = re.compile(r"\.warp\.layers\.(\d+)\.(weight|bias)$")


def _jax_order_key(name: str):
    name = _LINEAR_LEAF.sub(lambda m: f".warp_params.{m[1]}.{'W' if m[2] == 'weight' else 'b'}", name)
    return _path_key(name)


def all_leaves(module: nn.Module):
    """``[(name, leaf, transposed)]``: every Param and every other
    ``nn.Parameter`` under ``module`` (trainable or not), in the order of
    the JAX package's tree (its paths sorted as ``parameters`` sorts them).
    ``transposed`` marks an ``nn.Linear``'s ``weight``, which holds the JAX
    package's ``W`` (``x @ W``) transposed."""
    params = parameters(module)
    held = {id(p.unconstrained) for _, p in params}
    linear = {id(m.weight) for m in module.modules() if isinstance(m, nn.Linear)}
    out = [(n, p, False) for n, p in params]
    out += [(n, t, id(t) in linear) for n, t in module.named_parameters() if id(t) not in held]
    return sorted(out, key=lambda leaf: _jax_order_key(leaf[0]))


def _leaves(module: nn.Module):
    """``[(name, state_name, tensor, transposed)]``: the trainable leaves of
    ``all_leaves``, ``state_name`` the name ``functional_call`` takes."""
    return [(n, f"{n}.unconstrained", p.unconstrained, False) if isinstance(p, Param) else (n, n, p, tr)
            for n, p, tr in all_leaves(module)
            if (p.trainable if isinstance(p, Param) else p.requires_grad)]


def trainable_leaves(module: nn.Module) -> list[tuple[str, torch.Tensor]]:
    """Every tensor an optimizer updates, named: the trainable Params'
    unconstrained values under the Param's name, and every other trainable
    ``nn.Parameter`` under its ``named_parameters`` name (a ``DeepKernel``'s
    warp: ``kern.warp.layers.0.weight``, the names ``interop`` loads), in
    the order of ``pack_trainable``'s vector."""
    return [(n, t) for n, _, t, _ in _leaves(module)]


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
    """``(vector, unpack)``: every trainable leaf (``trainable_leaves``),
    flattened and concatenated in the order and layout of
    ``gpflow_slim_tpu.params.pack_trainable``'s vector (an ``nn.Linear``'s
    weight as the JAX package's ``W``, its transpose), detached from
    autograd. ``unpack(v)`` slices a vector of that layout back into
    ``{state_name: tensor}`` (``"<Param name>.unconstrained"``, a warp
    layer's ``kern.warp.layers.0.weight``), the names ``functional_call``
    takes for ``module``; it works on batched tensors under ``vmap``."""
    leaves = _leaves(module)
    if not leaves:
        raise ValueError("no trainable parameters in module")
    vec = torch.cat([(t.T if tr else t).detach().reshape(-1) for _, _, t, tr in leaves])
    infos = [(state, t.shape, tr) for _, state, t, tr in leaves]

    def unpack(v):
        out, off = {}, 0
        for name, shape, transposed in infos:
            size = shape.numel()
            chunk = v[off:off + size]
            out[name] = chunk.reshape(shape[::-1]).T if transposed else chunk.reshape(shape)
            off += size
        return out

    return vec, unpack


def unpack_trainable(module: nn.Module, vector):
    """``pack_trainable(module)[1](vector)``."""
    return pack_trainable(module)[1](vector)
