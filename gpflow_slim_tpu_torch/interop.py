"""Weights from the JAX package into the port.

``load_unconstrained(model, arrays)`` takes the unconstrained values of a
``gpflow_slim_tpu`` model as ``{dotted_name: np.ndarray}``, the names that
``gpflow_slim_tpu.params.parameters`` gives, and copies them into the
port's Params. The caller builds the dict; this package never imports JAX::

    arrays = {n: np.asarray(p.unconstrained)
              for n, p in gpflow_slim_tpu.params.parameters(jax_model)}

The JAX package names a child of a list by its index in brackets
(``kern.kernels[0].variance``), the port as a path part
(``kern.kernels.0.variance``): ``port_name`` maps the first to the second,
and ``load_unconstrained`` takes either.

A ``DeepKernel``'s warp is an ``nn.Module`` of the port, not Params: the
JAX package keys the leaves of ``mlp_warp``'s pytree by their path
(``kern.warp_params[0]['W']``, every leaf's own name being the same
``".../warp"``), the port by the module path of the ``nn.Linear``
(``kern.warp.layers.0.weight``), which holds ``W`` transposed. Both
``port_name``, ``port_arrays`` and ``load_unconstrained`` take that map
too; ``port_arrays`` also gives a JAX gradient in the port's layout.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .params import parameters


_WARP_LEAF = re.compile(r"\.warp_params\[(\d+)\]\['(W|b)'\]")


def port_name(name: str) -> str:
    """The port's name of the JAX package's parameter ``name``:
    ``kern.kernels[0].variance`` -> ``kern.kernels.0.variance``,
    ``kern.warp_params[1]['W']`` -> ``kern.warp.layers.1.weight``."""
    name = _WARP_LEAF.sub(lambda m: f".warp.layers.{m[1]}.{'weight' if m[2] == 'W' else 'bias'}", name)
    return re.sub(r"\[(\d+)\]", r".\1", name)


def _targets(model):
    """{name: (tensor, transposed)}: every Param's unconstrained value, and
    the parameters of every ``DeepKernel``'s warp (2-D ``weight``s held
    transposed)."""
    from .kernels_deep import DeepKernel

    out = {name: (p.unconstrained, False) for name, p in parameters(model)}
    for path, mod in model.named_modules():
        if isinstance(mod, DeepKernel):
            for n, t in mod.warp.named_parameters():
                out[f"{path}.warp.{n}"] = (t, t.dim() == 2 and n.endswith("weight"))
    return out


def port_arrays(model, arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """``arrays`` (the JAX package's names or the port's) under the port's
    names and in its layouts, a warp's ``W`` transposed into its
    ``nn.Linear``'s; raise on any name or shape mismatch."""
    targets = _targets(model)
    arrays = {port_name(n): a for n, a in arrays.items()}
    missing = sorted(set(targets) - set(arrays))
    extra = sorted(set(arrays) - set(targets))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, unexpected {extra}")
    values = {}
    for name, (t, transposed) in targets.items():
        a = np.asarray(arrays[name])
        values[name] = a.T if transposed else a
        if values[name].shape != tuple(t.shape):
            raise ValueError(f"{name}: shape {a.shape} does not match the port's {tuple(t.shape)}"
                             + (" (transposed)" if transposed else ""))
    return values


def load_unconstrained(model, arrays: dict[str, np.ndarray]):
    """Copy ``arrays`` into ``model``'s Params and warps (``port_arrays``:
    nothing is copied if a name or shape differs). Returns ``model``."""
    values = port_arrays(model, arrays)
    with torch.no_grad():
        for name, (t, _) in _targets(model).items():
            t.copy_(torch.tensor(values[name], dtype=t.dtype, device=t.device))
    return model
