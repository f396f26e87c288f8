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
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .params import parameters


def port_name(name: str) -> str:
    """The port's name of the JAX package's parameter ``name``:
    ``kern.kernels[0].variance`` -> ``kern.kernels.0.variance``."""
    return re.sub(r"\[(\d+)\]", r".\1", name)


def load_unconstrained(model, arrays: dict[str, np.ndarray]):
    """Copy ``arrays`` into ``model``'s Params; raise on any name or shape
    mismatch (before anything is copied). Names are the JAX package's or the
    port's (``port_name``). Returns ``model``."""
    params = dict(parameters(model))
    arrays = {port_name(n): a for n, a in arrays.items()}
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, unexpected {extra}")
    for name, p in params.items():
        shape = tuple(np.shape(arrays[name]))
        if shape != tuple(p.unconstrained.shape):
            raise ValueError(
                f"{name}: shape {shape} does not match the port's {tuple(p.unconstrained.shape)}"
            )
    with torch.no_grad():
        for name, p in params.items():
            u = p.unconstrained
            u.copy_(torch.tensor(np.asarray(arrays[name]), dtype=u.dtype, device=u.device))
    return model
