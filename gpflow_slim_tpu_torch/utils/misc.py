"""Debugging helpers (counterpart of ``gpflow_slim_tpu.utils.misc``):
profiler ranges, anomaly detection, a determinism check and a parameter
table."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..params import Param, all_leaves

__all__ = ["debug_nans", "check_determinism", "print_summary"]


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Autograd's anomaly detection (a backward that makes a NaN raises,
    naming the forward op), ``jax_debug_nans``' nearest counterpart; the
    caller's setting is restored on exit."""
    old, old_nan = torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(old, check_nan=old_nan)


def _flat(out):
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in _flat(out[k])]
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _flat(o)]
    return [out]


def _same_bits(a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        a, b = a.detach().cpu().reshape(-1), b.detach().cpu().reshape(-1)
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    return type(a) is type(b) and a == b


def check_determinism(fn, *args, reps: int = 2) -> bool:
    """Whether ``reps`` calls of ``fn(*args)`` give the same outputs bit for
    bit (tensors compared by their bytes, so equal NaNs count as equal;
    nested tuples, lists and dicts compared leaf by leaf)."""
    outs = [_flat(fn(*args)) for _ in range(reps)]
    return all(len(o) == len(outs[0]) and all(map(_same_bits, outs[0], o)) for o in outs[1:])


def print_summary(model, max_width: int = 100):
    """A GPflow-style table of ``model``'s parameters (the JAX package's
    columns: name, transform, prior, trainable, shape, constrained value),
    one row a leaf in the order of the JAX package's tree: every Param, and
    every other ``nn.Parameter`` (a warp layer's, shown as the JAX package's
    identity Params, an ``nn.Linear``'s weight as its ``W``). Prints it and
    returns it."""
    rows = [("name", "transform", "prior", "trainable", "shape", "value")]
    for name, p, transposed in all_leaves(model):
        if isinstance(p, Param):
            val, tname, prior, trainable = p.value, type(p.transform).__name__, p.prior, p.trainable
        else:
            val, tname, prior, trainable = (p.T if transposed else p), "Identity", None, p.requires_grad
        val = val.detach().cpu().numpy()
        if val.size <= 4:
            vstr = np.array2string(val, precision=4, suppress_small=True)
        else:
            vstr = f"[{val.size} values] mean={val.mean():.4g}"
        rows.append((name, tname, type(prior).__name__ if prior is not None else "-", str(trainable),
                     str(tuple(val.shape)), vstr.replace("\n", " ")))
    widths = [min(max(len(r[i]) for r in rows), max_width) for i in range(len(rows[0]))]
    lines = []
    for j, r in enumerate(rows):
        lines.append("  ".join(c[:w].ljust(w) for c, w in zip(r, widths)))
        if j == 0:
            lines.append("  ".join("-" * w for w in widths))
    out = "\n".join(lines)
    print(out)
    return out
