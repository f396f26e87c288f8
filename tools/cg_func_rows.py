#!/usr/bin/env python3
"""Config #5 under torch.func: how far the float32 estimate moves with the
order of its sums, on one NVIDIA GPU.

    python3 tools/cg_func_rows.py

On chip_smoke.py phase 4h's model (GPRCG streaming, example 05's deep
kernel, N=50000, the JAX package's defaults, fixed probes), at two
unconstrained points (the model's and one moved by 0.01 x a normal draw),
it prints the value's and each leaf's gradient's error against the float64
plain path at that point (relative; gradients max-norm) for float32
evaluations that compute the same function with their sums in other
orders: plain autograd on the kernel route and on use_kernels=False, with
2048-row panels in place of 4096, and ``mcmc.batched_value_and_grad``
over the point alone and over both points (``vmap``: the panels' products
become batched ones). The card's name and power limit come first. Needs a
CUDA device.
"""

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("cg_func_rows: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import gpflow_slim_tpu_torch as gft

    dev = torch.device("cuda")
    print(cs.card_line())
    cg_gpr = gft.models.cg_gpr
    m32 = cs.deep_model(gft, torch, torch.float32, dev)
    lp, x0, unpack = gft.mcmc.model_logprob(m32)
    lp64 = gft.mcmc.model_logprob(cs.deep_model(gft, torch, torch.float64, dev, like=m32))[0]
    z = torch.stack([x0, x0 + 0.01 * torch.tensor(np.random.RandomState(6).randn(x0.shape[0]), dtype=x0.dtype,
                                                     device=dev)])
    sizes = {n: t.numel() for n, t in unpack(x0).items()}
    batched = gft.mcmc.base.batched_value_and_grad

    def autograd_at(fn, v):
        v = v.clone().requires_grad_()
        val = fn(v)
        return val.item(), torch.autograd.grad(val, v)[0].double()

    with cs.FixedProbes(gft, torch, cs.CG_N, m32.num_probes, dev):
        refs = [autograd_at(lp64, z[r].double()) for r in range(2)]
        runs = {"autograd": [autograd_at(lp, z[r]) for r in range(2)]}
        with gft.config.temp_settings(use_kernels=False):
            runs["autograd use_kernels=False"] = [autograd_at(lp, z[r]) for r in range(2)]
        block = cg_gpr.STREAM_BLOCK
        cg_gpr.STREAM_BLOCK = 2048
        try:
            runs["autograd 2048-row panels"] = [autograd_at(lp, z[r]) for r in range(2)]
        finally:
            cg_gpr.STREAM_BLOCK = block
        runs["vmap of one row"] = []
        for r in range(2):
            v, g = batched(lp)(z[r:r + 1])
            runs["vmap of one row"].append((float(v[0]), g[0].double()))
        v, g = batched(lp)(z)
        runs["vmap of two rows"] = [(float(v[r]), g[r].double()) for r in range(2)]
    for r, (v64, g64) in enumerate(refs):
        print(f"point {r}: f64 value {v64:.6f}")
        for label, rows in runs.items():
            v, g = rows[r]
            errs = [f"{n} {float((a - b).abs().max()) / float(b.abs().max()):.2e}"
                    for n, a, b in zip(sizes, torch.split(g, list(sizes.values())),
                                       torch.split(g64, list(sizes.values())))]
            print(f"  {label}: value {v:.6f}, rel err {abs(v - v64) / abs(v64):.3e}; gradients " + ", ".join(errs),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
