#!/usr/bin/env python3
"""Where the time goes in the port's SVGP natural-gradient training path on
one NVIDIA GPU.

    python3 tools/profile_torch_svgp.py

On chip_smoke.py's SVGP model (benchmarks/bench_svgp_nuts.py's
bench_svgp_natgrad: N=100000, M=256, minibatches of 1024, Bernoulli, RBF
lengthscale 0.2, float32), unwhitened and whitened, on the kernel route and
on the use_kernels=False route, it profiles one training step of
fit_svgp_natgrad (a minibatch draw, a natgrad step on q, an Adam step on
the hyperparameters), each from the model as built, and prints what
tools/profile_torch_gpr.py prints: the wall time (median of 5, CUDA
events), the device busy time over 3 profiled steps, the device idle share,
the ten device activities with the most time, the batched TRSM's device
time, launches and share of the busy time, and the twelve host operators
with the most self CPU time (the step is bound by the host; the count of
cudaLaunchKernel there is the step's kernel launches).

The card's name and power limit come first. Needs a CUDA device.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import gpflow_slim_tpu_torch as gft  # noqa: E402
from chip_smoke import SVGP_B, SVGP_GAMMA, SVGP_LR, card_line, svgp_model  # noqa: E402
from profile_torch_gpr import report  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("profile_torch_svgp: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(card_line())
    for whiten in (False, True):
        model = svgp_model(gft, torch, whiten, torch.float32)
        init = {n: p.unconstrained.detach().cpu().numpy().copy() for n, p in gft.params.parameters(model)}
        gen = torch.Generator(device="cuda").manual_seed(0)

        def step():
            gft.interop.load_unconstrained(model, init)  # each step from the model as built
            gft.training.fit_svgp_natgrad(model, 1, gen, gamma=SVGP_GAMMA, learning_rate=SVGP_LR,
                                          batch_size=SVGP_B)

        label = "whitened" if whiten else "unwhitened"
        for flag in (True, False):
            with gft.config.temp_settings(use_kernels=flag):
                report(f"use_kernels={flag} SVGP {label} natgrad+Adam step", step, host_top=12,
                       watch="batched_trsm_kernel")
    return 0


if __name__ == "__main__":
    sys.exit(main())
