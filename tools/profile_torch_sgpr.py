#!/usr/bin/env python3
"""Where the time goes in the port's sparse regression path (BASELINE
config #2) on one NVIDIA GPU.

    python3 tools/profile_torch_sgpr.py

On chip_smoke.py's config #2 models (benchmarks/bench_svgp_nuts.py's
bench_sgpr: N=10000, M=100 inducing points on a grid, Matern32 + Periodic,
float32), on the kernel route and on the use_kernels=False route, it
profiles the SGPR objective, objective+gradient, posterior() and one
predict_f request of 2048 points, and the GPRFITC objective, and prints
what tools/profile_torch_gpr.py prints for each: the wall time (median of
5, CUDA events), the device busy time over 3 profiled evaluations, the
device idle share, the device activities with the most time, and the host
operators with the most self CPU time (the count of cudaLaunchKernel there
is the evaluation's kernel launches).

The card's name and power limit come first. Needs a CUDA device.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import gpflow_slim_tpu_torch as gft  # noqa: E402
from chip_smoke import NQ, card_line, sparse_model  # noqa: E402
from profile_torch_gpr import report  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("profile_torch_sgpr: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(card_line())
    sgpr = sparse_model(gft, torch, "SGPR", torch.float32)
    fitc = sparse_model(gft, torch, "GPRFITC", torch.float32)
    Xq = torch.tensor(np.random.RandomState(8).uniform(0, 1, (NQ, 1)), dtype=torch.float32, device="cuda")

    def objective(model):
        def run():
            with torch.no_grad():
                model.objective()
        return run

    def objective_grad():
        sgpr.zero_grad(set_to_none=True)
        sgpr.objective().backward()

    def posterior():
        with torch.no_grad():
            sgpr.posterior()

    for flag in (True, False):
        with gft.config.temp_settings(use_kernels=flag):
            report(f"use_kernels={flag} SGPR objective", objective(sgpr), host_top=8)
            report(f"use_kernels={flag} SGPR objective+grad", objective_grad, host_top=8)
            report(f"use_kernels={flag} SGPR posterior()", posterior)
            with torch.no_grad():
                post = sgpr.posterior()
                report(f"use_kernels={flag} SGPR predict_f N*={NQ}", lambda: post.predict_f(Xq))
            report(f"use_kernels={flag} GPRFITC objective", objective(fitc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
