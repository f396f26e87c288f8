#!/usr/bin/env python3
"""Where the time goes in the port's full-data variational path on one
NVIDIA GPU.

    python3 tools/profile_torch_vgp.py

On chip_smoke.py's phase 4g models (the VGP with a Poisson likelihood on a
64 x 32 grid and the 3-class Opper-Archambeau VGP on 2048 points, RBF with
lengthscale 0.1, float32), on the kernel route and on the use_kernels=False
route, it profiles the ELBO + gradient and a predict_f request of 1024
points, and prints what tools/profile_torch_gpr.py prints for each: the
wall time (median of 5, CUDA events), the device busy time over 3
profiled evaluations, the device idle share, the device activities with the
most time, and the host operators with the most self CPU time; then the
peak memory of one ELBO + gradient above the model.

The card's name and power limit come first. Needs a CUDA device.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import gpflow_slim_tpu_torch as gft  # noqa: E402
from chip_smoke import VGP_JITTER, card_line, oa_data, vgp_data, vgp_model  # noqa: E402
from profile_torch_gpr import report  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("profile_torch_vgp: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(card_line())
    dev = torch.device("cuda")
    for which, data in (("VGP", vgp_data), ("OA", oa_data)):
        model = vgp_model(gft, torch, which, torch.float32, dev)
        Xq = torch.tensor(data()[2], device=dev)

        def step():
            model.zero_grad(set_to_none=True)
            model.objective().backward()

        def request():
            with torch.no_grad():
                model.predict_f(Xq)

        for flag in (True, False):
            with gft.config.temp_settings(use_kernels=flag, jitter=VGP_JITTER):
                report(f"use_kernels={flag} {which} ELBO+grad", step, host_top=8, Np=model.num_data)
                report(f"use_kernels={flag} {which} predict_f N*={len(Xq)}", request)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                step()
                torch.cuda.synchronize()
                print(f"  peak memory of one ELBO+grad above the model: "
                      f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.3f} GB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
