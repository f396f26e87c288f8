#!/usr/bin/env python3
"""Float32 accuracy of GPLVM and BayesianGPLVM along an Adam trajectory, by
route, on one NVIDIA GPU.

    python3 tools/lvm_grad_points.py [STEPS]

On chip_smoke.py phase 4h's models (example 08's data at N=2048, P=12,
Q=2; the BayesianGPLVM with M=64 inducing points), at each of STEPS
(default 8) points of an Adam run (lr 5e-3), it prints the objective's and
every gradient's error against the float64 plain path at the same
parameters (relative; gradients max-norm) on three routes: the kernel
route, use_kernels=False (the stock float32 route; nan where cuSOLVER's
float32 factor of Kuu fails), and the kernel route with the factor-only
Cholesky's forward taken from cuSOLVER (its float64 VJP kept); each with
the model's solves against Kuu's factor refined, as the model runs, and
unrefined (``ops.linalg.solve_lower_refined`` as ``solve_lower``; the
BayesianGPLVM only, the GPLVM does not refine). The
card's name and power limit come first. Needs a CUDA device.
"""

import contextlib
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("lvm_grad_points: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import gpflow_slim_tpu_torch as gft
    from gpflow_slim_tpu_torch.ops import cholesky, linalg

    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dev = torch.device("cuda")
    print(cs.card_line())

    def cusolver_into(Kp, syrk="hi"):
        Kp.copy_(torch.linalg.cholesky(torch.tril(Kp)))

    for which in ("BayesianGPLVM", "GPLVM"):
        m32 = cs.lvm_model(gft, torch, which, torch.float32, dev)
        opt = torch.optim.Adam([t for t in m32.parameters() if t.requires_grad], lr=cs.LVM_LR / 2)
        for step in range(steps):
            m64 = cs.lvm_model(gft, torch, which, torch.float64, dev, like=m32)
            ref = cs.value_and_grads(gft, m64, False, jitter=cs.VGP_JITTER)
            rows = {}
            for refine in ((True, False) if which == "BayesianGPLVM" else (True,)):
                for label, flag, patch in (("kernel", True, None), ("stock", False, None),
                                           ("cuSOLVER factor", True, cusolver_into)):
                    with contextlib.ExitStack() as st:
                        if patch:
                            st.callback(setattr, cholesky, "cholesky_cuda", cholesky.cholesky_cuda)
                            cholesky.cholesky_cuda = patch
                        if not refine:
                            st.callback(setattr, linalg, "solve_lower_refined", linalg.solve_lower_refined)
                            linalg.solve_lower_refined = linalg.solve_lower
                        v, g = cs.value_and_grads(gft, m32, flag, jitter=cs.VGP_JITTER)
                    rows[label + ("" if refine else " unrefined")] = [abs(v - ref[0]) / abs(ref[0])] + [
                        float((g[n] - w).abs().max() / w.abs().max()) for n, w in ref[1].items()]
            names = ["value"] + list(ref[1])
            print(f"{which} point {step} ({' / '.join(rows)}): " + "; ".join(
                f"{n} " + " / ".join(f"{rows[r][i]:.1e}" for r in rows) for i, n in enumerate(names)), flush=True)
            opt.zero_grad()
            with gft.config.temp_settings(jitter=cs.VGP_JITTER):
                m32.objective().backward()
            opt.step()
    return 0


if __name__ == "__main__":
    sys.exit(main())
