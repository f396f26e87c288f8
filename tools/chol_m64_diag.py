#!/usr/bin/env python3
"""Fault o's diagnosis: the hand factor against cuSOLVER's at the
BayesianGPLVM's float32 Kuu (M=64), on one NVIDIA GPU.

    python3 tools/chol_m64_diag.py [STEPS]

On chip_smoke.py phase 4h's BayesianGPLVM (example 08's data at N=2048,
P=12, Q=2, M=64 inducing points), at each of STEPS (default 8) points of
the Adam run of tools/lvm_grad_points.py (lr 5e-3), it takes the model's
float32 Kuu (the cross-Gram kernel plus the float32 jitter) and three
float32 factors of it: the hand factor-only Cholesky, cuSOLVER's float32
factor (``torch.linalg.cholesky``) and the float64 factor of the same
float32 Kuu rounded to float32. For each it prints the reconstruction error
||L L^T - K||_F / ||K||_F and the distance to the float64 factor
||L - L64||_F / ||L64||_F (both in float64, K the float32 Kuu), then the
objective's and every gradient's error against the float64 plain path at
the same parameters (relative; gradients max-norm) with that factor in the
kernel route's forward (its float64 VJP kept), the model's Kuu solves
refined as it runs and unrefined. The card's name and power limit come
first. Needs a CUDA device.
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
        print("chol_m64_diag: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import gpflow_slim_tpu_torch as gft
    from gpflow_slim_tpu_torch.ops import cholesky, linalg

    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dev = torch.device("cuda")
    print(cs.card_line())
    hand = cholesky.cholesky_cuda
    # each writes its factor of the lower triangle of Kp into Kp, as the
    # factor-only kernel does
    factors = {
        "hand": hand,
        "cuSOLVER f32": lambda Kp, syrk="hi": Kp.copy_(torch.linalg.cholesky(torch.tril(Kp))),
        "f64 rounded": lambda Kp, syrk="hi": Kp.copy_(torch.linalg.cholesky(torch.tril(Kp).double()).float()),
    }
    m32 = cs.lvm_model(gft, torch, "BayesianGPLVM", torch.float32, dev)
    opt = torch.optim.Adam([t for t in m32.parameters() if t.requires_grad], lr=cs.LVM_LR / 2)
    for step in range(steps):
        with gft.config.temp_settings(jitter=cs.VGP_JITTER), torch.no_grad():
            K = gft.features.Kuu(m32.feature, m32.kern, jitter=cs.VGP_JITTER)
        Kd = K.double()
        L64 = torch.linalg.cholesky(Kd)
        cond = float(torch.linalg.cond(Kd))
        recon = {}
        for label, fn in factors.items():
            L = torch.tril(fn(torch.tril(K).clone().contiguous())).double()
            recon[label] = (float(torch.linalg.norm(L @ L.T - Kd) / torch.linalg.norm(Kd)),
                            float(torch.linalg.norm(L - L64) / torch.linalg.norm(L64)))
        print(f"point {step}: Kuu (M={K.shape[0]}) cond {cond:.3e}; ||LL^T - K||/||K|| and ||L - L64||/||L64||: "
              + "; ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in recon.items()), flush=True)
        m64 = cs.lvm_model(gft, torch, "BayesianGPLVM", torch.float64, dev, like=m32)
        ref = cs.value_and_grads(gft, m64, False, jitter=cs.VGP_JITTER)
        rows = {}
        for refine in (True, False):
            for label, fn in factors.items():
                with contextlib.ExitStack() as st:
                    st.callback(setattr, cholesky, "cholesky_cuda", hand)
                    cholesky.cholesky_cuda = fn
                    if not refine:
                        st.callback(setattr, linalg, "solve_lower_refined", linalg.solve_lower_refined)
                        linalg.solve_lower_refined = linalg.solve_lower
                    v, g = cs.value_and_grads(gft, m32, True, jitter=cs.VGP_JITTER)
                rows[label + ("" if refine else " unrefined")] = [abs(v - ref[0]) / abs(ref[0])] + [
                    float((g[n] - w).abs().max() / w.abs().max()) for n, w in ref[1].items()]
        names = ["value"] + list(ref[1])
        print(f"  errors vs f64 ({' / '.join(rows)}): " + "; ".join(
            f"{n} " + " / ".join(f"{rows[r][i]:.1e}" for r in rows) for i, n in enumerate(names)), flush=True)
        opt.zero_grad()
        with gft.config.temp_settings(jitter=cs.VGP_JITTER):
            m32.objective().backward()
        opt.step()
    return 0


if __name__ == "__main__":
    sys.exit(main())
