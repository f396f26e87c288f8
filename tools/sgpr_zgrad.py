#!/usr/bin/env python3
"""How far the float32 inducing-point gradient of config #2 is from float64,
by route, on one NVIDIA GPU.

    python3 tools/sgpr_zgrad.py [N ...]      (default N = 10000)

On chip_smoke.py's config #2 models (benchmarks/bench_svgp_nuts.py's
bench_sgpr: M=100 inducing points on a grid, Matern32 + Periodic) at each
N, for SGPR and GPRFITC, it prints the max-norm relative error of the Z
gradient against the f64 plain path (with the f32 jitter) over four orders
of the data (the same objective, its sums taken in other orders), for:

- the use_kernels=False float32 route (autograd through cuSOLVER/cuBLAS);
- the kernel route (the Cholesky VJP in float64, its solves on the TRSM
  kernel refined on float64 residuals);
- the kernel route with the Cholesky VJP all in float32 (as it ran before:
  no refinement, float32 products);
- the kernel route with the forward factor by cuSOLVER, and with every
  triangular solve (forward and backward) by cuBLAS.

The card's name and power limit come first. Needs a CUDA device.
"""

import contextlib
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import gpflow_slim_tpu_torch as gft  # noqa: E402
from gpflow_slim_tpu_torch.ops import cholesky, trsm  # noqa: E402

ORDERS = 4


@contextlib.contextmanager
def patched(*triples):
    olds = [(o, n, getattr(o, n)) for o, n, _ in triples]
    for o, n, v in triples:
        setattr(o, n, v)
    try:
        yield
    finally:
        for o, n, v in olds:
            setattr(o, n, v)


def chol_vjp_f32(L, g):
    # the Cholesky VJP all in the factor's dtype, the TRSM's solves unrefined
    L = torch.tril(L)
    P = L.mT @ torch.tril(g)
    P = torch.tril(P) - 0.5 * torch.diag_embed(torch.diagonal(P))
    X = trsm.solve_upper(L.mT, P + P.mT)
    S = trsm.solve_upper(L.mT, X.mT.contiguous())
    return 0.25 * (S + S.mT)


def factor_library(Kp, syrk="hi"):
    return Kp.copy_(cholesky.cholesky_plain(Kp))


def solve_library(T, B, lower):
    if T.dim() == 2:
        return trsm.solve_triangular_plain(T, B, lower).contiguous()
    return trsm.batched_trsm_cuda(T, B, lower)


VARIANTS = {
    "use_kernels=False f32": None,
    "kernel route": (),
    "kernel route, Cholesky VJP in f32": ((cholesky, "_chol_vjp", chol_vjp_f32),),
    "kernel route, forward factor by cuSOLVER": ((cholesky, "cholesky_cuda", factor_library),),
    "kernel route, every solve by cuBLAS": ((trsm, "_solve", solve_library),),
}


def main():
    if not torch.cuda.is_available():
        print("sgpr_zgrad: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(cs.card_line())
    for N in [int(a) for a in sys.argv[1:]] or [cs.SPARSE_N]:
        cs.SPARSE_N = N
        X0, Y0, Z = cs.sparse_data()
        for cls in ("SGPR", "GPRFITC"):
            errs = {k: [] for k in VARIANTS}
            for seed in range(ORDERS):
                perm = np.random.RandomState(seed).permutation(N) if seed else np.arange(N)

                def build(dtype):
                    return getattr(gft.models, cls)(X0[perm], Y0[perm], kern=cs.sparse_kern(gft), Z=Z,
                                                    device="cuda", dtype=dtype)

                def zgrad(model, flag):
                    with gft.config.temp_settings(use_kernels=flag, jitter=cs.SPARSE_JITTER):
                        model.objective().backward()
                    return model.feature.Z.unconstrained.grad.double()

                m32 = build(torch.float32)
                m64 = build(torch.float64)
                gft.interop.load_unconstrained(m64, {n: p.unconstrained.detach().cpu().numpy()
                                                     for n, p in gft.params.parameters(m32)})
                want = zgrad(m64, False)
                for label, swaps in VARIANTS.items():
                    if swaps is None:
                        got = zgrad(build(torch.float32), False)
                    else:
                        with patched(*swaps):
                            got = zgrad(build(torch.float32), True)
                    errs[label].append(float((got - want).abs().max()) / float(want.abs().max()))
            for label, e in errs.items():
                print(f"{cls} N={N} {label:42s} Z-gradient rel err (max-norm) over {ORDERS} data orders: "
                      + " ".join(f"{x:.3f}" for x in e) + f"; median {np.median(e):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
