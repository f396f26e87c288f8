#!/usr/bin/env python3
"""SVGP natural-gradient steps/s of one checkout of the repository, for
comparing two commits on one card in one session.

    python3 tools/svgp_rate.py ROOT

ROOT is the checkout to measure (its own gpflow_slim_tpu_torch, kernels and
chip_smoke.py). On chip_smoke.py's SVGP model (bench_svgp_natgrad's size),
unwhitened then whitened, it times 20-step fit_svgp_natgrad runs from the
model as built, by the host's wall clock: one warm-up fit per route, then
four fits per route, the routes interleaved (F T T F F T T F, T = kernels,
F = use_kernels=False). It prints the mean rate and each fit's. To compare
a parent with a change, unpack the parent with git archive into a
directory that .gitignore lists and run parent, change, change, parent,
one process each. Needs a CUDA device.
"""

import os
import sys
import time

WARMUP = (True, False)
ORDER = (False, True, True, False, False, True, True, False)


def main():
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("svgp_rate: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import gpflow_slim_tpu_torch as gft

    dev = torch.device("cuda")
    for whiten in (False, True):
        model = cs.svgp_model(gft, torch, whiten, torch.float32)
        init = {n: p.unconstrained.detach().cpu().numpy().copy() for n, p in gft.params.parameters(model)}
        gen = torch.Generator(device=dev).manual_seed(1)
        rates = {True: [], False: []}
        for i, flag in enumerate(WARMUP + ORDER):
            gft.interop.load_unconstrained(model, init)
            with gft.config.temp_settings(use_kernels=flag):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gft.training.fit_svgp_natgrad(model, cs.SVGP_STEPS, gen, gamma=cs.SVGP_GAMMA,
                                              learning_rate=cs.SVGP_LR, batch_size=cs.SVGP_B)
                torch.cuda.synchronize()
                if i >= len(WARMUP):
                    rates[flag].append(cs.SVGP_STEPS / (time.perf_counter() - t0))
        for flag in (True, False):
            r = rates[flag]
            print(f"{os.path.basename(root)} {'whitened' if whiten else 'unwhitened'} "
                  f"{'kernels' if flag else 'use_kernels=False'}: {sum(r) / len(r):.2f} steps/s "
                  f"(fits {', '.join(f'{x:.1f}' for x in r)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
