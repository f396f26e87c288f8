#!/usr/bin/env python3
"""Launches, device time and wall time of the two halves of an SVGP
training step, for one checkout of the repository: the natural-gradient
update of q (``natgrad_step``) and the minibatch -ELBO with its gradient
in the hyperparameters (what the Adam step of ``fit_svgp_natgrad`` takes).

    python3 tools/svgp_parts.py ROOT

ROOT is the checkout to measure (its own gpflow_slim_tpu_torch, kernels and
chip_smoke.py). On chip_smoke.py's unwhitened SVGP model at
bench_svgp_natgrad's size, on one fixed minibatch of 1024, for each route
(kernels, use_kernels=False), it prints each half's kernel launches a call
(the ``cudaLaunchKernel`` calls the profiler records over ITERS calls), its
device busy time a call, and its wall time a call (the host's clock over
WALL calls, synchronized once at the end). To compare a parent with a
change, unpack the parent with git archive into a directory that
.gitignore lists and run parent, change, change, parent, one process each.
Needs a CUDA device.
"""

import os
import sys
import time

ITERS = 3   # profiled calls
WALL = 20   # timed calls


def main():
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("svgp_parts: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import gpflow_slim_tpu_torch as gft

    dev = torch.device("cuda")
    model = cs.svgp_model(gft, torch, False, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(1)
    idx = torch.randperm(model.X.shape[0], generator=gen, device=dev)[:cs.SVGP_B]
    Xb, Yb = model.X[idx], model.Y[idx]
    q = {id(model.q_mu.unconstrained), id(model.q_sqrt.unconstrained)}
    hypers = [p.unconstrained for _, p in gft.params.parameters(model) if p.trainable and id(p.unconstrained) not in q]

    def loss(mm):
        return -(mm.build_likelihood_batch(Xb, Yb) + mm.log_prior())

    parts = {"natgrad_step": lambda: gft.training.natgrad_step(model, loss, cs.SVGP_GAMMA),
             "-ELBO and its gradient": lambda: torch.autograd.grad(loss(model), hypers)}
    tag = os.path.basename(root)
    for flag in (True, False):
        with gft.config.temp_settings(use_kernels=flag):
            for what, fn in parts.items():
                for _ in range(2):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(WALL):
                    fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / WALL * 1e3
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(ITERS):
                        fn()
                    torch.cuda.synchronize()
                launches = sum(a.count for a in prof.key_averages() if a.key == "cudaLaunchKernel") / ITERS
                busy = sum(e.time_range.end - e.time_range.start for e in prof.events()
                           if e.device_type == DeviceType.CUDA) / 1e3 / ITERS
                print(f"{tag} unwhitened {'kernels' if flag else 'use_kernels=False'} {what}: "
                      f"{launches:.0f} launches a call, device busy {busy:.3f} ms, wall {wall:.3f} ms",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
