#!/usr/bin/env python3
"""Where the time goes in the port's exact-GPR paths on one NVIDIA GPU.

    python3 tools/profile_torch_gpr.py [--chol]

On chip_smoke.py's data and model (N=10000, D=1, RBF lengthscale 0.1,
float32) it runs, on the kernel route and on the use_kernels=False route,
the training path (GPR.objective() and objective+gradient) and the serving
path (GPR.posterior(), one predict_f request of 2048 points and one
full-covariance request of 1024, chip_smoke.py's requests), and prints for
each:

- the wall time per evaluation (median of 5, CUDA events);
- the device busy time per evaluation: the union of the intervals of all
  device activity (kernels, memcpy, memset) that torch.profiler records
  over 3 evaluations;
- the device idle share, 1 - busy / wall, and within the device span;
- the ten device activities with the most time, per evaluation (and, on
  request, the host operators with the most self CPU time).

With ``--chol`` it prints only the Cholesky trailing update's rate in
each arithmetic ("hi", "s3", "s4"; tools/split_diag.py runs it on variants
of the kernel), at Np = 10048: in place (the trailing kernels' summed device
time within one fused factorization, by the profiler, over the trailing
updates' lower-triangle flop) and alone (one trailing update, the first
panel's over the 9792 columns beyond it, launched by itself through
``gfs_chol_trailing_update``, median of 5 by CUDA events), with the
factorization's device busy time and the part of it during which no
trailing update runs (the chain of diag, panel and in-panel updates that
the look-ahead leaves visible).

The card's name and power limit come first. Needs a CUDA device.
"""

import os
import statistics
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gpflow_slim_tpu_torch as gft  # noqa: E402
from chip_smoke import LENGTHSCALE, NQ, NQ_FULL, bench_data, busy_ms, card_line  # noqa: E402

ITERS = 3   # profiled evaluations
WALLS = 5   # event-timed evaluations


def trailing_flop(Np, panel=256):
    """Flop of the Cholesky's trailing updates (csrc/chol_solve.cu): after
    each 256-wide panel but the last, 2 x 256 flop for every entry of the
    lower triangle beyond it."""
    rest = [Np - panel * (p + 1) for p in range(-(-Np // panel) - 1)]
    return sum(2 * panel * m * (m + 1) // 2 for m in rest)


def chol_split(dev, Np):
    """The Cholesky's trailing updates against the rest of its launches: the
    trailing kernels' summed time and rate, and the device time during which
    no trailing update runs (the chain of diag, panel and in-panel updates
    that the look-ahead leaves visible, plus any other kernel)."""
    trailing = [e for e in dev if "chol_trailing" in e.name]
    if not trailing:
        return
    t_ms = sum(e.time_range.end - e.time_range.start for e in trailing) / 1e3 / ITERS
    visible = (busy_ms(dev) - busy_ms(trailing)) / ITERS
    print(f"  cholesky: trailing updates {t_ms:.3f} ms/iter ({trailing_flop(Np) / t_ms / 1e9:.1f} TFLOP/s "
          f"on the lower-triangle flop of Np={Np}), device time with no trailing update running "
          f"{visible:.3f} ms/iter")


def trailing_rates(Np=10048):
    """The trailing update's TFLOP/s by arithmetic, in place and alone (the
    module docstring)."""
    from chip_smoke import cuda_ms
    from gpflow_slim_tpu_torch.ops import _build, cholesky, gram

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    one = torch.tensor(1.0, device=dev)
    Kp = gram.gram_chol_operand_cuda("rbf", torch.rand(Np, 1, generator=g, device=dev) / LENGTHSCALE, one, one, Np)
    D = torch.randn(Np, 1, generator=g, device=dev)
    dpiv = torch.zeros(Np, dtype=torch.float64, device=dev)
    alone_flop = 2 * 256 * (Np - 256) * (Np - 255) // 2
    for syrk in ("hi", "s3", "s4"):
        fused = lambda: cholesky.cholesky_solve_cuda(Kp.clone(), D, syrk)  # noqa: E731
        for _ in range(2):
            fused()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                fused()
            torch.cuda.synchronize()
        dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        trailing = [e for e in dev_events if "chol_trailing" in e.name]
        t_in = sum(e.time_range.end - e.time_range.start for e in trailing) / 1e3 / ITERS
        busy = busy_ms(dev_events) / ITERS
        K = Kp.clone()
        mode = cholesky._mode_code(syrk)

        def alone():
            _build.launch("gfs_chol_trailing_update", K.data_ptr(), Np, 0, dpiv.data_ptr(), mode, on=K)

        t_alone = statistics.median(cuda_ms(torch, alone))
        print(f"trailing update, syrk={syrk}, Np={Np}: in place {t_in:.3f} ms a factorization in "
              f"{len(trailing) // ITERS} launches ({trailing_flop(Np) / t_in / 1e9:.1f} TFLOP/s); alone "
              f"(the first panel's) {t_alone:.4f} ms ({alone_flop / t_alone / 1e9:.1f} TFLOP/s); factorization "
              f"busy {busy:.3f} ms, with no trailing update running {busy - busy_ms(trailing) / ITERS:.3f} ms",
              flush=True)


def report(label, fn, host_top=0, Np=None, watch=None):
    """Prints label's wall time, device busy time and idle share, its
    top device activities and, on request, its top host operators, the
    Cholesky split (Np) and the time, launches and share of device busy
    time of the kernels whose name holds ``watch``."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(WALLS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        walls.append(start.elapsed_time(end))
    wall = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    # "Command Buffer Full" marks host launches that waited on a full
    # queue; it is not device work
    dev = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and "Command Buffer Full" not in e.name]
    if not dev:
        raise RuntimeError(f"{label}: the profiler recorded no device activity")
    busy = busy_ms(dev) / ITERS
    span = (max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)) / 1e3 / ITERS
    print(f"=== {label}: wall {wall:.3f} ms (median of {WALLS}, events), device busy "
          f"{busy:.3f} ms/iter over a {span:.3f} ms/iter device span; idle share vs event wall "
          f"{1 - busy / wall:.4f}, within span {1 - busy / span:.4f}; "
          f"{len(dev) // ITERS} device activities/iter")
    by = {}
    for e in dev:
        t = by.setdefault(e.name[:100], [0.0, 0])
        t[0] += (e.time_range.end - e.time_range.start) / 1e3
        t[1] += 1
    for name, (t, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"{t / ITERS:9.3f} ms/iter  n={n // ITERS:5d}  {name}")
    if Np is not None:
        chol_split(dev, Np)
    if watch is not None:
        w = [e for e in dev if watch in e.name]
        w_ms = sum(e.time_range.end - e.time_range.start for e in w) / 1e3 / ITERS
        print(f"  {watch}: {w_ms:.4f} ms/iter in {len(w) // ITERS} launches/iter, {w_ms / busy:.4f} of the "
              f"device busy time")
    if host_top:
        # where the host's time goes when the device waits on it
        print("  host: the operators with the most self CPU time")
        for a in sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:host_top]:
            print(f"  {a.self_cpu_time_total / 1e3 / ITERS:9.3f} ms/iter  n={a.count // ITERS:5d}  "
                  f"{a.key[:100]}")


def main():
    if not torch.cuda.is_available():
        print("profile_torch_gpr: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if "--chol" in sys.argv:
        print(card_line())
        trailing_rates()
        return 0
    X, Y = bench_data()
    model = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=LENGTHSCALE),
                           device="cuda", dtype=torch.float32)

    def objective():
        with torch.no_grad():
            model.objective()

    def objective_grad():
        model.zero_grad(set_to_none=True)
        model.objective().backward()

    rq = np.random.RandomState(2)
    Xq = torch.tensor(rq.uniform(0, 1, (NQ, 1)), dtype=torch.float32, device="cuda")
    Xf = torch.tensor(rq.uniform(0, 1, (NQ_FULL, 1)), dtype=torch.float32, device="cuda")

    def posterior():
        with torch.no_grad():
            model.posterior()

    print(card_line())
    Np = len(X) + (-len(X)) % 64
    for flag in (True, False):
        with gft.config.temp_settings(use_kernels=flag):
            report(f"use_kernels={flag} objective", objective, Np=Np)
            report(f"use_kernels={flag} objective+grad", objective_grad)
            report(f"use_kernels={flag} posterior()", posterior, Np=Np)
            with torch.no_grad():
                post = model.posterior()
                report(f"use_kernels={flag} predict_f N*={NQ}", lambda: post.predict_f(Xq))
                report(f"use_kernels={flag} predict_f full_cov N*={NQ_FULL}",
                       lambda: post.predict_f(Xf, full_cov=True))
            del post
    return 0


if __name__ == "__main__":
    sys.exit(main())
