#!/usr/bin/env python3
"""Where the time goes in the port's exact-GPR paths on one NVIDIA GPU.

    python3 tools/profile_torch_gpr.py

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
from chip_smoke import LENGTHSCALE, NQ, NQ_FULL, bench_data, card_line  # noqa: E402

ITERS = 3   # profiled evaluations
WALLS = 5   # event-timed evaluations


def busy_ms(events):
    """Length of the union of the events' intervals, in ms."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((ev.time_range.start, ev.time_range.end) for ev in events):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


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
