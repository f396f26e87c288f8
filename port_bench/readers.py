"""Arithmetic the metric readers share: device time by kernel name, the
idle share and the roofline bound. Peaks: ``harness.PEAK_FLOPS`` and
``harness.PEAK_BYTES``."""

from port_bench.harness import PEAK_BYTES, PEAK_FLOPS, union

# csrc/chol_solve.cu's kernels, as the trace names them
CHOL_KERNELS = ("pivot_init_kernel", "chol_diag_kernel", "chol_panel_kernel", "chol_trailing_kernel",
                "chol_inner_update_kernel", "logdet_sum_kernel")


def idle_share(ctx):
    """100 (1 - union of device activity / wall) over the profiled slice
    (chip_smoke.py's ``busy_ms`` and tools/profile_torch_gpr.py's idle
    share)."""
    t = ctx["trace"]
    if not t or not t["device"] or not t["wall_s"]:
        return None
    return 100 * (1 - t["busy_s"] / t["wall_s"])


def device_s(ctx, names):
    """Seconds in which one of the slice's device operations whose name
    holds one of ``names`` ran (the union of their intervals: kernels of one
    call that run side by side count once); None where none ran."""
    t = ctx["trace"]
    if not t:
        return None
    hits = union([x for x in t["device"] if any(k in x[0] for k in names)])
    return sum(e - s for s, e in hits) / 1e6 if hits else None


def bound_s(flop, nbytes):
    """The least time the card could take: flop at the peak rate or bytes
    at the memory rate, whichever is longer."""
    return max(flop / PEAK_FLOPS, nbytes / PEAK_BYTES)


def rate(ctx):
    s = ctx["stats"]
    return s["steps"] / s["window_s"] if s.get("steps") else None


def untraced(ctx):
    """(steps, sizes, seconds) of the window outside its profiled slice:
    the profiler's start, its slice and its stop slow the work they cover."""
    s, t = ctx["stats"], ctx["trace"]
    steps, sizes = s["steps"] if "steps" in s else len(s["sizes"]), list(s.get("sizes", []))
    if not t:
        return steps, sizes, s["window_s"]
    for p in t["sizes"]:
        sizes.remove(p)
    return steps - t["units"], sizes, s["window_s"] - t["cost_s"]


def fit_mfu(ctx):
    """A GPR fit's share of the card's peak: evaluations x (N^3 + 2 N^2)
    flop over the window's length x the peak, outside the profiled slice.
    The count: the factor N^3/3, K^-1 from the factor 2 N^3/3, two
    triangular solves N^2 each."""
    steps, _, seconds = untraced(ctx)
    if not steps:
        return None
    n = ctx["stats"]["n"]
    return 100 * steps * (n**3 + 2 * n**2) / (seconds * PEAK_FLOPS)


def backward_ms(ctx):
    """Milliseconds a step between the CUDA events at the backward's two
    ends, summed over the traced window's steps and divided by them."""
    s = ctx["stats"]
    if not s.get("backward_spans"):
        return None
    return s["backward_ms_sum"] / s["backward_spans"]


def chol_roofline(ctx):
    """The Cholesky kernels' share of their roofline: max(N^3/3 flop at the
    peak rate, K's lower triangle read once and L's written once at the
    memory rate) over the device time of ``CHOL_KERNELS`` per evaluation in
    the profiled slice."""
    t, n = ctx["trace"], ctx["stats"]["n"]
    spent = device_s(ctx, CHOL_KERNELS)
    if spent is None or not t["units"]:
        return None
    tri = n * (n + 1) // 2 * 4
    return 100 * bound_s(n**3 / 3, 2 * tri) / (spent / t["units"])
