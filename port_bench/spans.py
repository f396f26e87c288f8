"""The program's own spans in the benchmark's profiled slice, and idle gaps
named on the host's clock.

``harness.Tracer`` records the benchmark's spans only and names an idle gap
by the span the host was in at the gap's middle, which compares a device
timestamp with a host one. ``ProgramTracer`` adds, in a ``--trace 1`` run:

- program tracing (``gpflow_slim_tpu_torch.utils.trace``) on from the
  slice's start to its stop, so the program's ``gfs.*`` spans and its
  host-sync counter cover the slice and nothing else;
- ``program_spans`` (name, host start, host end, thread) of every
  ``gfs.*`` span in the slice;
- ``launch``: for each entry of ``device``, the host time and thread of
  the CUDA runtime call that launched it (joined by correlation id), or
  None where the trace has none;
- ``host_syncs``: the program's host syncs over the slice;
- gaps named by the innermost span, program or benchmark, on the launching
  thread, that holds the launch of the operation that ended the gap: what
  the host was doing when it launched late. A gap whose operation has no
  launch falls back to the middle rule, and ``breakdown.launch_fallbacks``
  counts those;
- ``breakdown.host_self``: the spans with the most host self time a unit;
  ``breakdown.clock``: device start less launch time over the slice.

An older program, without ``utils.trace``, runs as before: no program
spans, ``host_syncs`` None, and the readers of ``pending/program-spans.json``
return None.

Until ``harness.Tracer`` takes this on, the traced run with these metrics is

    python3 port_bench/spans.py --workload <name> --seed <n> --seconds <s> --trace 1

which runs the cell as ``run.py`` does with ``ProgramTracer`` in
``harness.Tracer``'s place and the entries of ``pending/program-spans.json``
added; ``--trace 0 --spans 1`` runs the cell untraced with the program's
tracing on throughout (what the spans cost with no profiler).
"""

import time

T_START = time.perf_counter()  # set-up counts from here, as in run.py

import contextlib  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from port_bench import harness  # noqa: E402

PREFIX = "gfs."
BETWEEN = "(between spans)"


def program_trace():
    """The program's ``utils.trace``, or None where the program has none."""
    try:
        from gpflow_slim_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


class ProgramTracer(harness.Tracer):
    """``harness.Tracer`` with the program's spans and its sync counter on
    over the slice, and the slice reduced with launches (module docstring)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.program, self.syncs, self._syncs0 = None, None, 0

    def tick(self, env, elapsed_s, units=1, size=None):
        started = self.prof is not None
        super().tick(env, elapsed_s, units, size)
        if not started and self.prof is not None:
            self.program = program_trace()
            if self.program is not None:
                self._syncs0 = self.program.host_syncs
                self.program.enable()

    def stop(self, env):
        if self.program is not None and self.prof is not None and not self.done:
            self.program.disable()
            self.syncs = self.program.host_syncs - self._syncs0
        super().stop(env)

    def reduce(self, span_names):
        out = super().reduce(span_names)
        if out is None:
            return None
        from torch.autograd import DeviceType

        device, spans = [], []
        for e in self.prof.events():
            if e.device_type == DeviceType.CUDA:
                if not (getattr(e, "is_user_annotation", False) or e.name in span_names
                        or any(s in e.name for s in harness.NOT_DEVICE_WORK)):
                    device.append(e.id)  # the correlation id it shares with its host-side call
            elif e.name in span_names or e.name.startswith(PREFIX):
                spans.append((e.name, e.time_range.start, e.time_range.end, e.thread))
        assert len(device) == len(out["device"])
        runtime = launches(self.prof.profiler.kineto_results)
        launch = [runtime.get(i) for i in device]
        gaps = idle_gaps(out["device"], launch, spans)
        out.update(program_spans=[s for s in spans if s[0].startswith(PREFIX)], launch=launch,
                   host_syncs=self.syncs, gaps=gaps)
        # named by the launching thread's innermost span, else any thread's
        out["breakdown"].update(idle_gaps=[[(g[2] or g[3] or (BETWEEN,))[0], g[0] / 1e6] for g in gaps[:10]],
                                launch_fallbacks=sum(g[4] for g in gaps),
                                host_self=host_self(spans, out["units"]), clock=clock(out["device"], launch))
        return out


def launches(results):
    """{correlation id: (host time us from the trace's start, thread)} of
    every host-side CUDA call (runtime or driver) that the profiler linked
    to the op or span open when it was made; the thread is that op's, as
    the profiler numbers threads for its events."""
    from torch.autograd import DeviceType

    start = results.trace_start_ns()
    calls, op_thread = [], {}
    for e in results.events():
        if e.device_type() != DeviceType.CPU:
            continue
        linked = e.linked_correlation_id()
        if linked > 0:
            calls.append((e.correlation_id(), e.start_ns(), linked))
        elif not e.name().startswith("cu"):  # an op or span (CUDA calls are named cuda*, cu*)
            op_thread[e.correlation_id()] = e.start_thread_id()
    return {c: ((t - start) / 1e3, op_thread.get(linked)) for c, t, linked in calls}


def holders(spans, points):
    """For each point (time, thread), the names of the spans (name, start,
    end, thread) on its thread that hold it, innermost (shortest) first: a
    sweep over the points in time order, keeping the spans open at each."""
    by_thread = defaultdict(list)
    for s in spans:
        by_thread[s[3]].append(s)
    for v in by_thread.values():
        v.sort(key=lambda s: s[1])
    out = [()] * len(points)
    nxt, open_ = defaultdict(int), defaultdict(list)
    for i in sorted(range(len(points)), key=lambda i: points[i][0]):
        t, thread = points[i]
        v, k = by_thread.get(thread, ()), nxt[thread]
        while k < len(v) and v[k][1] <= t:
            open_[thread].append(v[k])
            k += 1
        nxt[thread] = k
        now = open_[thread] = [s for s in open_[thread] if s[2] >= t]
        out[i] = tuple(s[0] for s in sorted(now, key=lambda s: s[2] - s[1]))
    return out


def idle_gaps(device, launch, spans):
    """Every idle gap of the device, longest first, as (length us, index of
    the operation that ended it, the names of the spans that hold its
    launch on the launching thread, innermost first, the names of those
    that hold it on any thread, whether the gap's middle stood in for a
    missing launch)."""
    order = sorted(range(len(device)), key=lambda i: device[i][1])
    found, end = [], None
    for i in order:
        _, s, e = device[i]
        if end is not None and s > end:
            found.append((s - end, i, (end + s) / 2))
        end = e if end is None else max(end, e)
    pts = [launch[i] if launch[i] is not None else (mid, None) for _, i, mid in found]
    same = holders(spans, pts)
    anywhere = holders([(n, s, e, 0) for n, s, e, _ in spans], [(p[0], 0) for p in pts])
    gaps = [(length, i, same[k], anywhere[k], launch[i] is None) for k, (length, i, _) in enumerate(found)]
    return sorted(gaps, key=lambda g: -g[0])


def host_self(spans, units, top=10):
    """The ``top`` span names by host self time a unit of work, in ms: a
    span's length less what the spans it contains on its thread cover."""
    if not units:
        return []
    by_thread, total = defaultdict(list), defaultdict(float)
    for s in spans:
        by_thread[s[3]].append(s)
    for v in by_thread.values():
        v.sort(key=lambda s: (s[1], -s[2]))
        for j, (name, s, e, _) in enumerate(v):
            inner = []
            for k in range(j + 1, len(v)):
                if v[k][1] > e:
                    break
                if v[k][2] <= e:
                    inner.append((v[k][0], v[k][1], v[k][2]))
            total[name] += (e - s) - sum(b - a for a, b in harness.union(inner))
    rows = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[n, t / 1e3 / units] for n, t in rows]


def clock(device, launch, parts=10):
    """Device start less launch time over the slice's operations, in us:
    the median, the least, and the drift of the device's clock against the
    host's in ppm, the slope of a least-squares line through the least of
    each tenth of the slice. The least is the launch latency where the card
    took an operation at once; where a queue stood ahead of every operation
    of a tenth (a device-bound cell), the slope is the queue's, not the
    clock's."""
    pts = sorted((lt[0], d[1] - lt[0]) for d, lt in zip(device, launch) if lt is not None)
    if len(pts) < 2 * parts:
        return None
    size = len(pts) // parts
    low = [min(pts[k * size:(k + 1) * size], key=lambda p: p[1]) for k in range(parts)]
    mt, mo = statistics.fmean(t for t, _ in low), statistics.fmean(o for _, o in low)
    den = sum((t - mt) ** 2 for t, _ in low)
    slope = sum((t - mt) * (o - mo) for t, o in low) / den if den else 0.0
    offs = [o for _, o in pts]
    return {"median_us": statistics.median(offs), "min_us": min(offs), "drift_ppm": 1e6 * slope}


# readers' arithmetic (metrics/ of pending/program-spans.json)

def _program(ctx):
    """The slice's trace where the program's spans were recorded, else None."""
    t = ctx["trace"]
    if not t or not t["device"] or not t["units"] or not t.get("program_spans"):
        return None
    return t


def _inside(names, held):
    return any(n in names for n in held)


def launched_ms(ctx, names):
    """ms a unit of the union of device operations launched inside a span
    named one of ``names`` (or a span nested in it) on the launching thread."""
    t = _program(ctx)
    if t is None:
        return None
    idx = [i for i, lt in enumerate(t["launch"]) if lt is not None]
    held = holders(t["program_spans"], [t["launch"][i] for i in idx])
    hits = [t["device"][i] for i, h in zip(idx, held) if _inside(names, h)]
    if not hits:
        return None
    return sum(e - s for s, e in harness.union(hits)) / 1e3 / t["units"]


def idle_ms(ctx, names):
    """ms a unit of device idle ended by an operation launched inside a
    span named one of ``names`` (or nested in it) on the launching thread."""
    t = _program(ctx)
    if t is None or not any(s[0] in names for s in t["program_spans"]):
        return None
    return sum(g[0] for g in t["gaps"] if _inside(names, g[2])) / 1e3 / t["units"]


def syncs_per_unit(ctx):
    t = _program(ctx)
    if t is None or t.get("host_syncs") is None:
        return None
    return t["host_syncs"] / t["units"]


@contextlib.contextmanager
def _program_tracer():
    saved = harness.Tracer
    harness.Tracer = ProgramTracer
    try:
        yield
    finally:
        harness.Tracer = saved


def run_cell(workload, seed, seconds, trace=1, spans=False, device="cuda", root=harness.ROOT, overrides=None,
             t_start=None):
    """``harness.run_cell`` with ``ProgramTracer`` and the pending entries
    (``trace``), or untraced with the program's tracing on throughout
    (``spans``)."""
    manifest = harness.load_manifest(root, pending=True)
    if trace:
        with _program_tracer():
            return harness.run_cell(workload, seed, seconds, 1, device, root, overrides, t_start,
                                    manifest=manifest)
    program = program_trace() if spans else None
    if spans and program is None:
        raise RuntimeError("--spans 1: this program has no gpflow_slim_tpu_torch.utils.trace")
    with program.traced() if program else contextlib.nullcontext():
        return harness.run_cell(workload, seed, seconds, 0, device, root, overrides, t_start, manifest=manifest)


def main(argv=None):
    import argparse
    import json

    run = harness.load_file(harness.BENCH / "run.py", "port_bench_run")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.resolve(harness.load_manifest(pending=True), args.workload)
    run.process_env(harness.ROOT)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s)", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, args.trace, bool(args.spans), t_start=T_START)
    if harness.forbidden_modules():
        print(f"modules of JAX loaded in the run: {harness.forbidden_modules()}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
