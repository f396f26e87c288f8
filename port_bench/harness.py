"""The benchmark's core: finds a cell's files by name, runs its loop's
set-up and window, reads its metrics and decides ``correct``.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model's sizes, source, ``reduced``, ``assumed``;
- ``reference/<config>.py``: its plain float64 reference (and its data);
- ``traffic/<traffic>.json``: the mix's parameters, among them ``loop``;
- ``loops/<loop>.py``: the general code that drives one kind of work
  through the program (``setup``, ``window``, ``numbers``, ``control``);
- ``limits/<workload>.json``: the limit of each number compared;
- ``metrics/<metric>.py``: a reader, ``read(ctx)``, that returns the metric
  or None where it finds nothing to read.

A later cell, mix or metric is new files plus new entries in the manifest.
"""

import contextlib
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names a run may never load (compared whole: the port's
# own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "gpflow_slim_tpu")
PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate: one peak for every implementation
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes per second
# device activity that is no operation: host launches that waited on a full queue
NOT_DEVICE_WORK = ("Command Buffer Full",)


def load_manifest(root=ROOT, pending=False):
    """BENCHMARK.json; with ``pending``, the entries of every file of
    ``pending/`` added: cells and metrics built and checked but not (yet) in
    BENCHMARK.json."""
    manifest = json.loads((Path(root) / "BENCHMARK.json").read_text())
    for f in sorted((Path(root) / "port_bench" / "pending").glob("*.json")) if pending else []:
        extra = json.loads(f.read_text())
        manifest = {k: v + extra.get(k, []) if isinstance(v, list) else v for k, v in manifest.items()}
    return manifest


def load_file(path, name):
    """Import the module at ``path`` under ``name`` (file names may hold
    ``-`` and ``.``, which an import statement cannot)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric, workload, end_to_end_names):
    if "workloads" in metric:
        return workload in metric["workloads"]
    return end_to_end_names is None or metric["moves"] in end_to_end_names


def resolve(manifest, workload, root=ROOT):
    """The cell ``workload`` with every file it needs, found by name.
    Raises ``KeyError`` for an unknown cell, ``FileNotFoundError`` for a
    missing file."""
    bench = Path(root) / "port_bench"
    cells = {w["name"]: w for w in manifest["workloads"]}
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    entry = configs[cell["config"]]
    files = {
        "config": Path(root) / entry["file"],
        "traffic": bench / "traffic" / f"{cell['traffic']}.json",
        "reference": bench / "reference" / f"{cell['config']}.py",
        "limits": bench / "limits" / f"{workload}.json",
    }
    for f in files.values():
        if not f.is_file():
            raise FileNotFoundError(f)
    traffic = json.loads(files["traffic"].read_text())
    files["loop"] = bench / "loops" / f"{traffic['loop']}.py"
    e2e = [m for m in manifest["end_to_end"] if _reports(m, workload, None)]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"] if _reports(m, workload, names)]
    readers = {m["name"]: bench / "metrics" / f"{m['name']}.py" for m in e2e + layer}
    for f in [files["loop"], *readers.values()]:
        if not f.is_file():
            raise FileNotFoundError(f)
    return {"name": workload, "chips": cell["chips"], "files": files, "readers": readers,
            "config": json.loads(files["config"].read_text()), "traffic": traffic,
            "limits": json.loads(files["limits"].read_text()),
            "end_to_end": e2e, "per_layer": layer}


def card_line():
    """The card's name and power limit, as nvidia-smi gives them (copied
    from chip_smoke.py's ``card_line``); None where it cannot say."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Env:
    """What a loop gets: the program, the reference, the cell's
    parameters, the seed, the device and the tracer."""

    def __init__(self, cell, seed, device, tracer, overrides=None, detail=False):
        import torch

        import gpflow_slim_tpu_torch as program

        self.torch, self.program = torch, program
        self.config = {**cell["config"], **(overrides or {}).get("config", {})}
        self.traffic = {**cell["traffic"], **(overrides or {}).get("traffic", {})}
        self.reference = load_file(cell["files"]["reference"], f"port_bench_reference_{cell['name']}")
        self.seed, self.device, self.tracer = seed, torch.device(device), tracer
        self.detail = {} if detail else None  # calibrate.py's per-step and per-leaf readings
        self.phases = {}  # set-up's parts, seconds from the run's start

    def phase(self, name, t_start):
        self.sync()
        self.phases[name] = time.perf_counter() - t_start

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)


class Tracer:
    """Spans of the benchmark's own (``torch.profiler.record_function``) and
    one profiled slice of the window. Off: spans are no-ops and nothing is
    profiled. The loop calls ``tick`` after each unit of work; the slice
    starts at the first tick past ``start_s`` of the window and stops at the
    first past ``start_s + length_s``, each after a synchronize, so the work
    ticked inside it is the work its device time covers."""

    def __init__(self, on, seconds=0.0, length_s=0.0):
        self.on = on
        self.length_s = min(length_s, 0.8 * seconds)
        self.start_s = max(0.0, (seconds - self.length_s) / 2)
        self.prof, self.done = None, False
        self.units, self.sizes, self.wall_s, self.cost_s = 0, [], None, 0.0
        self._t0 = self._c0 = None

    @property
    def active(self):
        """Whether the slice has started and not yet stopped: the window
        runs on until it has."""
        return self.prof is not None and not self.done

    def warm(self, env):
        """Start and stop a profile once in set-up: the first start of the
        profiler (CUPTI's) takes seconds, which the slice must not pay."""
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                env.torch.ones(1, device=env.device).add_(1)
                env.sync()

    def span(self, name):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def tick(self, env, elapsed_s, units=1, size=None):
        if not self.on or self.done:
            return
        if self.prof is None:
            if elapsed_s < self.start_s:
                return
            from torch.profiler import ProfilerActivity, profile

            env.sync()
            self._c0 = time.perf_counter()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self._t0 = time.perf_counter()
            return
        self.units += units
        if size is not None:
            self.sizes.append(size)
        if time.perf_counter() - self._t0 >= self.length_s:
            self.stop(env)

    def stop(self, env):
        if self.prof is not None and not self.done:
            env.sync()
            self.wall_s = time.perf_counter() - self._t0
            self.prof.stop()
            self.cost_s = time.perf_counter() - self._c0  # the window's time the slice took, start and stop included
            self.done = True

    def reduce(self, span_names):
        """The slice as plain lists: device operations (name, start us, end
        us), the benchmark's spans, the union of device activity and the
        breakdown of where the device time and its idle gaps went."""
        if not self.done:
            return None
        from torch.autograd import DeviceType

        t0 = time.perf_counter()
        device, spans = [], []
        for e in self.prof.events():
            if e.device_type == DeviceType.CUDA:
                # a span's projection onto the device timeline covers its gaps: no device work
                if not (getattr(e, "is_user_annotation", False) or e.name in span_names
                        or any(s in e.name for s in NOT_DEVICE_WORK)):
                    device.append((e.name, e.time_range.start, e.time_range.end))
            elif e.name in span_names:
                spans.append((e.name, e.time_range.start, e.time_range.end))
        merged = union(device)
        busy_us = sum(e - s for s, e in merged)
        # the slice's length on the device's own clock, from its first
        # operation's start to its last one's end: converted to the host's
        # clock, device timestamps drift by a few tenths of a percent
        span_us = merged[-1][1] - merged[0][0] if merged else 0.0
        return {"device": device, "spans": spans, "units": self.units, "sizes": self.sizes,
                "cost_s": self.cost_s, "wall_s": span_us / 1e6 if merged else self.wall_s,
                "busy_s": busy_us / 1e6, "breakdown": breakdown(device, merged, spans),
                "reduce_s": time.perf_counter() - t0}


def union(intervals):
    """The union of (name, start, end) intervals as sorted, disjoint
    (start, end) pairs (chip_smoke.py's ``busy_ms``, kept as intervals)."""
    out = []
    for s, e in sorted((s, e) for _, s, e in intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def breakdown(device, merged, spans, top=10):
    """The ``top`` device operations by total time, and the ``top`` longest
    idle gaps between device activity, each named by the innermost span of
    the benchmark's that the host was in at the gap's middle."""
    by_name = {}
    for name, s, e in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2) for a, b in zip(merged, merged[1:])), reverse=True)[:top]
    named = []
    for length, mid in gaps:
        inside = [(e - s, n) for n, s, e in spans if s <= mid <= e]
        named.append([min(inside)[1] if inside else "(between spans)", length / 1e6])
    return {"device_ops": [[n[:120], t] for n, t in ops], "idle_gaps": named}


def host_steps(stamps):
    """How the window's steps spread on the host's clock, from the times
    (seconds into the window) at which each step (or each chunk of steps)
    returned: the median and the longest step in ms, and the steps that
    took over 5 times the median, where the host stood still. Read by no
    metric: it tells a stall apart from a slower step."""
    gaps = [b - a for a, b in zip([0.0, *stamps], stamps)]
    if not gaps:
        return None
    med = sorted(gaps)[len(gaps) // 2]
    return {"median_ms": 1e3 * med, "max_ms": 1e3 * max(gaps),
            "over_5x": sum(g > 5 * med for g in gaps), "over_5x_ms": 1e3 * sum(g for g in gaps if g > 5 * med)}


def read_metrics(cell, specs, ctx):
    out = {}
    for m in specs:
        reader = load_file(cell["readers"][m["name"]], f"port_bench_metric_{m['name']}")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(numbers, limits):
    """[(name, value, limit)] for each number the cell's limits name, and
    whether every one is finite and within its limit (a limit whose number
    the loop did not give fails)."""
    rows = [(k, numbers.get(k, math.nan), limits[k]["limit"]) for k in limits]
    ok = all(math.isfinite(v) and math.isfinite(lim) and v <= lim for _, v, lim in rows)
    return rows, ok


def run_cell(workload, seed, seconds, trace, device="cuda", root=ROOT, overrides=None, t_start=None,
             detail=False, manifest=None):
    """One run of one cell: set-up, window, metrics, the comparison with the
    reference. Returns the result's dict (``checks`` last). The caller looks
    for the card; this runs wherever ``device`` is."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = resolve(manifest or load_manifest(root), workload, root)
    tracer = Tracer(bool(trace), seconds, cell["traffic"].get("trace_slice_s", 2.0))
    env = Env(cell, seed, device, tracer, overrides, detail)
    torch = env.torch
    env.phase("imports", t_start)
    if env.device.type == "cuda":
        torch.cuda.init()
        torch.ones(1, device=env.device)
        env.phase("context", t_start)
    tracer.warm(env)
    loop = load_file(cell["files"]["loop"], f"port_bench_loop_{cell['traffic']['loop']}")
    state = loop.setup(env, t_start)
    env.sync()
    setup_s = time.perf_counter() - t_start
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's way: each window's collections see only its own
    stats = loop.window(state, env, seconds)
    gc.unfreeze()
    tracer.stop(env)
    env.sync()
    on_card = env.device.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(env.device) if on_card else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(env.device)) if on_card else 0,
           "card": card_line() if on_card else None}
    traced = tracer.reduce(set(loop.SPANS)) if trace else None
    if traced is not None:
        dev["busy_s"], dev["window_s"] = traced["busy_s"], traced["wall_s"]
    ctx = {"config": env.config, "traffic": env.traffic, "stats": stats, "trace": traced, "setup_s": setup_s}
    metrics = read_metrics(cell, cell["per_layer"] if trace else cell["end_to_end"], ctx)
    numbers = loop.numbers(state, env)  # frees the program's state, then runs the reference
    rows, ok = judge(numbers, cell["limits"])
    rows.append(("failed", stats["failed"], 0))
    ok = ok and stats["failed"] == 0
    result = {"correct": ok, "attempted": stats["attempted"], "failed": stats["failed"],
              "metrics": metrics, "device": dev}
    if traced is not None:
        result["breakdown"] = traced["breakdown"]
    result["setup_phases"] = env.phases
    if stats.get("host"):
        result["window_host"] = stats["host"]
    if env.detail is not None:
        result["detail"] = env.detail
    result["checks"] = {k: {"value": _finite(v), "limit": _finite(lim)} for k, v, lim in rows}
    return result


def _finite(x):
    """A number as JSON has it: inf and NaN as their names (strict JSON has
    neither)."""
    return x if math.isfinite(x) else repr(float(x))
