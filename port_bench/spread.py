"""How a cell's end-to-end metrics spread between processes (the
benchmark's own runs never run this).

    python3 port_bench/spread.py --workloads gpr-n10k-train,nkn-n10k-train \\
        --seeds 11,12,13,14,15,16 [--sets 2] [--seconds 10] [--roots .,build/old] \\
        [--out chiprun_out/spread/name.jsonl]

Each run is ``<root>/port_bench/run.py --workload W --seed S --seconds T
--trace 0`` (with ``--pending`` where W is in that root's ``pending/``
rather than its BENCHMARK.json) in a process of its own, one at a time, in
sets that each run every seed once (the same seeds in every set). With several roots, each seed
runs in each root in turn, the order reversed from seed to seed. Each root
first runs one short run that is not counted (the first run in a checkout
builds the kernels).

Prints one JSON line a run (its metrics and its ``window_host``), then, for
each workload, root and end-to-end metric, each set's median and spread
(the distance between the quartiles that ``statistics.quantiles(values,
n=4)`` gives, over the median), five times the wider spread (the bound the
benchmark's rule gives), and the mean of the sets' spreads with each set's
run farthest from its median left out (what a bound's half has to stay
above). Writes the lines to ``--out`` as well.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def run_one(root, workload, seed, seconds, timeout=600):
    listed = {w["name"] for w in json.loads((Path(root) / "BENCHMARK.json").read_text())["workloads"]}
    pending = [] if workload in listed else ["--pending"]
    cmd = [sys.executable, str(Path(root) / "port_bench" / "run.py"), *pending, "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"]
    p = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=timeout)
    lines = [line for line in p.stdout.splitlines() if line.startswith("{")]
    rec = {"workload": workload, "seed": seed, "root": str(root), "rc": p.returncode}
    if p.returncode != 0 or not lines:
        rec["stderr"] = p.stderr[-3000:]
        return rec
    res = json.loads(lines[-1])
    rec.update(correct=res["correct"], metrics={k: v["value"] for k, v in res["metrics"].items()},
               host=res.get("window_host"))
    return rec


def spread(values):
    """The distance between the quartiles over the median."""
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed_spread(values):
    """``spread`` of ``values`` without the one farthest from their median."""
    med = statistics.median(values)
    rest = list(values)
    rest.remove(max(values, key=lambda v: abs(v - med)))
    return spread(rest)


def summary(records):
    """Per workload, root and metric: each set's median and spread, five
    times the wider spread, and the mean of the sets' trimmed spreads."""
    groups = {}
    for r in records:
        for k, v in r.get("metrics", {}).items():
            groups.setdefault((r["workload"], r["root"], k), {}).setdefault(r["set"], []).append(v)
    out = []
    for (w, root, k), sets in sorted(groups.items()):
        spreads = [s for s in map(spread, sets.values()) if s is not None]
        trimmed = [s for s in (trimmed_spread(v) for v in sets.values() if len(v) >= 3) if s is not None]
        widest = max(spreads, default=None)
        out.append({"workload": w, "root": root, "metric": k,
                    "sets": {s: {"n": len(v), "median": statistics.median(v), "spread": spread(v),
                                 "values": v} for s, v in sets.items()},
                    "widest": widest, "five_times": 5 * widest if widest is not None else None,
                    "trimmed_mean": statistics.mean(trimmed) if trimmed else None})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--roots", default=".")
    ap.add_argument("--out", default="chiprun_out/spread/spread.jsonl")
    args = ap.parse_args(argv)
    roots = [Path(r).resolve() for r in args.roots.split(",")]
    seeds = [int(s) for s in args.seeds.split(",")]
    workloads = args.workloads.split(",")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    records = []
    with out.open("a") as f:
        def emit(rec):
            print(json.dumps(rec), flush=True)
            f.write(json.dumps(rec) + "\n")
            f.flush()

        for root in roots:
            rec = run_one(root, workloads[0], 1, 1)
            emit({"warm": str(root), "rc": rec["rc"], "stderr": rec.get("stderr", "")[-500:]})
        for workload in workloads:
            for s in range(args.sets):
                for i, seed in enumerate(seeds):
                    for root in (roots if i % 2 == 0 else roots[::-1]):
                        rec = {**run_one(root, workload, seed, args.seconds), "set": s}
                        records.append(rec)
                        emit(rec)
        for row in summary(records):
            emit({"summary": row})
    return 0


if __name__ == "__main__":
    sys.exit(main())
