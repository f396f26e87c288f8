"""Readings from which the limits of ``correct`` are set, for one cell, in
one process (the benchmark's own runs never run this):

- ``program``: the numbers of sound runs of the program, one per seed;
- ``control``: the numbers of the reference put in the program's place,
  computed in the precision below the configuration's (float32 with TF32
  on, for float32 with TF32 off);
- ``fault:<name>``: the numbers of the program with a fault of
  ``faults.py`` planted.

    python3 port_bench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--faults half_batch] [--fault-seeds 7,8,9] [--seconds 2]

Prints one JSON line per reading and, last, for each number the most that
the program's seeds read (the lower reading) and the least that the
control's seeds and each fault's read.
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--pending", action="store_true", help="the cell is in pending/, not in BENCHMARK.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from port_bench import faults, harness

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    manifest = harness.load_manifest(ROOT, pending=args.pending)
    cell = harness.resolve(manifest, args.workload, ROOT)
    lines = []

    def emit(kind, seed, numbers, **extra):
        line = {"workload": args.workload, "kind": kind, "seed": seed, "numbers": numbers, **extra}
        lines.append(line)
        print(json.dumps(line), flush=True)

    for seed in ints(args.seeds):
        t = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, 0, "cuda", ROOT, detail=True, manifest=manifest)
        emit("program", seed, {k: c["value"] for k, c in r["checks"].items()}, correct=r["correct"],
             metrics=r["metrics"], detail=r["detail"], seconds=time.perf_counter() - t)
    if args.control_seeds:
        loop = harness.load_file(cell["files"]["loop"], "port_bench_loop")
        for seed in ints(args.control_seeds):
            env = harness.Env(cell, seed, "cuda", harness.Tracer(False), detail=True)
            emit("control", seed, loop.control(env), detail=env.detail)
    for name in args.faults.split(","):
        if name:
            for seed in ints(args.fault_seeds):
                with faults.FAULTS[name]():
                    r = harness.run_cell(args.workload, seed, args.seconds, 0, "cuda", ROOT, detail=True, manifest=manifest)
                emit(f"fault:{name}", seed, {k: c["value"] for k, c in r["checks"].items()}, correct=r["correct"],
                     detail=r["detail"])

    def num(v):
        return v if isinstance(v, (int, float)) else math.inf

    summary = {}
    for k in cell["limits"]:
        summary[k] = {}
        for kind in sorted({x["kind"] for x in lines}):
            vals = [num(x["numbers"][k]) for x in lines if x["kind"] == kind and k in x["numbers"]]
            if vals:
                summary[k][kind] = max(vals) if kind == "program" else min(vals)
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)


if __name__ == "__main__":
    main()
