"""Run one cell of the benchmark of gpflow_slim_tpu_torch once.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1> [--pending]
    python3 port_bench/run.py --list

Prints the result as one JSON object on the last line of standard output
and each number compared with the reference, beside its limit, as the last
lines of standard error. Exits non-zero, printing no result, where the
card (or the number of cards the cell asks for) is missing, where a module
of JAX was loaded, or where the run fails. ``--list`` prints each cell with
the files it is made of. ``--pending`` adds the cells and metrics of
``port_bench/pending/`` to BENCHMARK.json's, so that a cell held back
there runs as it would once admitted.
"""

import time

T_START = time.perf_counter()  # set-up counts from here: imports, context, data, build, warm-up

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def process_env(root):
    """Every cache at a fixed path inside the checkout (the kernels' own
    build directory is ``build/kernels/``, fixed by the program), and one
    host thread for torch's CPU work: the load comes from one process with
    few threads."""
    os.environ["CUDA_CACHE_PATH"] = str(root / "build" / "cuda_cache")
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[k] = "1"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--pending", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from port_bench import harness

    manifest = harness.load_manifest(ROOT, pending=args.pending)
    if args.list:
        for w in manifest["workloads"]:
            cell = harness.resolve(manifest, w["name"], ROOT)
            files = {k: str(p.relative_to(ROOT)) for k, p in {**cell["files"], **cell["readers"]}.items()}
            print(json.dumps({"workload": w["name"], "chips": w["chips"], "files": files}))
        return 0
    if args.workload is None or args.seed is None or args.seconds is None:
        ap.error("--workload, --seed and --seconds are required")
    cell = harness.resolve(manifest, args.workload, ROOT)
    process_env(ROOT)
    import torch

    torch.set_num_threads(1)

    import gpflow_slim_tpu_torch  # noqa: F401  (the program under test: a checkout without it fails here)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, args.trace, "cuda", ROOT,
                              t_start=T_START, manifest=manifest)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX loaded in the run: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
