#!/usr/bin/env python3
"""chip_smoke.py's phase 4j alone, on one NVIDIA GPU: the distributed
exact-GP paths on a world of one rank (nccl).

    python3 tools/dist_phase4j.py [--paths]

Builds the kernels, then runs config #5 (N=50000, example 05's deep
kernel) through ``make_distributed_gpr_loss``: one objective + gradient
under the profiler (wall time, device busy time and idle share, peak
memory, launches by kernel), the value and every gradient against the
float64 oracle; then the phase's kernel rows (the cross Gram of a ring
panel, the factor-only Cholesky of a diagonal block, the wide TRSM of the
panel below it). ``--paths`` adds the checks on bench.py's GPR (the
distributed loss against one device, the cyclic and grid factors, the grid
loss, the distributed CG, the ring matvec), config #4's chains on the
1-rank mesh and ``entry.dryrun_multichip(1)``. The card's name and power
limit come first.
"""

import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
import gpflow_slim_tpu_torch as gft  # noqa: E402
from gpflow_slim_tpu_torch.ops import _build, cholesky, gram, trsm  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("dist_phase4j: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card)
    t0 = time.perf_counter()
    _build.build()
    _build.load_library()
    print(f"build {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    gft.parallel.initialize_distributed(f"localhost:{cs.free_port()}", 1, 0)
    try:
        mesh = gft.parallel.make_mesh({"rows": 1})
        t0 = time.perf_counter()
        out = cs.dist_config5(gft, torch, gram, cholesky, trsm, mesh, dev, card)
        print(f"config #5 checks {time.perf_counter() - t0:.1f} s")
        if "--paths" in sys.argv:
            t0 = time.perf_counter()
            cs.dist_paths(gft, torch, gram, cholesky, trsm, mesh, dev, card)
            print(f"bench.py GPR paths, chains, dry run {time.perf_counter() - t0:.1f} s")
    finally:
        torch.distributed.destroy_process_group()
    rows = cs.slice4j_times(gft, torch, gram, cholesky, trsm, out["model"], dev)
    for name, r in rows.items():
        print(name, {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
