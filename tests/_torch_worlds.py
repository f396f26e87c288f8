"""Gloo worlds on the CPU for the port's distributed tests: each world runs
one job of ``tests/_torch_dist_worker.py`` (which imports no JAX) in
``n`` spawned processes on a free port, and is joined against a deadline:
a hung collective kills its ranks and fails the test that asked for the
world, it never holds the suite."""

import socket
import time

import numpy as np
import torch.multiprocessing as mp

DEADLINE_S = 120.0  # a world's start, work and exit


def free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(job, n, cases, out_dir):
    """The results rank 0 of an ``n``-rank world wrote for ``job``."""
    import _torch_dist_worker as worker

    out = out_dir / f"{job}{n}.npz"
    ctx = mp.start_processes(worker.run, args=(n, free_port(), job, cases, str(out)), nprocs=n, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"the {n}-rank world of {job!r} did not finish in {DEADLINE_S:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    return dict(np.load(out))
