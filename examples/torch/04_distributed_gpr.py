"""Distributed exact GPR: the ring Gram and the blocked Cholesky over the
ranks of a mesh axis (BASELINE config #5's shape), on gpflow_slim_tpu_torch:
the twin of examples/04_distributed_gpr.py. Runs on the CUDA device in
float32 (the hand-written kernels) as a world of one rank (nccl) unless
given ``--device cpu``, where ``--ranks n`` spawns a gloo world of n ranks.

Run: python examples/torch/04_distributed_gpr.py [--device cpu] [--ranks n]
"""

import argparse
import os
import pathlib
import socket
import sys

import numpy as np
import torch.distributed as dist
import torch.multiprocessing as mp

FAST = os.environ.get("GFS_EXAMPLE_FAST") == "1"  # tiny sizes for tests/test_torch_examples.py smoke runs

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))  # the repo root
import gpflow_slim_tpu_torch as gft  # noqa: E402


def main(rank, ranks, port, device):
    backend = "nccl" if device == "cuda" else "gloo"
    gft.parallel.initialize_distributed(f"localhost:{port}", ranks, rank, backend=backend)
    try:
        mesh = gft.parallel.make_mesh({"rows": ranks})
        if rank == 0:
            print(f"mesh: {ranks} ranks on axis 'rows' ({backend})")
        rng = np.random.RandomState(0)
        N = 512 if FAST else 1024  # config #5 runs N=50000 on one card (chip_smoke.py)
        X = rng.uniform(0, 1, (N, 1)).astype(np.float32)
        Y = (np.sin(12 * X) + 0.1 * rng.randn(N, 1)).astype(np.float32)
        m = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.1), device=device)
        loss_fn = gft.parallel.make_distributed_gpr_loss(m, mesh, axis="rows", block_size=64 if FAST else 128)
        loss = loss_fn(m)
        loss.backward()  # the gradient of the global loss, on every rank
        single = m.objective().item()
        if rank == 0:
            print(f"distributed -log p(Y) = {loss.item():.2f}")
            print("matches single-device:", abs(loss.item() - single) < 1e-2)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--ranks", type=int, default=1)
    args = parser.parse_args()
    if args.device == "cuda" and args.ranks != 1:
        parser.error("one card a rank: this machine's world on the card has one rank")
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    if args.ranks == 1:
        main(0, 1, port, args.device)
    else:
        mp.start_processes(main, args=(args.ranks, port, args.device), nprocs=args.ranks, start_method="spawn")
