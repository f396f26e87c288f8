"""The rank program of tests/test_torch_dp.py: one process of a gloo world
on the CPU, importing torch and the port only (no JAX), so that spawning
it stays cheap. Rank 0 writes the results to an npz file."""

import numpy as np
import torch
import torch.distributed as dist

import gpflow_slim_tpu_torch as gft

FIT_STEPS, FIT_B, FIT_LR, FIT_SEED = 5, 64, 0.05, 0


def svgp(case, arrays):
    """The SVGP of a case, at the JAX model's unconstrained point."""
    if case == "bernoulli":  # tests/test_parallel.py's test_dp_svgp_grad_matches_single_device
        X, Y = arrays["X"], arrays["Y"]
        m = gft.models.SVGP(X, Y, kern=gft.kernels.RBF(2), likelihood=gft.likelihoods.Bernoulli(), Z=X[:8].copy(),
                            device="cpu", dtype=torch.float64)
    elif case == "priors":  # test_dp_svgp_grad_matches_with_priors
        X, Y = arrays["X"], arrays["Y"]
        k = gft.kernels.RBF(1)
        k.variance = gft.params.Param(1.0, transform=gft.transforms.positive(), prior=gft.priors.LogNormal(0.0, 1.0),
                                      name="variance")
        m = gft.models.SVGP(X, Y, kern=k, likelihood=gft.likelihoods.Gaussian(), Z=X[:4].copy(), device="cpu",
                            dtype=torch.float64)
    else:  # test_fit_svgp_sharded_trains
        X, Y = arrays["X"], arrays["Y"]
        m = gft.models.SVGP(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.3), likelihood=gft.likelihoods.Bernoulli(),
                            Z=np.linspace(0, 1, 16)[:, None], device="cpu", dtype=torch.float64)
    if "unconstrained" in arrays:
        gft.interop.load_unconstrained(m, arrays["unconstrained"])
    return m


def run(rank, world, port, cases, out_path):
    torch.set_num_threads(1)
    gft.parallel.initialize_distributed(f"localhost:{port}", world, rank, backend="gloo")  # CPU tensors
    try:
        res = {}
        mesh = gft.parallel.make_mesh({"data": world})
        for case in ("bernoulli", "priors"):
            arrays = cases[case]
            m = svgp(case, arrays)
            B = arrays["B"]
            loss, grads = gft.parallel.dp_value_and_grad(m, arrays["X"][:B], arrays["Y"][:B], mesh, axis="data")
            res[f"{case}/loss"] = loss.numpy()
            res.update({f"{case}/grad/{n}": g.numpy() for n, g in grads.items()})
        try:  # a batch the ranks do not divide
            gft.parallel.dp_value_and_grad(m, arrays["X"][:31], arrays["Y"][:31], mesh)
            res["raised"] = np.array(False)
        except ValueError:
            res["raised"] = np.array(True)
        m = svgp("fit", cases["fit"])
        _, losses = gft.parallel.fit_svgp(m, FIT_STEPS, torch.Generator().manual_seed(FIT_SEED),
                                          learning_rate=FIT_LR, batch_size=FIT_B, mesh=mesh)
        res["fit/losses"] = losses.numpy()
        res.update({f"fit/param/{n}": t.detach().numpy() for n, t in gft.params.trainable_leaves(m)})
        if world == 4:  # two named axes: a sum over "cols" adds this rank's row pair
            mesh2 = gft.parallel.make_mesh({"rows": 2, "cols": -1})
            x = torch.tensor([float(rank)])
            dist.all_reduce(x, group=mesh2.group("cols"))
            got = torch.zeros(world)
            got[rank] = x
            dist.all_reduce(got)
            res["mesh2/cols_sum"] = got.numpy()
            res["mesh2/shape"] = np.array(list(mesh2.shape.values()))
        if rank == 0:
            np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()
