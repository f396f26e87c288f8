"""The rank program of tests/test_torch_dist_linalg.py, test_torch_grid_gpr.py
and test_torch_dist_cg_chains.py: one process of a gloo world on the CPU,
importing torch and the port only (no JAX), so that spawning it stays
cheap. It runs one job's cases on the arrays the test gives it, in float64;
rank 0 writes the results to an npz file."""

import numpy as np
import torch
import torch.distributed as dist

import gpflow_slim_tpu_torch as gft

P = gft.parallel
F64 = dict(device="cpu", dtype=torch.float64)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _rows_of(t, mesh, axis):
    """The global tensor from every rank's rows (in coordinate order)."""
    parts = [torch.empty_like(t) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, t.contiguous(), group=mesh.group(axis))
    return torch.cat(parts)


def _grads(loss, model):
    named = gft.params.trainable_leaves(model)
    return dict(zip((n for n, _ in named), torch.autograd.grad(loss, [t for _, t in named])))


def _gpr(c, mean=False):
    kw = {"mean_function": gft.mean_functions.Constant(c=[1.5])} if mean else {}
    m = gft.models.GPR(c["X"], c["Y"], kern=gft.kernels.RBF(1, lengthscales=0.4), **kw, **F64)
    if "unconstrained" in c:
        gft.interop.load_unconstrained(m, c["unconstrained"])
    return m


def _save_loss_and_grads(res, key, loss, grads):
    res[f"{key}/loss"] = loss.detach().numpy()
    res.update({f"{key}/grad/{n}": g.numpy() for n, g in grads.items()})


def job_linalg(world, cases):
    """Ring Gram, distributed GPR, distributed factor and solve, cyclic
    Cholesky, on a 1-D mesh of every rank."""
    res = {}
    mesh = P.make_mesh({"rows": world})
    shard = P.shard_rows(mesh, "rows")
    c = cases["ring"]
    kern = gft.kernels.RBF(2, variance=1.4, lengthscales=0.7).double()
    res["ring"] = _rows_of(P.ring_gram(kern, shard(_t(c["X"])), mesh, "rows"), mesh, "rows").detach().numpy()
    c = cases["matvec"]
    out = P.ring_gram_matvec(gft.kernels.Matern32(2).double(), shard(_t(c["X"])), shard(_t(c["v"])), mesh, "rows",
                             noise=0.3)
    res["matvec"] = _rows_of(out, mesh, "rows").detach().numpy()
    for key, mean, bs in (("mll", False, 8), ("grad", False, 8), ("mean", True, 8)):
        m = _gpr(cases[key], mean)
        loss = P.make_distributed_gpr_loss(m, mesh, axis="rows", block_size=bs)(m)
        _save_loss_and_grads(res, key, loss, _grads(loss, m))
    c = cases["factor"]
    K = _t(c["K"])
    Kl = shard(K).clone().requires_grad_()
    Ll = P.distributed_cholesky(Kl, mesh, "rows", block_size=16)
    res["factor/L"] = _rows_of(Ll.detach(), mesh, "rows").numpy()
    Xl = P.distributed_solve_lower(Ll.detach(), shard(_t(c["B"])), mesh, "rows", block_size=16)
    res["factor/X"] = _rows_of(Xl, mesh, "rows").numpy()
    xl = P.distributed_solve_lower(Ll.detach(), shard(_t(c["B"][:, 0])), mesh, "rows", block_size=16)
    res["factor/x"] = _rows_of(xl, mesh, "rows").numpy()
    lo = Kl.shape[0] * mesh.coordinate("rows")
    f = torch.sum(torch.log(torch.diagonal(Ll[:, lo:lo + Kl.shape[0]])))
    (gK,) = torch.autograd.grad(f, Kl)  # this rank's share, the collectives in the backward
    res["factor/grad"] = _rows_of(gK, mesh, "rows").numpy()
    # the solve's gradients: d sum(X * W) / d(L, B) for a fixed W
    Lr = _t(np.linalg.cholesky(c["K"]))
    Lrl = shard(Lr).clone().requires_grad_()
    Bl = shard(_t(c["B"])).clone().requires_grad_()
    Xl = P.distributed_solve_lower(Lrl, Bl, mesh, "rows", block_size=16)
    gL, gB = torch.autograd.grad(torch.sum(Xl * shard(_t(c["W"]))), (Lrl, Bl))
    res["solve/gL"], res["solve/gB"] = _rows_of(gL, mesh, "rows").numpy(), _rows_of(gB, mesh, "rows").numpy()
    c = cases["cyclic"]
    for look in (True, False):
        res[f"cyclic/{look}"] = P.cyclic_cholesky(_t(c["K"]), mesh, "rows", block_size=16, lookahead=look).numpy()
    K = _t(cases["cyclic_grad"]["K"]).requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(torch.log(torch.diagonal(P.cyclic_cholesky(K, mesh, "rows", 8)))), K)
    res["cyclic_grad"] = g.numpy()
    return res


def _untile(tile, lo):
    """The global matrix of every rank's tile (unpermuted)."""
    N = lo.N
    Kp = tile.new_zeros((N, N))
    lo.tile_of(Kp).copy_(tile)
    lo.psum_c(lo.psum_r(Kp))
    return Kp[np.argsort(lo.row_perm())][:, np.argsort(lo.col_perm())]


def job_grid(world, cases):
    """The grid GPR's pieces on the 2-D meshes of a 4-rank world."""
    res = {}
    for Pr, Pc in ((2, 2), (4, 1), (1, 4)):
        key = f"{Pr}x{Pc}"
        mesh = P.make_mesh({"rows": Pr, "cols": Pc})
        c = cases["gram"]
        lo = P.GridLayout(128, mesh, block_size=16)
        Kp = P.grid_gram(gft.kernels.Matern32(2, lengthscales=0.7).double(), _t(c["X"]), lo, diag_add=0.25)
        res[f"{key}/gram"] = _untile(Kp.detach(), lo).numpy()
        K = _t(cases["tiles"]["K"])
        Kp = lo.tile_of(K[lo.row_perm()][:, lo.col_perm()])
        res[f"{key}/tiles"] = _untile(P.grid_cholesky_tiles(Kp, lo), lo).numpy()
        c = cases["thin"]
        lo = P.GridLayout(96, mesh, block_size=8)
        L = _t(c["L"])
        Lp = lo.tile_of(L[lo.row_perm()][:, lo.col_perm()])
        res[f"{key}/logdet"] = P.grid_gpr.grid_logdet(Lp, lo).numpy()
        res[f"{key}/alpha"] = P.grid_solve_lower_thin(Lp, _t(c["rhs"]), lo).numpy()
        res[f"{key}/beta"] = P.grid_solve_upper_thin(Lp, _t(c["rhs"]), lo).numpy()
        Ip = P.grid_gpr._grid_identity(lo, torch.float64, "cpu")
        res[f"{key}/identity"] = _untile(Ip, lo).numpy()
        Wp = P.grid_solve_lower_wide(Lp, Ip, lo)
        res[f"{key}/inv_L"] = _untile(Wp, lo).numpy()
        res[f"{key}/inv_K"] = _untile(P.grid_gpr._grid_ata(Wp, lo), lo).numpy()
        c = cases["loss"]
        m = gft.models.GPR(c["X"], c["Y"], kern=gft.kernels.RBF(2, lengthscales=[0.4, 0.6], variance=1.3), **F64)
        loss = P.make_grid_gpr_loss(m, mesh, block_size=16)(m)
        _save_loss_and_grads(res, f"{key}/loss", loss, _grads(loss, m))
        bad = gft.models.GPR(c["X"][:64], c["Y"][:64], kern=gft.kernels.RBF(2), **F64)
        try:
            P.make_grid_gpr_loss(m, mesh, block_size=16)(bad)
            res[f"{key}/guard"] = np.array(False)
        except ValueError:
            res[f"{key}/guard"] = np.array(True)
        for N in (64, 128):  # tests/test_parallel.py's grid Cholesky cases, block 8
            res[f"{key}/chol{N}"] = P.grid_cholesky(_t(cases[f"chol{N}"]["K"]), mesh, ("rows", "cols"),
                                                    block_size=8).numpy()
    return res


class _Probes:
    """Given probe matrices in place of ``ops.iterative.cg_probes``."""

    def __init__(self, Zld, Ztr):
        self.Z = (_t(Zld), _t(Ztr))

    def __enter__(self):
        it = gft.ops.iterative
        self.orig, it.cg_probes = it.cg_probes, lambda params, n, num, dtype: self.Z
        return self

    def __exit__(self, *exc):
        gft.ops.iterative.cg_probes = self.orig


def _gauss(x):
    return torch.sum(-0.5 * torch.square(x - 2.0) / 0.5)


def job_cg_chains(world, cases):
    """The distributed CG on given probes; chains over the ranks; the
    dry run."""
    res = {}
    mesh = P.make_mesh({"rows": world})
    c = cases["cg"]
    m = gft.models.GPRCG(c["X"], c["Y"], kern=gft.kernels.RBF(1, lengthscales=c["ls"]), **c["kw"], **F64)
    gft.interop.load_unconstrained(m, c["unconstrained"])
    with _Probes(c["Zld"], c["Ztr"]):
        loss = P.make_distributed_cg_loss(m, mesh, axis="rows", **c["kw"])(m)
        _save_loss_and_grads(res, "cg", loss, _grads(loss, m))
    for name, kw in cases["chains"].items():
        x0 = torch.zeros(kw.pop("shape"), dtype=torch.float64)
        lp = _gauss if name == "nuts" else (lambda x: torch.sum(-0.5 * torch.square(x)))
        samples, info = P.sample_chains(lp, x0, torch.Generator().manual_seed(kw.pop("seed")), mesh=mesh, axis="rows",
                                        **kw)
        res[f"{name}/samples"] = samples.numpy()
        res.update({f"{name}/info/{k}": v.numpy() for k, v in info.items()})
    res["dryrun"] = np.array(str(gft.entry.dryrun_multichip(world, device="cpu", dtype=torch.float64)))
    return res


JOBS = {"linalg": job_linalg, "grid": job_grid, "cg_chains": job_cg_chains}


def run(rank, world, port, job, cases, out_path):
    torch.set_num_threads(1)
    gft.parallel.initialize_distributed(f"localhost:{port}", world, rank, backend="gloo")  # CPU tensors
    try:
        res = JOBS[job](world, cases)
        if rank == 0:
            np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()
