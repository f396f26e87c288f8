"""Matrix-free iterative linear algebra for large-N GP inference
(counterpart of ``gpflow_slim_tpu.ops.iterative``).

GPyTorch-style blackbox matrix-matrix inference (Gardner et al. 2018): CG
solves and a stochastic Lanczos quadrature logdet, with a partial
pivoted-Cholesky preconditioner (Gardner et al. 2021). Every loop runs a
fixed number of steps and reads nothing back to the host: converged CG
columns are masked, not dropped, as in the JAX package, so a matvec that
launches kernels is never followed by a host sync.

The probes of the stochastic estimators are the one place the port cannot
follow the JAX package bit for bit (its threefry keys): it keeps the same
contract instead. ``probe_seed`` hashes the bit patterns of the
hyperparameters on the device, and ``rademacher`` draws from a
counter-based hash of that seed, so the probes are redrawn whenever a
parameter moves, repeat within one evaluation and its gradient, and cost
no host sync. ``models.cg_gpr`` draws its probes through ``cg_probes``
alone, the function tests replace to run the estimators on given probes.

``woodbury_solve_fn``'s factor and ``slq_logdet``'s eigendecomposition
are ``torch.linalg``'s, as the JAX package's are ``jax.scipy``'s and
``jnp.linalg``'s: both are k x k or m x m, not N x N.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

__all__ = ["batched_cg", "lanczos_tridiag", "slq_logdet", "pivoted_cholesky", "woodbury_solve_fn",
           "probe_seed", "rademacher", "cg_probes"]


def _local_sum(x):
    return x


def _norm(x, reduce):
    """The columns' 2-norms; over every rank's rows where ``reduce`` sums."""
    if reduce is _local_sum:
        return torch.linalg.vector_norm(x, dim=0)
    return torch.sqrt(reduce(torch.sum(x * x, dim=0)))


def batched_cg(matvec: Callable, B, max_iters: int = 100, tol: float = 1e-6,
               precond: Callable | None = None, reduce: Callable = _local_sum):
    """Solve A X = B for PSD A with (preconditioned) conjugate gradients.

    B: (N, P); all right-hand sides iterate together (matrix-matrix
    products). Runs a fixed ``max_iters`` with convergence masking:
    converged columns stop updating. ``reduce`` completes each inner
    product's column sums: the identity for rows held whole, a sum over the
    ranks for row shards (``parallel.dist_cg``). Returns (X,
    residual_norms (P,))."""
    if precond is None:
        precond = lambda v: v  # noqa: E731
    X = torch.zeros_like(B)
    R = B
    P = precond(R)
    rz = reduce(torch.sum(R * P, dim=0))
    bnorm = torch.sqrt(reduce(torch.sum(B * B, dim=0))) + 1e-30
    for _ in range(max_iters):
        AP = matvec(P)
        denom = reduce(torch.sum(P * AP, dim=0))
        alpha = rz / torch.where(denom == 0, torch.ones_like(denom), denom)
        active = torch.sqrt(reduce(torch.sum(R * R, dim=0))) / bnorm > tol
        alpha = torch.where(active, alpha, torch.zeros_like(alpha))
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        Z = precond(R)
        rz_new = reduce(torch.sum(R * Z, dim=0))
        beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
        beta = torch.where(active, beta, torch.zeros_like(beta))
        P = Z + beta[None, :] * P
        rz = rz_new
    return X, torch.sqrt(reduce(torch.sum(R * R, dim=0))) / bnorm


def lanczos_tridiag(matvec: Callable, V0, num_steps: int, reduce: Callable = _local_sum):
    """Lanczos tridiagonalization (no reorthogonalization, fixed steps) from
    each column of V0 (N, P) at once; ``reduce`` as ``batched_cg``'s.
    Returns (alphas (num_steps, P), betas (num_steps - 1, P)); a column is
    the JAX package's run from that start vector."""
    V = V0 / _norm(V0, reduce)
    V_prev = torch.zeros_like(V)
    beta = torch.zeros_like(V[0])
    alphas, betas = [], []
    for _ in range(num_steps):
        W = matvec(V) - beta * V_prev
        alpha = reduce(torch.sum(W * V, dim=0))
        W = W - alpha * V
        beta = _norm(W, reduce)
        V_prev, V = V, W / torch.where(beta == 0, torch.ones_like(beta), beta)
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas)[:-1]


def slq_logdet(matvec: Callable, probes, num_steps: int = 20, reduce: Callable = _local_sum):
    """Stochastic Lanczos quadrature estimate of log det A (A PSD) over the
    probe columns (N, num_probes), Rademacher in the JAX package:
    z^T log(A) z ~ ||z||^2 sum_k (e1^T u_k)^2 log lambda_k from each probe's
    tridiagonal T = U diag(lambda) U^T; the mean over the probes. ``reduce``
    as ``batched_cg``'s (N is then the rows over every rank)."""
    dim = float(probes.shape[0])
    if reduce is not _local_sum:  # a fill on the device: no copy from the host
        dim = reduce(torch.full((), dim, dtype=probes.dtype, device=probes.device))
    alphas, betas = lanczos_tridiag(matvec, probes, num_steps, reduce)
    T = torch.diag_embed(alphas.T) + torch.diag_embed(betas.T, 1) + torch.diag_embed(betas.T, -1)
    lam, U = torch.linalg.eigh(T)  # (P, m), (P, m, m)
    lam = torch.clamp(lam, min=1e-10)
    ests = torch.sum(torch.square(U[:, 0, :]) * torch.log(lam), dim=-1) * dim
    return torch.mean(ests)


def pivoted_cholesky(K, rank: int):
    """Partial pivoted Cholesky: K ~ L L^T with L (N, rank), greedy
    max-diagonal pivoting (the GPyTorch preconditioner). Each pivot is an
    argmax gathered on the device: no host sync. A separate mask keeps a
    chosen pivot from being picked again on rank-deficient inputs.

    Past K's numerical rank the remaining diagonal is rounding. The JAX
    package floors a pivot at 1e-12 and goes on, dividing that rounding by
    1e-6, and each such column enters the next one's correction: in float32
    the columns grow without bound (1e26 by the 64th on bench.py's K). Here
    a pivot below the floor, 1e-12 or the dtype's resolution of K's largest
    diagonal entry where that is larger, ends the factor: its column and
    those after it are zero. Above the floor the steps are the JAX
    package's."""
    N = K.shape[0]
    d = torch.diagonal(K).clone()
    L = K.new_zeros((N, rank))
    picked = torch.zeros(N, dtype=torch.bool, device=K.device)
    neg_inf = torch.full((), -torch.inf, dtype=K.dtype, device=K.device)
    floor = torch.clamp(torch.finfo(K.dtype).eps * torch.max(d), min=1e-12)
    live = torch.ones((), dtype=torch.bool, device=K.device)
    for i in range(rank):
        p = torch.argmax(torch.where(picked, neg_inf, d)).reshape(1)
        pivot = d.index_select(0, p)
        live = live & (pivot[0] >= floor)
        pivot = torch.maximum(pivot, floor)
        corr = L @ L.index_select(0, p)[0]
        col = (K.index_select(0, p)[0] - corr) / torch.sqrt(pivot)
        col = torch.where(live, col.index_put((p,), torch.sqrt(pivot)), torch.zeros_like(col))
        L[:, i] = col
        d = torch.clamp(d - torch.square(col), min=0.0)
        picked = picked.index_put((p,), torch.ones_like(p, dtype=torch.bool))
    return L


def woodbury_solve_fn(L, sigma2):
    """``v -> (L L^T + sigma2 I)^-1 v`` by Woodbury, for preconditioning CG.
    L: (N, k); O(N k) per apply after an O(k^3) setup."""
    k = L.shape[1]
    M = torch.eye(k, dtype=L.dtype, device=L.device) + (L.T @ L) / sigma2
    # cholesky_ex reads nothing back to the host; a failed factor is NaN,
    # as jax.scipy's is
    Mchol, info = torch.linalg.cholesky_ex(M)
    Mchol = torch.where(info == 0, Mchol, torch.full_like(Mchol, torch.nan))

    def solve(v):
        inner = torch.cholesky_solve(L.T @ v, Mchol)
        return v / sigma2 - (L @ inner) / (sigma2 * sigma2)

    return solve


_M32 = 0xFFFFFFFF


def _mul32(a, b):
    # (a * b) mod 2^32 for int64 tensors (or a constant b) holding uint32
    # values, without overflowing int64: b in 16-bit halves
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _M32


def _bits(x):
    """The bit pattern of a float tensor as uint32 words in int64: one per
    float32 element, two (low, high) per float64 element, so a float64 step
    below float32 resolution still changes the seed."""
    x = x.detach().reshape(-1)
    if x.dtype == torch.float64:
        w = x.view(torch.int64)
        return torch.stack([w & _M32, (w >> 32) & _M32], dim=1).reshape(-1)
    return x.to(torch.float32).view(torch.int32).to(torch.int64) & _M32


def probe_seed(*tensors):
    """A 32-bit seed (a 0-d int64 tensor on the tensors' device) hashed from
    the bit patterns of ``tensors`` in order, on the device: order- and
    position-sensitive, as the JAX package's ``probe_keys`` (each leaf's
    words weighted by a position-dependent odd multiplier, the leaves folded
    in FNV style)."""
    acc = None
    for idx, t in enumerate(tensors):
        bits = _bits(t)
        mult = _mul32(torch.arange(bits.shape[0], device=bits.device, dtype=torch.int64), 2654435761)
        mult = (mult + 2 * idx + 1) & _M32
        leaf = torch.sum(_mul32(bits, mult)) & _M32
        acc = leaf if acc is None else (_mul32(acc, 16777619) ^ leaf)
    return acc


def _fmix32(h):
    # murmur3's finalizer on int64 tensors holding uint32 values
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def rademacher(seed, stream: int, shape, dtype):
    """+-1 entries of ``shape``, each a bit of a counter-based hash of
    (``seed``, ``stream``, its index): deterministic given the seed, drawn
    on the seed's device."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, device=seed.device, dtype=torch.int64)
    key = _fmix32((seed ^ _mul32(torch.full((), stream + 1, device=seed.device, dtype=torch.int64),
                                 0x9E3779B9)) & _M32)
    h = _fmix32(key ^ _mul32(idx, 0x27D4EB2D))
    return (1.0 - 2.0 * ((h >> 7) & 1).to(dtype)).reshape(shape)


def cg_probes(params, N: int, num_probes: int, dtype):
    """The two (N, num_probes) Rademacher probe matrices of one CG-GPR
    evaluation, ``(logdet probes, trace probes)``, from ``probe_seed`` of
    ``params``: the counterpart of ``probe_keys`` and its two
    ``jax.random.rademacher`` draws. Tests replace this function with one
    that returns given probe matrices."""
    seed = probe_seed(*params)
    return rademacher(seed, 0, (N, num_probes), dtype), rademacher(seed, 1, (N, num_probes), dtype)
