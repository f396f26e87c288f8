"""End-to-end 2-D (rows x cols) block-cyclic distributed exact GPR
(counterpart of ``gpflow_slim_tpu.parallel.grid_gpr``).

The N x N Gram is built in tiles over a 2-D rank grid, factored in place
and consumed by distributed solves: no step of the loss, value or
gradient, holds an unsharded N x N tensor. Block (i, j) of the matrix lives
on the rank at grid position (i mod Pr, j mod Pc), at local slot
(i // Pr, j // Pc); a rank's tile is its (R_loc bs, C_loc bs) block of the
block-cyclically permuted matrix. Every masked ``psum`` of the JAX package
along one mesh axis is an ``all_reduce`` on that axis's line group
(``Mesh.group``), skipped where the axis has one rank.

Pieces: ``grid_gram`` (a rank's tile of the Gram from the replicated X:
the **cross-Gram kernel** on the kernel route), ``grid_cholesky_tiles``
(the in-layout factor: each step's diagonal block on the **factor-only
Cholesky kernel** and its inverse by the **wide TRSM** against the
identity), ``grid_solve_lower_thin`` / ``grid_solve_upper_thin``
(replicated (N, P) right-hand sides), ``grid_solve_lower_wide`` (a tiled
right-hand side), ``grid_logdet``, ``grid_nll`` (an autograd Function
whose backward builds K^-1's tiles by the wide grid TRSM and the SUMMA
``W^T W``) and ``make_grid_gpr_loss``. The tile functions take and return
tiles and run without autograd; the loss is differentiable.

Gradient: with beta = K^-1 err, dmll/dK = 1/2 (beta beta^T - num_out K^-1)
on each tile, so the chain rule into the kernel's hyperparameters runs
through the tile's Gram; each rank's is its share (``parallel._shares``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import blocked
from ..ops.gram import full_precision
from . import _shares
from .mesh import Mesh

__all__ = ["GridLayout", "grid_gram", "grid_cholesky_tiles", "grid_solve_lower_thin", "grid_solve_upper_thin",
           "grid_solve_lower_wide", "grid_logdet", "grid_nll", "make_grid_gpr_loss"]


class GridLayout:
    """A 2-D block-cyclic layout of an N x N matrix over the mesh axes
    ``axes`` (rows, cols), and this rank's place in it."""

    def __init__(self, N: int, mesh: Mesh, axes=("rows", "cols"), block_size: int = 128):
        self.N, self.mesh = N, mesh
        self.r_ax, self.c_ax = axes
        self.Pr, self.Pc = mesh.shape[self.r_ax], mesh.shape[self.c_ax]
        self.bs = block_size
        if N % block_size:
            raise ValueError(f"N={N} not divisible by block_size={block_size}")
        self.nb = N // block_size
        if self.nb % self.Pr or self.nb % self.Pc:
            raise ValueError(f"nb={self.nb} must divide by mesh axes ({self.Pr},{self.Pc})")
        self.R_loc, self.C_loc = self.nb // self.Pr, self.nb // self.Pc
        self.r, self.c = mesh.coordinate(self.r_ax), mesh.coordinate(self.c_ax)
        self.r_groups = _shares.groups_of(mesh, [self.r_ax])
        self.c_groups = _shares.groups_of(mesh, [self.c_ax])

    def local_row_idx(self):
        """Original row indices of this rank's tile rows (numpy)."""
        blocks = self.r + self.Pr * np.arange(self.R_loc)
        return (blocks[:, None] * self.bs + np.arange(self.bs)[None, :]).reshape(-1)

    def local_col_idx(self):
        blocks = self.c + self.Pc * np.arange(self.C_loc)
        return (blocks[:, None] * self.bs + np.arange(self.bs)[None, :]).reshape(-1)

    def row_perm(self):
        order = np.concatenate([np.arange(d, self.nb, self.Pr) for d in range(self.Pr)])
        return (order[:, None] * self.bs + np.arange(self.bs)[None, :]).ravel()

    def col_perm(self):
        order = np.concatenate([np.arange(d, self.nb, self.Pc) for d in range(self.Pc)])
        return (order[:, None] * self.bs + np.arange(self.bs)[None, :]).ravel()

    def tile_of(self, Kp):
        """This rank's tile of the permuted global matrix ``Kp``."""
        h, w = self.R_loc * self.bs, self.C_loc * self.bs
        return Kp[self.r * h:(self.r + 1) * h, self.c * w:(self.c + 1) * w]

    def psum_r(self, t):
        return _shares.sum_over(t, self.r_groups)

    def psum_c(self, t):
        return _shares.sum_over(t, self.c_groups)


def _idx(a, like):
    return torch.as_tensor(a, device=like.device)


def grid_gram(kern, X, layout: GridLayout, diag_add=0.0):
    """This rank's tile of ``K(X, X) + diag_add I``, from the replicated X
    (N, D): ``kern.K`` of its rows and columns of X. Differentiable in the
    kernel's parameters and ``diag_add``."""
    lo = layout
    ri, ci = lo.local_row_idx(), lo.local_col_idx()
    tile = kern.K(X[_idx(ri, X)], X[_idx(ci, X)])
    eye = torch.as_tensor(ri[:, None] == ci[None, :], dtype=tile.dtype, device=tile.device)
    return tile + diag_add * eye


def _owned_rows(lo):
    return np.repeat(lo.r + lo.Pr * np.arange(lo.R_loc), lo.bs)  # block row of each tile row


@torch.no_grad()
def grid_cholesky_tiles(Kp, layout: GridLayout):
    """Factor a tiled SPD matrix in layout: this rank's tile ``Kp`` -> its
    tile of the lower factor (nothing gathered)."""
    lo = layout
    Pr, Pc, bs = lo.Pr, lo.Pc, lo.bs
    Ka = Kp.clone(memory_format=torch.contiguous_format)
    row_ids = _idx(_owned_rows(lo), Ka)
    pos = torch.arange(lo.R_loc * bs, device=Ka.device) % bs
    my_cols = lo.c + Pc * np.arange(lo.C_loc)
    src, slot = my_cols % Pr, my_cols // Pr  # owner row-rank of block j, its local row slot
    mine = _idx(src == lo.r, Ka)
    slot_t = _idx(np.where(src == lo.r, slot, 0), Ka)
    for k in range(lo.nb):
        kc_owner = lo.c == k % Pc
        jc = k // Pc
        colblk = Ka[:, jc * bs:(jc + 1) * bs].clone() if kc_owner else Ka.new_zeros((lo.R_loc * bs, bs))
        colblk = lo.psum_c(colblk)
        is_diag_row = (row_ids == k)[:, None]
        onehot = (is_diag_row & (pos[:, None] == torch.arange(bs, device=Ka.device)[None, :])).to(Ka.dtype)
        with full_precision():
            diag = lo.psum_r(onehot.T @ colblk)
        Lkk = blocked.factor_block(diag)
        Zinv = blocked.tri_solve(Lkk, torch.eye(bs, dtype=Ka.dtype, device=Ka.device), True)
        below = (row_ids > k)[:, None]
        with full_precision():
            trsm = colblk @ Zinv.mT
            Lkk_rows = onehot @ Lkk
        newcol = torch.where(below, trsm, torch.where(is_diag_row, Lkk_rows, colblk))
        if kc_owner:
            Ka[:, jc * bs:(jc + 1) * bs] = newcol
        # the rows of the panel this rank's column blocks need: a masked sum
        # along the row axis (the JAX package's row-scoped broadcast)
        Lmask = torch.where(below, newcol, torch.zeros_like(newcol))
        cand = Lmask.reshape(lo.R_loc, bs, bs)[slot_t]
        Lc = lo.psum_r(torch.where(mine[:, None, None], cand, torch.zeros_like(cand)))
        with full_precision():
            Ka.addmm_(Lmask, Lc.reshape(lo.C_loc * bs, bs).mT, alpha=-1.0)
    keep = torch.as_tensor(lo.local_row_idx()[:, None] >= lo.local_col_idx()[None, :], device=Ka.device)
    return Ka.mul_(keep)


@torch.no_grad()
def grid_logdet(Lp, layout: GridLayout):
    """sum log diag(L) over the tiled factor (a scalar, on every rank)."""
    lo = layout
    mask = torch.as_tensor(lo.local_row_idx()[:, None] == lo.local_col_idx()[None, :], device=Lp.device)
    s = torch.sum(torch.log(Lp[mask]))
    return lo.psum_c(lo.psum_r(s.reshape(1)))[0]


def _diag_block(lo, Ll, k):
    """The (bs, bs) diagonal block L_kk, from its owner to every rank."""
    bs = lo.bs
    own = lo.r == k % lo.Pr and lo.c == k % lo.Pc
    blk = Ll[(k // lo.Pr) * bs:(k // lo.Pr + 1) * bs, (k // lo.Pc) * bs:(k // lo.Pc + 1) * bs]
    return lo.psum_c(lo.psum_r(blk.clone() if own else Ll.new_zeros((bs, bs))))


@torch.no_grad()
def grid_solve_lower_thin(Lp, rhs, layout: GridLayout):
    """``L^-1 rhs`` for a replicated thin (N, P) right-hand side: block
    forward substitution, a (bs, P) and a (bs, bs) sum a step. Returns the
    (N, P) solution on every rank."""
    lo = layout
    bs = lo.bs
    col_idx = _idx(lo.local_col_idx(), Lp)
    alpha = rhs.clone()
    for k in range(lo.nb):
        rowslab = Lp[(k // lo.Pr) * bs:(k // lo.Pr + 1) * bs]
        done = (col_idx < k * bs).to(alpha.dtype)[:, None]
        with full_precision():
            part = rowslab @ (alpha[col_idx] * done)
        s = lo.psum_c(lo.psum_r(part if lo.r == k % lo.Pr else torch.zeros_like(part)))
        Lkk = _diag_block(lo, Lp, k)
        alpha[k * bs:(k + 1) * bs] = blocked.tri_solve(Lkk, alpha[k * bs:(k + 1) * bs] - s, True)
    return alpha


@torch.no_grad()
def grid_solve_upper_thin(Lp, rhs, layout: GridLayout):
    """``L^-T rhs`` against the tiled lower factor, replicated thin
    right-hand side: block backward substitution. Returns the (N, P)
    solution on every rank."""
    lo = layout
    bs = lo.bs
    row_idx = _idx(lo.local_row_idx(), Lp)
    beta = rhs.clone()
    for k in range(lo.nb - 1, -1, -1):
        colslab = Lp[:, (k // lo.Pc) * bs:(k // lo.Pc + 1) * bs]
        done = (row_idx >= (k + 1) * bs).to(beta.dtype)[:, None]
        with full_precision():
            part = colslab.mT @ (beta[row_idx] * done)
        s = lo.psum_r(lo.psum_c(part if lo.c == k % lo.Pc else torch.zeros_like(part)))
        Lkk = _diag_block(lo, Lp, k)
        beta[k * bs:(k + 1) * bs] = blocked.tri_solve(Lkk.mT, beta[k * bs:(k + 1) * bs] - s, False)
    return beta


@torch.no_grad()
def grid_solve_lower_wide(Lp, Bp, layout: GridLayout):
    """2-D distributed TRSM: the tile of ``L^-1 B`` for tiled ``L`` and
    ``B`` (N, N). Right-looking: at step k the L panel is summed down the
    mesh columns, B's block row k down the mesh rows, and the trailing
    update is one local product."""
    lo = layout
    bs = lo.bs
    row_idx = _idx(lo.local_row_idx(), Lp)
    eye = torch.eye(bs, dtype=Lp.dtype, device=Lp.device)
    Bl = Bp.clone(memory_format=torch.contiguous_format)
    for k in range(lo.nb):
        own_c, own_r = lo.c == k % lo.Pc, lo.r == k % lo.Pr
        colsl = Lp[:, (k // lo.Pc) * bs:(k // lo.Pc + 1) * bs]
        colblk = lo.psum_c(colsl.clone() if own_c else Lp.new_zeros(colsl.shape))
        dslab = colblk[(k // lo.Pr) * bs:(k // lo.Pr + 1) * bs]
        Lkk = lo.psum_r(dslab.clone() if own_r else torch.zeros_like(dslab))
        Zinv = blocked.tri_solve(Lkk, eye, True)
        rows_k = slice((k // lo.Pr) * bs, (k // lo.Pr + 1) * bs)
        rowB = lo.psum_r(Bl[rows_k].clone() if own_r else Bl.new_zeros((bs, Bl.shape[1])))
        with full_precision():
            Wk = Zinv @ rowB
        if own_r:
            Bl[rows_k] = Wk
        below = (row_idx >= (k + 1) * bs).to(Bl.dtype)[:, None]
        with full_precision():
            Bl.addmm_(colblk * below, Wk, alpha=-1.0)
    return Bl


def _grid_identity(layout: GridLayout, dtype, device):
    """This rank's tile of the identity."""
    lo = layout
    return torch.as_tensor(lo.local_row_idx()[:, None] == lo.local_col_idx()[None, :], dtype=dtype, device=device)


@torch.no_grad()
def _grid_ata(Wp, layout: GridLayout):
    """SUMMA-style tile of ``W^T W``: at step k, W's block row k is summed
    down the mesh rows, and the blocks of it for this rank's row blocks are
    summed along the mesh columns; one local product into the tile."""
    lo = layout
    bs = lo.bs
    row_blocks = lo.r + lo.Pr * np.arange(lo.R_loc)
    src, slot = row_blocks % lo.Pc, row_blocks // lo.Pc  # owner col-rank of block i, its local col slot
    mine = _idx(src == lo.c, Wp)
    slot_t = _idx(np.where(src == lo.c, slot, 0), Wp)
    C = torch.zeros_like(Wp)
    for k in range(lo.nb):
        own_r = lo.r == k % lo.Pr
        rowsl = Wp[(k // lo.Pr) * bs:(k // lo.Pr + 1) * bs]
        rowW = lo.psum_r(rowsl.clone() if own_r else torch.zeros_like(rowsl))
        cand = rowW.reshape(bs, lo.C_loc, bs).transpose(0, 1)[slot_t]
        Wi = lo.psum_c(torch.where(mine[:, None, None], cand, torch.zeros_like(cand)))  # (R_loc, bs, bs)
        with full_precision():
            C.addmm_(Wi.transpose(0, 1).reshape(bs, lo.R_loc * bs).mT, rowW)
    return C


def _outer_tiles(beta, layout: GridLayout):
    """This rank's tile of ``beta beta^T`` (summed over the columns of the
    replicated beta)."""
    lo = layout
    with full_precision():
        return beta[_idx(lo.local_row_idx(), beta)] @ beta[_idx(lo.local_col_idx(), beta)].mT


class _GridNLL(torch.autograd.Function):
    """Forward: ``-log N(err; 0, K)`` from K's tiles (factor, thin solve,
    logdet). Backward: ``K-bar = g/2 (num_out K^-1 - beta beta^T)`` in tiles
    (K^-1 = W^T W, W = L^-1 by the wide grid TRSM), ``err-bar = g beta``."""

    @staticmethod
    def forward(Kp, err, layout):
        lo = layout
        Lp = grid_cholesky_tiles(Kp, lo)
        alpha = grid_solve_lower_thin(Lp, err, lo)
        num_out = err.shape[1]
        nll = 0.5 * lo.N * num_out * math.log(2.0 * math.pi) + num_out * grid_logdet(Lp, lo) \
            + 0.5 * torch.sum(torch.square(alpha))
        return nll, Lp, alpha

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.layout = inputs[2]
        _, Lp, alpha = output
        ctx.mark_non_differentiable(Lp, alpha)
        ctx.save_for_backward(Lp, alpha)

    @staticmethod
    def backward(ctx, g, _gL, _galpha):
        Lp, alpha = ctx.saved_tensors
        lo = ctx.layout
        beta = grid_solve_upper_thin(Lp, alpha, lo)
        Wp = grid_solve_lower_wide(Lp, _grid_identity(lo, Lp.dtype, Lp.device), lo)  # W = L^-1
        Kinv = _grid_ata(Wp, lo)  # K^-1 = W^T W
        del Wp
        Kbar = Kinv.mul_(alpha.shape[1]).sub_(_outer_tiles(beta, lo)).mul_(0.5 * g)
        return Kbar, g * beta, None


def grid_nll(Kp, err, layout: GridLayout):
    """-log marginal likelihood of MVN(err; 0, K) from this rank's tile
    ``Kp`` and the replicated ``err`` (N, P); differentiable in both."""
    return _GridNLL.apply(Kp, err, layout)[0]


def make_grid_gpr_loss(model, mesh: Mesh, axes=("rows", "cols"), block_size: int = 128):
    """``loss_fn(m) -> -(mll + log_prior)`` of exact GPR over a 2-D mesh:
    the tiled Gram -> the in-layout factor -> the thin solves -> a scalar,
    the same on every rank; ``loss.backward()`` leaves the single-device
    gradient in every rank's parameters. The only replicated arrays are X
    (N x D), the thin solves (N x P) and the hyperparameters; everything
    N x N lives in tiles, forward and backward. ``model.X``/``model.Y`` are
    captured here (the model passed to ``loss_fn`` contributes its
    hyperparameters only)."""
    X, Y = model.X, model.Y
    layout = GridLayout(X.shape[0], mesh, axes=axes, block_size=block_size)
    groups = layout.r_groups + layout.c_groups
    n = layout.Pr * layout.Pc

    def local(m):
        noise = torch.squeeze(m.likelihood.variance.value)
        Kp = grid_gram(m.kern, X, layout, diag_add=noise)
        err = _shares.share(Y - m.mean_function(X), n)
        return grid_nll(Kp, err, layout) - _shares.share(m.log_prior(), n)

    def loss_fn(m):
        if m.X.shape != X.shape or m.Y.shape != Y.shape:
            raise ValueError(f"make_grid_gpr_loss captured data of shape X{tuple(X.shape)}/Y{tuple(Y.shape)}; got "
                             f"a model with X{tuple(m.X.shape)}/Y{tuple(m.Y.shape)}: rebuild the loss for new data")
        return _shares.with_summed_grads(m, groups, local)

    loss_fn.layout = layout
    return loss_fn
