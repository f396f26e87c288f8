"""Plain torch pieces the references share: the precision they run in, the
RBF Gram, the positive transform and Adam. Nothing here imports the
program."""

import torch
import torch.nn.functional as F


class Precision:
    """float64 (the reference), or float32 with TF32 matrix products on (the
    control: the program's float32 runs with TF32 off)."""

    def __init__(self, dtype):
        self.tf32 = dtype == torch.float32

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.tf32
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def rbf(A, B, lengthscale, variance):
    """variance exp(-|a - b|^2 / (2 lengthscale^2)), the squared distance
    expanded into a matrix product."""
    As, Bs = A / lengthscale, B / lengthscale
    sq = (As**2).sum(1)[:, None] - 2 * As @ Bs.T + (Bs**2).sum(1)[None, :]
    return variance * torch.exp(-0.5 * sq.clamp_min(0))


def positive(u, floor):
    """softplus(u) + floor."""
    return F.softplus(u) + floor


def unconstrain(y, floor, dtype, device):
    """The u with positive(u, floor) = y, worked out in float64."""
    y = torch.as_tensor(y, dtype=torch.float64) - floor
    return torch.log(torch.expm1(y)).to(dtype=dtype, device=device)


def adam(params, grads, state, lr, betas=(0.9, 0.999), eps=1e-8):
    """One Adam update of ``params`` (a dict, entries replaced) by ``grads``
    (Kingma & Ba; eps added outside the square root)."""
    state["t"] = t = state.get("t", 0) + 1
    for k, g in grads.items():
        m = state.setdefault(("m", k), torch.zeros_like(g))
        v = state.setdefault(("v", k), torch.zeros_like(g))
        m.mul_(betas[0]).add_(g, alpha=1 - betas[0])
        v.mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
        denom = (v / (1 - betas[1] ** t)).sqrt() + eps
        params[k] = params[k] - lr / (1 - betas[0] ** t) * m / denom
