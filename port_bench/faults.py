"""Faults planted in the program, to see ``correct`` come out false: each a
context manager that patches the program's timed path and undoes it on
exit. Used by the harness's own tests and by ``calibrate.py``."""

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield old
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def unchanged():
    """A step that returns its state unchanged: Adam computes its update
    and its state, and the parameters are put back; natgrad leaves q."""
    from gpflow_slim_tpu_torch.training import natgrad

    step = torch.optim.Adam.step

    def adam_step(self, *args, **kwargs):
        with torch.no_grad():
            saved = [p.detach().clone() for g in self.param_groups for p in g["params"]]
            out = step(self, *args, **kwargs)
            for p, s in zip((p for g in self.param_groups for p in g["params"]), saved):
                p.copy_(s)
        return out

    with _patched(torch.optim.Adam, "step", adam_step), \
            _patched(natgrad, "natgrad_step", lambda model, loss_fn, gamma: model):
        yield


@contextlib.contextmanager
def half_batch():
    """Half of the batch left out, the mean taken over the rest: the SVGP's
    batch ELBO over the first half of its rows (its N / B scale follows the
    rows it gets); the GPR's log likelihood over the first half of its
    points, doubled."""
    from gpflow_slim_tpu_torch.models import gpr, svgp

    def svgp_batch(self, Xb, Yb):
        return old_svgp(self, Xb[: len(Xb) // 2], Yb[: len(Yb) // 2])

    def gpr_likelihood(self):
        X, Y = self.X, self.Y
        self.X, self.Y = X[: len(X) // 2], Y[: len(Y) // 2]
        try:
            return 2 * old_gpr(self)
        finally:
            self.X, self.Y = X, Y

    with _patched(svgp.SVGP, "build_likelihood_batch", svgp_batch) as old_svgp, \
            _patched(gpr.GPR, "build_likelihood", gpr_likelihood) as old_gpr:
        yield


@contextlib.contextmanager
def altered(delta=0.1):
    """An answer altered where it is produced: each request's first
    predictive mean moved by ``delta``."""
    from gpflow_slim_tpu_torch.models import posterior

    def predict_f(self, Xnew, full_cov=False):
        mean, var = old(self, Xnew, full_cov)
        mean = mean.clone()
        mean[0] += delta
        return mean, var

    with _patched(posterior.GPRPosterior, "predict_f", predict_f) as old:
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}
