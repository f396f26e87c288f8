"""The numbers that decide ``correct``: what the timed path produced against
the plain reference, each a gap as a share of the reference's scale."""

import math
import statistics


def _norms(leaves):
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def worst_leaf(prog, ref, leaves, detail=None):
    """max over ``leaves`` of | |prog| - |ref| | / max(|ref leaf|, median |ref
    leaf|): the gap between the two norms, not the norm of the difference,
    against the larger of the leaf's and the median leaf's reference norm
    (some gradients are all but zero)."""
    p, r = _norms(prog), _norms(ref)
    med = statistics.median(r[k] for k in leaves)
    gaps = [abs(p[k] - r[k]) / max(r[k], med) for k in leaves]
    if detail is not None:
        detail.update(zip(leaves, gaps))
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def training(prog, ref, detail=None):
    """The first steps of a training cell: ``loss``, the largest relative gap
    of a step's loss; ``loss1``, the first step's; ``grad``, the worst leaf of the first gradient as the
    optimizer got it; ``change``, the worst leaf of the parameters' change
    after the steps. Leaves whose first reference gradient is under a
    thousandth of the median leaf's move by round-off alone under Adam and
    are left out of ``change``; leaves with no optimizer gradient (q under
    natural gradients) always count. ``detail``, where given, gets each
    step's and each leaf's gap."""
    steps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    loss = max(steps)
    if len(prog["losses"]) != len(ref["losses"]) or not math.isfinite(loss):
        loss = math.inf
    g = _norms(ref["grad1"])
    med = statistics.median(g.values())
    moved = [k for k in ref["change"] if k not in g or g[k] >= 1e-3 * med]
    d = None if detail is None else {"loss_steps": steps, "grad_leaves": {}, "change_leaves": {}}
    out = {"loss": loss, "loss1": steps[0] if steps and math.isfinite(steps[0]) else math.inf,
           "grad": worst_leaf(prog["grad1"], ref["grad1"], list(ref["grad1"]), d and d["grad_leaves"]),
           "change": worst_leaf(prog["change"], ref["change"], moved, d and d["change_leaves"])}
    if detail is not None:
        detail.update(d)
    return out


def serving(prog, ref, variance):
    """Sampled requests' answers: ``mean``, the largest gap of a predictive
    mean over the largest reference mean; ``var``, the largest gap of a
    marginal variance over the prior variance."""
    scale = max(float(r[0].abs().max()) for r in ref)
    mean = max(float((p[0] - r[0]).abs().max()) for p, r in zip(prog, ref)) / scale
    var = max(float((p[1] - r[1]).abs().max()) for p, r in zip(prog, ref)) / variance
    return {"mean": mean if math.isfinite(mean) else math.inf, "var": var if math.isfinite(var) else math.inf}
