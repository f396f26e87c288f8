"""Parity of the port's distributed CG loss (``parallel.make_distributed_cg_loss``)
and of its chains over ranks (``parallel.sample_chains`` with a mesh) with
the JAX package, on the CPU in float64, and the multi-rank dry run
(``entry.dryrun_multichip``).

Gloo worlds of 2 and 4 ranks (``tests/_torch_dist_worker.py``, no JAX;
each started once for the file, joined against a deadline) and the test
process (one rank, no process group) run:

- the distributed CG loss and its gradients on the JAX package's probes
  (its threefry draws from ``probe_keys``, put in place of
  ``ops.iterative.cg_probes``), against its ``make_distributed_cg_loss``
  over 8 virtual devices (tests/test_parallel.py's case, at
  tests/test_torch_iterative.py's CG depth: 10 iterations and 12 Lanczos
  steps, short of where CG and Lanczos amplify rounding);
- NUTS and HMC chains with shared adaptation split over the ranks: equal to
  the one-rank run draw for draw (every rank draws for all the chains), and
  the moments and shared step sizes of tests/test_parallel.py's checks;
- ``dryrun_multichip(n)``, whose asserts hold each distributed loss to its
  unsharded counterpart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpflow_slim_tpu as gfs
import gpflow_slim_tpu_torch as gft
from _torch_dist_worker import _gauss
from _torch_worlds import run_world
from gpflow_slim_tpu import parallel as jparallel
from gpflow_slim_tpu.ops import iterative as jit_
from gpflow_slim_tpu.params import parameters as jax_parameters

torch.set_num_threads(2)

WORLDS = (2, 4)
RTOL = 1e-10
CG = dict(num_probes=4, cg_iters=10, slq_steps=12)
CHAINS = {"nuts": dict(shape=(8, 1), seed=0, num_samples=500, sampler="nuts", num_warmup=300),
          "hmc": dict(shape=(8, 2), seed=2, num_samples=200, sampler="hmc", epsilon=1e-3, burn=300,
                      adapt_step_size=True)}


def _unconstrained(jm):
    return {n: np.asarray(p.unconstrained) for n, p in jax_parameters(jm)}


@pytest.fixture(scope="module")
def jax_cases():
    rng = np.random.RandomState(0)
    N, ls = 64, 0.05
    X = rng.uniform(0, 1, (N, 1))
    Y = np.sin(6 * X) + 0.1 * rng.randn(N, 1)
    jm = gfs.models.GPRCG(X, Y, kern=gfs.kernels.RBF(1, lengthscales=ls), **CG)
    loss, g = jax.jit(jax.value_and_grad(jparallel.make_distributed_cg_loss(jm, jparallel.make_mesh({"rows": 8}),
                                                                             axis="rows", **CG)))(jm)
    kl, kt = jit_.probe_keys(jm.kern, jnp.squeeze(jm.likelihood.variance.value))
    Zld = np.stack([np.asarray(jax.random.rademacher(k, (N,), dtype=jnp.float64))
                    for k in jax.random.split(kl, CG["num_probes"])], 1)
    Ztr = np.asarray(jax.random.rademacher(kt, (N, CG["num_probes"]), dtype=jnp.float64))
    cases = {"cg": {"X": X, "Y": Y, "ls": ls, "kw": CG, "unconstrained": _unconstrained(jm), "Zld": Zld, "Ztr": Ztr},
             "chains": {k: dict(v) for k, v in CHAINS.items()}}
    return cases, (float(loss), {gft.interop.port_name(k): v for k, v in _unconstrained(g).items()})


@pytest.fixture(scope="module")
def world(jax_cases, tmp_path_factory):
    done = {}

    def run(n):
        if n not in done:
            done[n] = run_world("cg_chains", n, jax_cases[0], tmp_path_factory.mktemp(f"cg{n}"))
        return done[n]

    return run


@pytest.fixture(scope="module")
def one_rank(jax_cases):
    """The cases on one rank, in the test process (no process group)."""
    import _torch_dist_worker as worker

    res = {}
    c = jax_cases[0]["cg"]
    m = gft.models.GPRCG(c["X"], c["Y"], kern=gft.kernels.RBF(1, lengthscales=c["ls"]), device="cpu", **CG)
    gft.interop.load_unconstrained(m, c["unconstrained"])
    with worker._Probes(c["Zld"], c["Ztr"]):
        loss = gft.parallel.make_distributed_cg_loss(m, gft.parallel.make_mesh({"rows": 1}), axis="rows", **CG)(m)
        worker._save_loss_and_grads(res, "cg", loss, worker._grads(loss, m))
        want = m.objective()  # GPRCG on one device, on the same probes
        res["gprcg/loss"] = want.item()
    for name, kw in CHAINS.items():
        kw = dict(kw)
        x0 = torch.zeros(kw.pop("shape"), dtype=torch.float64)
        lp = _gauss if name == "nuts" else (lambda x: torch.sum(-0.5 * torch.square(x)))
        samples, info = gft.parallel.sample_chains(lp, x0, torch.Generator().manual_seed(kw.pop("seed")), **kw)
        res[f"{name}/samples"] = samples.numpy()
        res.update({f"{name}/info/{k}": v.numpy() for k, v in info.items()})
    return res


def _cg_matches(res, jax_cases):
    jloss, jgrads = jax_cases[1]
    np.testing.assert_allclose(res["cg/loss"], jloss, rtol=RTOL)
    got = {k.split("/", 2)[2]: v for k, v in res.items() if k.startswith("cg/grad/")}
    assert got and set(got) <= set(jgrads)
    for name, g in got.items():
        np.testing.assert_allclose(g, jgrads[name], rtol=1e-8, atol=1e-10, err_msg=name)


def test_distributed_cg_on_one_rank_matches_jax_and_gprcg(one_rank, jax_cases):
    _cg_matches(one_rank, jax_cases)
    np.testing.assert_allclose(one_rank["cg/loss"], one_rank["gprcg/loss"], rtol=RTOL)


@pytest.mark.parametrize("n", WORLDS)
def test_distributed_cg_matches_jax(n, world, jax_cases):
    _cg_matches(world(n), jax_cases)


@pytest.mark.parametrize("sampler", sorted(CHAINS))
@pytest.mark.parametrize("n", WORLDS)
def test_chains_over_ranks_equal_one_rank(n, sampler, world, one_rank):
    res = world(n)
    keys = [k for k in one_rank if k.startswith(f"{sampler}/")]
    assert keys and sorted(keys) == sorted(k for k in res if k.startswith(f"{sampler}/"))
    for k in keys:
        np.testing.assert_allclose(res[k], one_rank[k], rtol=RTOL, atol=1e-12, err_msg=k)


def test_sharded_chains_match_moments(one_rank):
    # tests/test_parallel.py's moment check (the runs over 2 and 4 ranks
    # equal this one)
    s = one_rank["nuts/samples"]
    assert s.shape == (8, 500, 1)
    assert gft.mcmc.potential_scale_reduction(s)[0] < 1.05
    np.testing.assert_allclose(s.mean(), 2.0, atol=0.1)
    np.testing.assert_allclose(s.reshape(-1).var(), 0.5, rtol=0.3)
    eps = one_rank["nuts/info/step_size"]
    np.testing.assert_allclose(eps, eps[0], rtol=1e-6)  # shared adaptation: one step size


def test_hmc_chains_shared_adaptation(one_rank):
    eps = one_rank["hmc/info/epsilon"]
    np.testing.assert_allclose(eps, eps.flat[0], rtol=1e-6)
    assert eps.flat[0] > 0.01  # adapted up from 1e-3


@pytest.mark.parametrize("n", WORLDS)
def test_dryrun_multichip(n, world):
    assert "dist_gpr" in str(world(n)["dryrun"])


def test_dryrun_multichip_one_rank():
    out = gft.entry.dryrun_multichip(1, device="cpu", dtype=torch.float64)
    assert set(out) == {"dist_gpr", "dp_svgp", "dist_cg", "grid_gpr", "chains"} and out["chains"] == (1, 2, 3)
    with pytest.raises(ValueError, match="world of 2"):
        gft.entry.dryrun_multichip(2, device="cpu")
