"""Port parity for the interior-point QP (``qp/ipm.py``) and the SQP
driver's IPM branch (``qp_algorithm="ipm"``), against the JAX package in
float64 on the CPU.

The QPs are those of ``tests/test_qp_ipm.py`` -- random strictly convex
QPs with hard inequality, hard equality and finite-penalty rows; a set
with more hard equalities; a soft-row-only set with tightened intervals --
drawn from numpy seeds, several lanes a batch.  The port runs the same
Newton steps; the reduced systems of lanes with hard equalities have
condition numbers ~1e12 (big-M), so their x moves by up to ~2e-4 along
near-degenerate directions under any change of rounding (measured here;
the JAX package's own test of ``vmap`` against single solves allows 1e-3
in x and 1e-6 in the objective for the same reason), while the objective
agrees to ~1e-8; soft-only lanes agree to ~1e-12.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.models import benchmarks as jbench
from trajopt_tpu.qp.admm import QPData as JaxQPData
from trajopt_tpu.qp.ipm import solve_qp_ipm as jax_solve_qp_ipm
from trajopt_tpu_torch.models import benchmarks as tbench
from trajopt_tpu_torch.qp.admm import QPData
from trajopt_tpu_torch.qp.ipm import IPMConfig, solve_qp_ipm
from trajopt_tpu_torch.sqp.params import SQPStatus

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
# (n_eq hard equalities, n_soft penalty rows, interval scale, x tolerance
# of converged lanes, objective tolerance (relative))
QPS = {"random": (2, 6, 1.0, 1e-3, 1e-6),
       "hard_rows": (3, 4, 1.0, 1e-3, 1e-6),
       "soft_rows": (0, 10, 0.05, 1e-9, 1e-12)}


def _random_qps(seed, B, n_eq, n_soft, shrink, n=12, m=18):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    P = G @ G.transpose(0, 2, 1) + 0.5 * np.eye(n)
    q = rng.standard_normal((B, n))
    A = rng.standard_normal((B, m, n))
    center = rng.standard_normal((B, m)) * 0.3
    half = 0.2 + rng.uniform(size=(B, m))
    l, u = center - half, center + half
    l[:, :n_eq] = center[:, :n_eq]
    u[:, :n_eq] = center[:, :n_eq]
    c = np.full((B, m), np.inf)
    c[:, n_eq:n_eq + n_soft] = 5.0
    return P, q, A, l * shrink, u * shrink, c


def _objective(qp, x):
    P, q, A, l, u, c = qp
    z = np.einsum("bmn,bn->bm", A, x)
    viol = np.maximum(z - u, 0) + np.maximum(l - z, 0)
    soft = np.where(np.isinf(c), 0.0, c) * viol
    return (0.5 * np.einsum("bn,bnk,bk->b", x, P, x) + (q * x).sum(-1)
            + soft.sum(-1))


@pytest.fixture(scope="module")
def jax_ipm():
    return jax.jit(jax.vmap(lambda *a: jax_solve_qp_ipm(
        JaxQPData(*a), jnp.zeros(a[0].shape[0]))))


@pytest.mark.parametrize("kind", sorted(QPS))
def test_ipm_matches_jax(jax_ipm, kind):
    n_eq, n_soft, shrink, xtol, ftol = QPS[kind]
    qp = _random_qps(sorted(QPS).index(kind), 8, n_eq, n_soft, shrink)
    ref = jax.tree.map(np.asarray, jax_ipm(*map(jnp.asarray, qp)))
    got = solve_qp_ipm(QPData(*map(torch.as_tensor, qp)))
    assert ref.converged.sum() >= 6                    # the IPM converged
    np.testing.assert_array_equal(got.iters.numpy(), ref.iters)
    np.testing.assert_array_equal(got.converged.numpy(), ref.converged)
    ok = ref.converged
    np.testing.assert_allclose(got.x.numpy()[ok], ref.x[ok], rtol=0,
                               atol=xtol)
    f_ref, f_got = _objective(qp, ref.x), _objective(qp, got.x.numpy())
    np.testing.assert_allclose(f_got[ok], f_ref[ok], rtol=ftol, atol=0)
    np.testing.assert_allclose(got.z.numpy(),
                               np.einsum("bmn,bn->bm", qp[2],
                                         got.x.numpy()), rtol=0, atol=1e-12)
    hard = np.isinf(qp[5])
    z = got.z.numpy()
    viol = np.maximum(z - qp[4], 0) + np.maximum(qp[3] - z, 0)
    assert viol[ok][hard[ok]].max() < 1e-6           # big-M rows exact
    if kind == "soft_rows":
        # a soft row's dual never exceeds its weight
        y = got.y.numpy()
        assert (np.abs(y[~hard]) <= qp[5][~hard] + 1e-6).all()


def test_converged_lanes_freeze():
    """Lanes converge at different steps, and a converged lane does not
    move while its neighbours step on: its result is bit-identical to a
    batch of the same size in which every lane stops with it."""
    qp = _random_qps(0, 8, *QPS["random"][:3])
    got = solve_qp_ipm(QPData(*map(torch.as_tensor, qp)))
    iters = got.iters.numpy()
    early = int(np.argmin(iters))
    late = int(np.argmax(iters))
    assert iters[early] < iters[late]
    pick = np.array([early, late])
    pair = solve_qp_ipm(QPData(*(torch.as_tensor(a[pick]) for a in qp)))
    same = solve_qp_ipm(QPData(*(torch.as_tensor(a[[early, early]])
                                 for a in qp)))
    assert int(pair.iters[0]) == int(same.iters[0]) == iters[early]
    assert int(pair.iters[1]) > int(pair.iters[0])
    for a, b in zip(pair, same):
        assert torch.equal(a[0], b[0])


def test_failed_step_ends_the_lane():
    """A lane whose reduced system is not positive definite (P with a
    large negative eigenvalue) keeps its start and reports max_iter and
    not converged; the other lanes solve as alone."""
    qp = [a.copy() for a in _random_qps(2, 3, *QPS["soft_rows"][:3])]
    qp[0][1] = -1e3 * np.eye(qp[0].shape[-1])
    got = solve_qp_ipm(QPData(*map(torch.as_tensor, qp)),
                       cfg=IPMConfig(max_iter=30))
    assert int(got.iters[1]) == 30 and not bool(got.converged[1])
    assert torch.isfinite(got.x[1]).all()
    assert bool(got.converged[0]) and bool(got.converged[2])


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_arm7_ipm_solve_matches_jax():
    """The arm7 discrete workload (10 steps, 3 lanes, discrete settings)
    with ``qp_algorithm="ipm"`` on the dense path: the JAX reference
    converges every lane through the IPM; the port takes the same path
    (equal status and counts) to x within 1e-6 (measured 3.5e-13)."""
    jparams = dataclasses.replace(
        _load("__graft_entry__")._solver_params("discrete"),
        qp_algorithm="ipm")
    tparams = dataclasses.replace(_load("chip_smoke").discrete_params(),
                                  qp_algorithm="ipm")
    goals = tbench.arm7_goals(1, 3)
    w = np.linspace(0.0, 1.0, 10)[:, None]
    inits = tbench.ARM7_HOME * (1 - w) + goals[:, None, :] * w
    jprob, _ = jbench.arm_table_problem(n_steps=10)
    jsolve = jprob.make_solve(jparams)
    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda i, g: jsolve(i, {"goal": g})))(jnp.asarray(inits),
                                               jnp.asarray(goals)))
    assert (ref.status == SQPStatus.CONVERGED).all()
    prob, _ = tbench.arm_table_problem(n_steps=10, device="cpu")
    res = prob.make_solve(tparams)(inits, {"goal": goals})
    np.testing.assert_array_equal(res.status.numpy(), ref.status)
    np.testing.assert_array_equal(res.n_iter.numpy(), ref.n_iter)
    np.testing.assert_array_equal(res.n_qp_solves.numpy(), ref.n_qp_solves)
    np.testing.assert_array_equal(res.n_func_evals.numpy(),
                                  ref.n_func_evals)
    np.testing.assert_allclose(res.x.numpy(), ref.x, rtol=0, atol=1e-6)


def test_float32_ipm_matches_jax_float32():
    """The float32 IPM (the solver's float32 settings, ``ipm_config``) on
    the arm7 path's first QP (10 steps, 8 lanes, float32 inputs) against
    the JAX package's float32 IPM with the same settings: the same
    converged lanes, and x of the converged lanes within 1e-3 of JAX's
    (both stop at a complementarity gap of ~1e-5 to 1e-4, so float32 x is
    determined to ~1e-4 of its magnitude here; measured 1.2e-4), and no
    more than 4x JAX's own distance to the float64 IPM from it.  At the
    full shape (30 steps, 128 lanes) the two converge 117 and 116 lanes of
    128 on the CPU, 8 unconverged lanes in common: the float32 IPM's
    shortfall is the reference's own."""
    from trajopt_tpu.qp.ipm import IPMConfig as JaxIPMConfig
    from trajopt_tpu_torch.sqp.solver import ipm_config
    cs = _load("chip_smoke")
    qp, x0 = cs.arm7_first_qp(10, 8, 0, torch.device("cpu"))
    qp32, x32 = [t.float() for t in qp], x0.float()
    eps = cs.discrete_params().qp.eps_abs
    got = solve_qp_ipm(QPData(*qp32), x32, cfg=ipm_config(torch.float32, eps))
    jcfg = JaxIPMConfig(eps=max(1e-5, eps), eps_res=1e-3, reg=1e-7)
    assert ipm_config(torch.float32, eps) == IPMConfig(
        **dataclasses.asdict(jcfg))
    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda *a: jax_solve_qp_ipm(JaxQPData(*a[:-1]), a[-1], cfg=jcfg)))(
        *(jnp.asarray(t.numpy()) for t in (*qp32, x32))))
    assert ref.x.dtype == np.float32
    r64 = solve_qp_ipm(QPData(*(t.double() for t in qp32)), x32.double(),
                       cfg=ipm_config(torch.float64, eps))
    np.testing.assert_array_equal(got.converged.numpy(), ref.converged)
    ok = ref.converged
    assert ok.sum() == 8
    x_t, x_j = got.x.double().numpy()[ok], ref.x.astype(float)[ok]
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-3)
    x64 = r64.x.numpy()[ok]
    assert np.abs(x_t - x64).max() <= 4 * np.abs(x_j - x64).max()
