"""Port parity for the flagship's hard mix: the borderline goals
(``hard_frac``), the multi-start restart family and a borderline-goal
solve that escalates its penalties, against the JAX package in float64 on
the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.models import benchmarks as jbench
from trajopt_tpu.qp.admm import ADMMConfig as JaxADMMConfig
from trajopt_tpu.sqp.params import SQPParams as JaxSQPParams
from trajopt_tpu_torch import interop
from trajopt_tpu_torch.models import benchmarks as tbench
from trajopt_tpu_torch.models.robots import pr2ish_scene
from trajopt_tpu_torch.sqp.params import SQPStatus

torch.set_num_threads(2)

N_STEPS, LANES = 10, 3
# Seed 7 of the all-borderline batch: lane 0 runs out of merit increases
# twice (its coefficients escalate from 10, it restarts in place at 100,
# and they escalate again to 1e7) and ends at PENALTY_ITERATION_LIMIT after
# 16 SQP iterations; lanes 1 and 2 converge.
SEED = 7

# __graft_entry__._solver_params("cast"): the flagship's settings
JAX_PARAMS = dataclasses.replace(
    JaxSQPParams(), max_restarts=1,
    qp=JaxADMMConfig(eps_abs=2e-5, eps_rel=2e-5, max_iter=450,
                     check_every=150, adaptive_rho=False, rho_dual_scale=0.1,
                     ruiz_iters=10, ns_refresh=True, ns_tol=1e-4,
                     ns_power_iters=4))


def test_hard_mix_goals_feasible_and_distinct():
    """``hard_frac`` routes the first lanes to the borderline goals
    (``tests/test_pr2ish_flagship.py``'s hard-mix goal test): the goals
    stay collision-free, the hard lanes sit near the borderline cluster
    and far from the standard mode, and the standard lanes keep exactly
    the goals ``hard_frac=0`` gives for the same seed."""
    np.testing.assert_array_equal(tbench.PR2ISH_GOAL_HARD,
                                  jbench.PR2ISH_GOAL_HARD)
    np.testing.assert_array_equal(tbench.PR2ISH_GOALS_BORDERLINE,
                                  jbench.PR2ISH_GOALS_BORDERLINE)
    scene = pr2ish_scene()
    _, goals = tbench.pr2ish_table_batch(0, 32, 5, device="cpu",
                                         hard_frac=0.25)
    d = scene.distances(scene.tree.fk(goals))
    assert float(d.min()) >= 0.02
    g = goals.numpy()
    base = tbench.PR2ISH_GOALS_BORDERLINE[np.arange(8) % 3]
    assert np.abs(g[:8] - base).max() < 0.5
    assert np.abs(g[:8] - tbench.PR2ISH_GOAL).max() > 0.5
    assert np.abs(g[:8] - base).max() > 0.0          # the noise is there
    _, goals0 = tbench.pr2ish_table_batch(0, 32, 5, device="cpu")
    np.testing.assert_array_equal(g[8:], goals0.numpy()[8:])
    # the hard noise is its own stream: other seeds, other hard goals
    _, goals1 = tbench.pr2ish_table_batch(1, 32, 5, device="cpu",
                                          hard_frac=0.25)
    assert not np.array_equal(goals1.numpy()[:8], g[:8])


@pytest.mark.parametrize("rows", [1, 2, 3])
def test_restart_family_matches_jax(rows):
    """home -> via -> goal rows, split at n_steps // 2; ``rows=3`` is cut
    to the two vias, as in JAX."""
    goals = tbench.pr2ish_goals(3, 4, hard_frac=0.5)
    for n_steps in (10, 7):
        ref = np.asarray(jbench.pr2ish_restart_family(
            jnp.asarray(goals), n_steps, dtype=jnp.float64, rows=rows))
        got = tbench.pr2ish_restart_family(torch.as_tensor(goals), n_steps,
                                           rows=rows)
        assert got.shape == (4, min(rows, 2), n_steps, 8)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)


def test_borderline_solve_matches_jax():
    """The flagship settings on three borderline lanes (10 steps, block
    QP): the JAX reference escalates lane 0's merit coefficients and
    restarts it; the port takes the same path (equal status and counts,
    equal merit coefficients) to x within 1e-6 (measured 2.2e-13)."""
    goals = tbench.pr2ish_goals(SEED, LANES, hard_frac=1.0)
    w = np.linspace(0.0, 1.0, N_STEPS)[:, None]
    inits = tbench.PR2ISH_HOME * (1 - w) + goals[:, None, :] * w

    jprob, _ = jbench.pr2ish_table_problem(n_steps=N_STEPS, lvs_substeps=2)
    jsolve = jprob.make_solve(JAX_PARAMS, structured=True)
    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda i, g: jsolve(i, {"goal": g})))(jnp.asarray(inits),
                                               jnp.asarray(goals)))
    init_coeff = JAX_PARAMS.initial_merit_error_coeff
    assert ref.merit_coeffs.max() > init_coeff          # escalated
    assert ref.status[0] == SQPStatus.PENALTY_ITERATION_LIMIT
    assert (ref.status[1:] == SQPStatus.CONVERGED).all()

    prob, _ = tbench.pr2ish_table_problem(n_steps=N_STEPS, lvs_substeps=2,
                                          device="cpu")
    params = interop.sqp_params_from_dict(dataclasses.asdict(JAX_PARAMS))
    res = prob.make_solve(params, structured=True)(inits, {"goal": goals})
    np.testing.assert_array_equal(res.status.numpy(), ref.status)
    np.testing.assert_array_equal(res.n_iter.numpy(), ref.n_iter)
    np.testing.assert_array_equal(res.n_qp_solves.numpy(), ref.n_qp_solves)
    np.testing.assert_array_equal(res.n_func_evals.numpy(),
                                  ref.n_func_evals)
    np.testing.assert_allclose(res.merit_coeffs.numpy(), ref.merit_coeffs,
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(res.x.numpy(), ref.x, rtol=0, atol=1e-6)
