"""Port parity: the time-parameterized terms (``terms/time.py``:
``joint_vel_time``, ``joint_acc_time``, ``total_time``) against the JAX
package, float64 on the CPU.

* each term's rows to 1e-12 and its Jacobian (the JAX package's
  ``jax.jacrev`` against the port's per-lane ``torch.func.jacrev``) to
  1e-9, as cost and constraint, with and without tolerance bands, on
  seeded trajectories with a 1/dt column;
* a 10-step ``use_time`` arm7 solve (total-time cost, banded velocity
  limits, goal pose): equal status and counts, x to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.models import benchmarks as jbench
from trajopt_tpu.problem import trajectory as jtraj
from trajopt_tpu.terms import joint as jjoint
from trajopt_tpu.terms import time as jtime
from trajopt_tpu_torch.interop import sqp_params_from_dict
from trajopt_tpu_torch.models import robots as trobots
from trajopt_tpu_torch.problem import trajectory as ttraj
from trajopt_tpu_torch.sqp import nlp as tnlp
from trajopt_tpu_torch.terms import joint as tjoint
from trajopt_tpu_torch.terms import time as ttime

torch.set_num_threads(2)

N_STEPS, N_DOF = 6, 3
VAL_TOL, JAC_TOL = 1e-12, 1e-9

TERMS = {
    "vel_cost_sq": ("joint_vel_time", dict(is_cost=True,
                                           coeffs=[1.0, 2.0, 3.0])),
    "vel_cost_band": ("joint_vel_time", dict(
        is_cost=True, targets=[0.1, 0.0, -0.1], upper_tols=[0.5] * 3,
        lower_tols=[-0.4] * 3, first_step=1)),
    "vel_cnt_eq": ("joint_vel_time", dict(is_cost=False, coeffs=2.0,
                                          last_step=4)),
    "vel_cnt_band": ("joint_vel_time", dict(
        is_cost=False, upper_tols=[2.0] * 3, lower_tols=[-2.0] * 3)),
    "acc_cost": ("joint_acc_time", dict(is_cost=True, coeffs=[1.0, 0.5, 2.0],
                                        limit=0.2)),
    "acc_cnt": ("joint_acc_time", dict(is_cost=False, first_step=1)),
    "total_cost_sq": ("total_time", dict(is_cost=True, coeff=5.0)),
    "total_cost_hinge": ("total_time", dict(is_cost=True, coeff=2.0,
                                            limit=3.0)),
    "total_cnt": ("total_time", dict(is_cost=False, coeff=1.5, limit=2.0)),
}


def _trajectories(seed, B=3):
    """[B, N_STEPS * (N_DOF + 1)]: joints and an inverse-dt column in
    [0.5, 2]."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, N_STEPS, N_DOF))
    inv_dt = rng.uniform(0.5, 2.0, (B, N_STEPS, 1))
    return np.concatenate([q, inv_dt], -1).reshape(B, -1)


@pytest.mark.parametrize("case", list(TERMS))
def test_time_term_matches_jax(case):
    fname, kw = TERMS[case]
    jt = getattr(jtime, fname)(N_STEPS, N_DOF, **kw)
    tt = getattr(ttime, fname)(N_STEPS, N_DOF, **kw)
    assert (tt.kind.value, tt.n_rows) == (jt.kind.value, jt.n_rows)
    x = _trajectories(1)
    r_j, J_j, w_j = jax.tree.map(np.asarray, jax.vmap(
        lambda v: (jnp.atleast_1d(jt.fn(v, {})),
                   jax.jacrev(lambda u: jnp.atleast_1d(jt.fn(u, {})))(v),
                   jnp.broadcast_to(jt.weight_fn({}), (jt.n_rows,))))(
        jnp.asarray(x)))
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(tt.fn(xt, {}).numpy(), r_j, rtol=0,
                               atol=VAL_TOL)
    np.testing.assert_allclose(tnlp._lane_jacrev(tt, xt, {}).numpy(), J_j,
                               rtol=0, atol=JAC_TOL)
    np.testing.assert_allclose(tnlp._weights(tt, {}, xt).numpy(), w_j,
                               rtol=0, atol=VAL_TOL)


def _time_problem(mod_traj, mod_joint, mod_time, tree, n_steps, **dev):
    """arm7 with a 1/dt column: total-time cost, |vel| <= 1.5 per dof,
    goal joint pose at the last step (params key 'goal'), start pinned."""
    prob = mod_traj.TrajOptProblem(
        n_steps=n_steps, n_dof=7, joint_lower=tree.lower,
        joint_upper=tree.upper, use_time=True, dt_lower=0.2, dt_upper=5.0,
        fixed_steps=[0], **dev)
    prob.add_term(mod_time.total_time(n_steps, 7, is_cost=True, coeff=2.0))
    prob.add_term(mod_time.joint_vel_time(
        n_steps, 7, is_cost=False, upper_tols=np.full(7, 1.5),
        lower_tols=np.full(7, -1.5)))
    prob.add_term(mod_joint.joint_pos(
        n_steps, 7, is_cost=False, targets="goal", first_step=n_steps - 1,
        last_step=n_steps - 1, n_dof_total=8))
    return prob


def test_use_time_solve_matches_jax():
    from trajopt_tpu.models import robots as jrobots
    n_steps = 10
    goal = jbench.ARM7_GOAL
    jprob = _time_problem(jtraj, jjoint, jtime, jrobots.arm7(), n_steps)
    tprob = _time_problem(ttraj, tjoint, ttime, trobots.arm7(), n_steps,
                          device="cpu")
    init = np.array(jtraj.interpolated_init(
        jnp.asarray(jbench.ARM7_HOME), jnp.asarray(goal), n_steps, dt=1.0))
    from trajopt_tpu.sqp.params import SQPParams as JaxSQPParams
    jsqp = JaxSQPParams()
    jres = jax.jit(jprob.make_solve(jsqp))(jnp.asarray(init),
                                          {"goal": jnp.asarray(goal)})
    tres = tprob.make_solve(sqp_params_from_dict(
        dataclasses.asdict(jsqp)))(init[None], {"goal": goal[None]})
    assert int(jres.status) == 1
    for f in ("status", "n_iter", "n_qp_solves", "n_func_evals"):
        assert int(getattr(tres, f)[0]) == int(getattr(jres, f)), f
    np.testing.assert_allclose(tres.x[0].numpy(), np.asarray(jres.x),
                               rtol=0, atol=1e-6)
    # the time column moved: the total-time cost shortened the motion
    assert float(tres.x[0].reshape(n_steps, 8)[1:, 7].min()) > 1.0
