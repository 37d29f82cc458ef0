"""Port parity: the Cartesian terms (``terms/cartesian.py``) and the DLS
IK (``kinematics/ik.py``) against the JAX package, float64 on the CPU.

Every term of the module -- ``cart_pose`` (constraint with tcp offsets,
a masked and toleranced variant, and a cost whose target is a params key),
``dynamic_cart_pose``, ``cart_vel``, ``cart_line``, ``ik_constraint`` and
``avoid_singularity`` (all joints, and a column subset) -- on arm7, and
one case of each function on pr2ish: rows, weights and kinds equal, the dense Jacobian (against
``jax.jacrev`` of the JAX term over the whole trajectory) and the banded
one (against its ``banded_jac``) to 1e-9, the band layout equal;
``solve_ik`` to 1e-8; a 10-step arm7 solve whose ``cart_pose`` target is
an ``(R, p)`` params entry, equal counts and x to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.kinematics.ik import solve_ik as jax_solve_ik
from trajopt_tpu.models import benchmarks as jbench
from trajopt_tpu.models import robots as jrobots
from trajopt_tpu.terms import cartesian as jcart
from trajopt_tpu_torch.kinematics.ik import solve_ik
from trajopt_tpu_torch.models import robots as trobots
from trajopt_tpu_torch.terms import cartesian as tcart

torch.set_num_threads(2)

TOL = 1e-9
N_STEPS = 4
TIMESTEP = 2
ROBOTS = {
    "arm7": (jrobots.arm7, trobots.arm7, jbench.ARM7_HOME, "tool0",
             "link_3"),
    "pr2ish": (jrobots.pr2ish, trobots.pr2ish, jbench.PR2ISH_HOME,
               "r_gripper_tool_frame", "torso_link"),
}
_RZ = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
_RX = np.array([[1.0, 0.0, 0.0], [0.0, 0.6, -0.8], [0.0, 0.8, 0.6]])


def _cases(ee, other):
    """name -> (function name, positional args after the tree, kwargs);
    ``other`` is a second moving link (the dynamic target)."""
    return {
        "pose_cnt": ("cart_pose", (ee, N_STEPS, TIMESTEP), dict(
            is_cost=False, target=(_RZ, np.array([0.4, 0.1, 0.9])),
            tcp=(_RX, np.array([0.0, 0.0, 0.05])),
            target_tcp=np.array([0.01, 0.0, 0.0]),
            coeffs=[1, 2, 3, 4, 5, 6])),
        "pose_masked_tol": ("cart_pose", (ee, N_STEPS, TIMESTEP), dict(
            is_cost=True, target=np.array([0.3, -0.2, 0.8]),
            indices=[0, 1, 2, 5], coeffs=[2.0, 2.0, 2.0, 0.5],
            upper_tolerance=np.full(6, 0.05),
            lower_tolerance=np.full(6, -0.02))),
        "pose_params_target": ("cart_pose", (ee, N_STEPS, N_STEPS - 1), dict(
            is_cost=True, target="tgt", coeffs=[1, 1, 1, 0.1, 0.1, 0.1])),
        "dynamic": ("dynamic_cart_pose", (ee, other, N_STEPS, TIMESTEP),
                    dict(is_cost=False, tcp=np.array([0.0, 0.0, 0.1]),
                         target_tcp=(_RX, np.array([0.2, 0.0, 0.3])),
                         coeffs=[3, 3, 3, 1, 1, 1])),
        "vel": ("cart_vel", (ee, N_STEPS), dict(max_displacement=0.05,
                                                first_step=1, coeffs=2.0)),
        "vel_cost": ("cart_vel", (ee, N_STEPS), dict(max_displacement=0.1,
                                                     is_cost=True)),
        "line": ("cart_line", (ee, N_STEPS, TIMESTEP), dict(
            line_start=(np.eye(3), np.array([0.3, -0.3, 0.7])),
            line_end=(_RZ, np.array([0.5, 0.3, 0.9])),
            tcp=np.array([0.0, 0.0, 0.02]), coeffs=[1, 1, 1, 2, 2, 2])),
        "ik": ("ik_constraint", (ee, N_STEPS, TIMESTEP), dict(
            target=(_RZ, np.array([0.4, 0.2, 0.8])), coeffs=2.0)),
        "ik_pos_cost": ("ik_constraint", (ee, N_STEPS, 1), dict(
            target=np.array([0.4, 0.2, 0.8]), pos_only=True, is_cost=True)),
        "singularity": ("avoid_singularity", (ee, N_STEPS), dict(
            lambda_=1e-3, coeff=2.0, first_step=1)),
        "singularity_subset": ("avoid_singularity", (ee, N_STEPS), dict(
            joints=[1, 2, 3, 4, 5], last_step=2)),
    }


# arm7 takes every variant, pr2ish one case of each function
PR2ISH_CASES = ("pose_cnt", "dynamic", "vel", "line", "ik",
                "singularity_subset")
CASES = [("arm7", case) for case in _cases("", "")] + \
    [("pr2ish", case) for case in PR2ISH_CASES]


def _x(tree, home, seed, B=3):
    rng = np.random.default_rng(seed)
    x = np.tile(home, (B, N_STEPS, 1)) \
        + 0.3 * rng.standard_normal((B, N_STEPS, tree.n_dof))
    return np.clip(x, tree.lower, tree.upper).reshape(B, -1)


@pytest.mark.parametrize("robot,case", CASES)
def test_cartesian_term_matches_jax(robot, case):
    jmake, tmake, home, ee, other = ROBOTS[robot]
    jtree, ttree = jmake(), tmake()
    fname, args, kw = _cases(ee, other)[case]
    if fname == "ik_constraint":
        kw = dict(kw, q_seed=home)
    jt = getattr(jcart, fname)(jtree, *args, **kw)
    tt = getattr(tcart, fname)(ttree, *args, **kw)
    assert (tt.kind.value, tt.n_rows, tt.band_width, tt.linear) == \
        (jt.kind.value, jt.n_rows, jt.band_width, jt.linear)
    np.testing.assert_array_equal(tt.band_starts, jt.band_starts)
    x = _x(ttree, home, 3)
    tgt = np.random.default_rng(4).uniform(-0.5, 0.5, (3, 3)) \
        + np.array([0.2, 0.0, 0.8])
    params_j = {"tgt": jnp.asarray(tgt)} if "params" in case else {}
    params_t = {"tgt": torch.as_tensor(tgt)} if "params" in case else {}

    def jax_eval(v, p):
        r = jnp.atleast_1d(jt.fn(v, p))
        J = jax.jacrev(lambda u: jnp.atleast_1d(jt.fn(u, p)))(v)
        w = jnp.broadcast_to(jnp.asarray(jt.weight_fn(p), v.dtype),
                             (jt.n_rows,))
        return r, J, jt.banded_jac(v, p), w

    r_j, J_j, W_j, w_j = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        jax_eval))(jnp.asarray(x), params_j))
    assert np.abs(r_j).max() > 1e-3                 # rows are not trivial
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(tt.fn(xt, params_t).numpy(), r_j, rtol=0,
                               atol=TOL)
    w_t = np.broadcast_to(np.asarray(tt.weight_fn(params_t), float),
                          w_j.shape)
    np.testing.assert_allclose(w_t, w_j, rtol=0, atol=TOL)
    r, J = tt.val_jac_fn(xt, params_t)
    np.testing.assert_allclose(r.numpy(), r_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(J.numpy(), J_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(tt.banded_jac(xt, params_t).numpy(), W_j,
                               rtol=0, atol=TOL)
    r, W = tt.val_banded_jac(xt, params_t)
    np.testing.assert_allclose(r.numpy(), r_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(W.numpy(), W_j, rtol=0, atol=TOL)


@pytest.mark.parametrize("robot", list(ROBOTS))
@pytest.mark.parametrize("pos_only", [False, True])
def test_solve_ik_matches_jax(robot, pos_only):
    jmake, tmake, home, ee, _ = ROBOTS[robot]
    jtree, ttree = jmake(), tmake()
    rng = np.random.default_rng(5)
    q_goal = np.clip(home + 0.4 * rng.standard_normal(ttree.n_dof),
                     ttree.lower, ttree.upper)
    R, p = jtree.fk(jnp.asarray(q_goal))
    R_t = np.array(R[jtree.link_id(ee)])
    p_t = np.array(p[jtree.link_id(ee)])
    q_j, e_j = jax.jit(lambda s: jax_solve_ik(
        jtree, ee, R_t, p_t, s, pos_only=pos_only))(jnp.asarray(home))
    seeds = np.stack([home, home + 0.05])       # a batch of two seeds
    q_t, e_t = solve_ik(ttree, ee, R_t, p_t, torch.as_tensor(seeds),
                        pos_only=pos_only)
    np.testing.assert_allclose(q_t[0].numpy(), np.asarray(q_j), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(float(e_t[0]), float(e_j), rtol=0, atol=1e-8)
    q1, e1 = solve_ik(ttree, ee, R_t, p_t, torch.as_tensor(seeds[1]),
                      pos_only=pos_only)
    np.testing.assert_allclose(q_t[1].numpy(), q1.numpy(), rtol=0,
                               atol=1e-12)
    e0 = solve_ik(ttree, ee, R_t, p_t, torch.as_tensor(home), iters=0)[1]
    assert float(e_t[0]) < 0.1 * float(e0)


def _reach_problem(pkg, n):
    """arm7, joint_vel cost and a ``cart_pose`` constraint on tool0 at the
    last step whose target is the params key ``"tgt"``."""
    if pkg == "jax":
        from trajopt_tpu.problem.trajectory import TrajOptProblem
        from trajopt_tpu.terms.joint import joint_vel
        tree, cart, kw = jrobots.arm7(), jcart, {}
    else:
        from trajopt_tpu_torch.problem.trajectory import TrajOptProblem
        from trajopt_tpu_torch.terms.joint import joint_vel
        tree, cart, kw = trobots.arm7(), tcart, {"device": "cpu"}
    prob = TrajOptProblem(n_steps=n, n_dof=7, joint_lower=tree.lower,
                          joint_upper=tree.upper, fixed_steps=[0], **kw)
    prob.add_term(joint_vel(n, 7, is_cost=True, coeffs=np.full(7, 5.0)))
    prob.add_term(cart.cart_pose(tree, "tool0", n, n - 1, is_cost=False,
                                 target="tgt"))
    return prob


def test_rotated_params_target_solve_matches_jax():
    """A ``cart_pose`` target given per lane as an ``(R, p)`` params entry
    (rotated away from the start's orientation): a 10-step arm7 solve of 3
    lanes matches the JAX package's (status and counts equal, x to
    1e-6), and the rotation is honoured (it changes the solution)."""
    from trajopt_tpu.sqp.params import SQPParams as JParams
    from trajopt_tpu_torch.sqp.params import SQPParams

    n, lanes = 10, 3
    goals = jbench.ARM7_GOAL + 0.1 * np.random.default_rng(6) \
        .standard_normal((lanes, 7))
    jtree = jrobots.arm7()
    R, p = jax.vmap(jtree.fk)(jnp.asarray(goals))
    ee = jtree.link_id("tool0")
    R_t = np.einsum("bij,jk->bik", np.asarray(R[:, ee]), _RX)
    p_t = np.array(p[:, ee])
    w = np.linspace(0.0, 1.0, n)[:, None]
    inits = jbench.ARM7_HOME * (1 - w) + goals[:, None, :] * w
    jsolve = _reach_problem("jax", n).make_solve(JParams())
    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda i, r, q: jsolve(i, {"tgt": (r, q)})))(
        jnp.asarray(inits), jnp.asarray(R_t), jnp.asarray(p_t)))
    solve = _reach_problem("torch", n).make_solve(SQPParams())
    res = solve(inits, {"tgt": (R_t, p_t)})
    assert (ref.status == 1).all()
    np.testing.assert_array_equal(res.status.numpy(), ref.status)
    np.testing.assert_array_equal(res.n_iter.numpy(), ref.n_iter)
    np.testing.assert_array_equal(res.n_qp_solves.numpy(), ref.n_qp_solves)
    np.testing.assert_allclose(res.x.numpy(), ref.x, rtol=0, atol=1e-6)
    pos_only = solve(inits, {"tgt": p_t})
    assert np.abs(pos_only.x.numpy() - res.x.numpy()).max() > 1e-2
