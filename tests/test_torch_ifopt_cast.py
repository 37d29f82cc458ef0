"""Port parity: the boxbot 3-step cast problem assembled through the ifopt
facade (the JAX test ``test_ifopt_collision.py``'s end-to-end solve),
against the JAX package, float64 on the CPU.

* at the JAX test's init, where the box faces tie, the collision rows and
  Jacobians equal the JAX package's run op by op;
* the solve from a middle node off that tie: equal status and counts, x
  within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_ifopt_collision import PKGS, _boxbot_scene

torch.set_num_threads(2)

# The cast solve's initial middle node, off the obstacle's center.
MID = (0.1, 0.05)


def _cast_problem(pkg, mid=(0.0, 0.0)):
    """The JAX test's box_cast scenario through the facade: a 3-step
    NodesVariables trajectory, a joint-velocity squared cost, per-gap
    continuous collision constraints (LVS 3) and pinned endpoints."""
    ifo = PKGS[pkg][0]
    K = jnp.asarray if pkg == "jax" else (
        lambda v: torch.tensor(v, dtype=torch.float64))
    cat = jnp.concatenate if pkg == "jax" else torch.cat
    scene = _boxbot_scene(pkg, [[0.0, 0.0, 0.0]])
    n_steps = 3
    init = np.array([[-1.9, 0.0], list(mid), [1.9, 0.0]])
    prob = ifo.Problem()
    nodes = []
    for t in range(n_steps):
        nd = ifo.Node(f"step{t}")
        nd.add_var("position", 2)
        nodes.append(nd)
    nv = prob.add_variable_set(ifo.NodesVariables(
        "trajectory", nodes, init.reshape(-1), lower=-10.0, upper=10.0))

    def steps(v):
        return v["trajectory"].reshape(n_steps, 2)

    vel = ifo.FunctionalConstraint(
        2 * (n_steps - 1), "joint_vel",
        lambda v: (steps(v)[1:] - steps(v)[:-1]).reshape(-1))
    prob.add_cost_set(ifo.SquaredCost(vel, weights=5.0))
    for t in range(n_steps - 1):
        prob.add_constraint_set(ifo.ContinuousCollisionConstraint(
            scene, nv.node_var(t, "position"), nv.node_var(t + 1, "position"),
            margin=0.05, coeff=20.0, lvs_substeps=3, max_num_cnt=None,
            name=f"collision{t}"))
    prob.add_constraint_set(ifo.FunctionalConstraint(
        4, "endpoints",
        lambda v: cat([steps(v)[0] - K([-1.9, 0.0]),
                       steps(v)[-1] - K([1.9, 0.0])])))
    return prob


def test_cast_tie_jacobian_matches_jax_op_by_op():
    """At the JAX test's init the middle node sits at the obstacle's
    center, where the box faces tie for the deepest penetration.  The
    port's rows and Jacobians there equal the JAX package's run op by op;
    under ``jax.jit`` XLA fuses multiply-adds and the tie breaks toward
    another face (the solve below starts off the tie for that reason)."""
    jn, tn = _cast_problem("jax").build(), _cast_problem("torch").build()
    x = np.array([-1.9, 0.0, 0.0, 0.0, 1.9, 0.0])
    xt = torch.as_tensor(x)[None]
    # the first gap's set: its sweep ends at the center
    for tj, t in zip(jn.term_sets[1:2], tn.term_sets[1:2]):
        assert t.name == "collision0/ub"
        np.testing.assert_allclose(
            t.fn(xt, {})[0].numpy(), np.asarray(tj.fn(jnp.asarray(x), {})),
            rtol=0, atol=1e-12, err_msg=t.name)
        np.testing.assert_allclose(
            t.jac_fn(xt, {})[0].numpy(),
            np.asarray(tj.jac_fn(jnp.asarray(x), {})), rtol=0, atol=1e-12,
            err_msg=t.name)


def test_facade_cast_solve_matches_jax():
    """The JAX test's end-to-end solve, from a middle node off the exact
    tie (see above) and off the mirror symmetry about x = 0."""
    jres, jvals = _cast_problem("jax", MID).solve()
    tres, tvals = _cast_problem("torch", MID).solve(device="cpu")
    fields = ("status", "n_iter", "n_qp_solves", "n_func_evals")
    assert [int(getattr(tres, f)) for f in fields] == \
        [int(getattr(jres, f)) for f in fields]
    assert int(tres.status) == 1
    np.testing.assert_allclose(tvals["trajectory"],
                               np.asarray(jvals["trajectory"]), rtol=0,
                               atol=1e-6)
    traj = tvals["trajectory"].reshape(3, 2)
    np.testing.assert_allclose(traj[0], [-1.9, 0.0], atol=1e-6)
    np.testing.assert_allclose(traj[2], [1.9, 0.0], atol=1e-6)
