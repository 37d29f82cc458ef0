"""Port parity: forward kinematics and the SO(3)/SE(3) helpers of
``trajopt_tpu_torch`` against the JAX package (pr2ish tree), float64 on
the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from trajopt_tpu.kinematics import transforms as jtf
from trajopt_tpu.models.robots import pr2ish as jax_pr2ish
from trajopt_tpu_torch.kinematics import transforms as ttf
from trajopt_tpu_torch.models.robots import pr2ish

torch.set_num_threads(2)

TOL = 1e-12  # same scalar-form arithmetic in float64


def _configs(n=16, seed=0):
    tree = pr2ish()
    rng = np.random.default_rng(seed)
    return rng.uniform(tree.lower, tree.upper, (n, tree.n_dof))


def test_fk_matches_jax():
    q = _configs()
    R_j, p_j = jax.vmap(jax_pr2ish().fk)(jnp.asarray(q))
    R_t, p_t = pr2ish().fk(torch.as_tensor(q))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0,
                               atol=TOL)


def test_fk_with_axes_matches_jax():
    q = _configs(seed=1)
    out_j = jax.vmap(jax_pr2ish().fk_with_axes)(jnp.asarray(q))
    out_t = pr2ish().fk_with_axes(torch.as_tensor(q))
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL)


def test_fk_takes_any_leading_shape():
    q = _configs(12, seed=2)
    R, p = pr2ish().fk(torch.as_tensor(q).reshape(3, 4, -1))
    R1, p1 = pr2ish().fk(torch.as_tensor(q))
    assert torch.equal(R.reshape(R1.shape), R1)
    assert torch.equal(p.reshape(p1.shape), p1)


def test_transforms_match_jax():
    rng = np.random.default_rng(4)
    rpy = rng.uniform(-np.pi, np.pi, (12, 3))
    R = jax.vmap(jtf.rpy_matrix)(jnp.asarray(rpy))
    np.testing.assert_allclose(ttf.rpy_matrix(torch.as_tensor(rpy)).numpy(),
                               np.asarray(R), rtol=0, atol=TOL)
    axis = rng.standard_normal((12, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    # angles near 0, generic, and near pi (the log's special branches)
    ang = np.concatenate([[0.0, 1e-7, np.pi - 1e-6, np.pi],
                          rng.uniform(-3, 3, 8)])
    Ra = jax.vmap(jtf.axis_angle_matrix)(jnp.asarray(axis),
                                         jnp.asarray(ang))
    Ra_t = ttf.axis_angle_matrix(torch.as_tensor(axis), torch.as_tensor(ang))
    np.testing.assert_allclose(Ra_t.numpy(), np.asarray(Ra), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(ttf.rotvec_from_matrix(Ra_t).numpy(),
                               np.asarray(jax.vmap(jtf.rotvec_from_matrix)(Ra)),
                               rtol=0, atol=1e-9)
    p0, p1 = rng.standard_normal((2, 12, 3))
    err = jax.vmap(jtf.transform_error)(R, jnp.asarray(p0), Ra,
                                        jnp.asarray(p1))
    err_t = ttf.transform_error(torch.tensor(np.asarray(R)),
                                torch.as_tensor(p0), Ra_t,
                                torch.as_tensor(p1))
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err), rtol=0,
                               atol=1e-9)
    lo, hi = -0.1 * np.ones(6), 0.2 * np.ones(6)
    np.testing.assert_array_equal(
        ttf.apply_tolerances(err_t, torch.as_tensor(lo),
                             torch.as_tensor(hi)).numpy(),
        np.asarray(jtf.apply_tolerances(jnp.asarray(err_t.numpy()),
                                        jnp.asarray(lo), jnp.asarray(hi))))


def test_jacobian_matches_jax():
    q = _configs(4, seed=3)
    tree_j, tree_t = jax_pr2ish(), pr2ish()
    link = "r_gripper_link"
    J_j = jax.vmap(lambda v: tree_j.jacobian(v, link))(jnp.asarray(q))
    J_t = tree_t.jacobian(torch.as_tensor(q), link)
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), rtol=0,
                               atol=TOL)
