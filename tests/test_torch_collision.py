"""Port parity: the swept (cast) narrowphase of ``trajopt_tpu_torch`` and
its joint-space Jacobians against the JAX package on the pr2ish scene,
float64 on the CPU, including penetrating gaps and q0 == q1 (ties of the
endpoint minimum, whose subgradient both packages split evenly); and every
primitive distance with its gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.collision import geometry as jgeom
from trajopt_tpu.kinematics import transforms as jtf
from trajopt_tpu.models.benchmarks import PR2ISH_GOAL, PR2ISH_HOME
from trajopt_tpu.models.robots import pr2ish_scene as jax_pr2ish_scene
from trajopt_tpu_torch.collision import geometry as tgeom
from trajopt_tpu_torch.models.robots import pr2ish_scene

torch.set_num_threads(2)

TOL = 1e-9


def _gaps():
    """(q0, q1) pairs [G, 8]: gaps of the straight-line home -> goal init
    (the wrist sweeps through the table: penetrating), random gaps, and
    gaps with q0 == q1."""
    rng = np.random.default_rng(0)
    w = np.linspace(0.0, 1.0, 10)[:, None]
    line = PR2ISH_HOME * (1 - w) + PR2ISH_GOAL * w
    tree = pr2ish_scene().tree
    rand0 = rng.uniform(tree.lower, tree.upper, (4, 8))
    rand1 = np.clip(rand0 + 0.3 * rng.standard_normal((4, 8)), tree.lower,
                    tree.upper)
    # q0 == q1 at every waypoint midpoint of the line (some inside the
    # table: degenerate swept segments in the penetration branch)
    same = np.concatenate([0.5 * (line[:-1] + line[1:]), rand0[:1]])
    q0 = np.concatenate([line[:-1], rand0, same])
    q1 = np.concatenate([line[1:], rand1, same])
    return q0, q1


@pytest.fixture(scope="module")
def jax_reference():
    scene = jax_pr2ish_scene()
    q0, q1 = _gaps()
    d = jax.jit(jax.vmap(scene.swept_distances))(jnp.asarray(q0),
                                                 jnp.asarray(q1))
    dj, J0, J1 = jax.jit(jax.vmap(scene.swept_distances_and_jac))(
        jnp.asarray(q0), jnp.asarray(q1))
    return tuple(np.asarray(v) for v in (d, dj, J0, J1))


def test_gaps_cover_penetration(jax_reference):
    d = jax_reference[0]
    assert d.min() < -0.01       # real penetration in the swept set
    assert d.shape == (23, 91)
    assert d[13:22].min() < 0.0    # a penetrating q0 == q1 gap


def test_swept_distances_match_jax(jax_reference):
    scene = pr2ish_scene()
    q0, q1 = (torch.as_tensor(v) for v in _gaps())
    d = scene.swept_distances(scene.tree.fk(q0), scene.tree.fk(q1))
    np.testing.assert_allclose(d.numpy(), jax_reference[0], rtol=0,
                               atol=TOL)


def test_swept_distances_and_jac_match_jax(jax_reference):
    scene = pr2ish_scene()
    q0, q1 = (torch.as_tensor(v) for v in _gaps())
    d, J0, J1 = scene.swept_distances_and_jac(scene.tree.fk_with_axes(q0),
                                              scene.tree.fk_with_axes(q1))
    _, dj, J0j, J1j = jax_reference
    np.testing.assert_allclose(d.numpy(), dj, rtol=0, atol=TOL)
    np.testing.assert_allclose(J0.numpy(), J0j, rtol=0, atol=TOL)
    np.testing.assert_allclose(J1.numpy(), J1j, rtol=0, atol=TOL)


def _primitive_inputs(name, n=48, seed=0):
    """Random operands (numpy) for one primitive; many overlap, and the
    first rows hold degenerate cases (parallel segments, a segment through
    a box, exactly aligned boxes)."""
    rng = np.random.default_rng(seed)

    def pts():
        return 0.5 * rng.standard_normal((n, 3))

    def rad():
        return rng.uniform(0.05, 0.3, n)

    def rot():
        return np.array(jax.vmap(jtf.rpy_matrix)(
            jnp.asarray(rng.uniform(-np.pi, np.pi, (n, 3)))))

    def half():
        return rng.uniform(0.1, 0.5, (n, 3))

    if name == "sphere_sphere":
        return [pts(), rad(), pts(), rad()]
    if name == "sphere_capsule":
        return [pts(), rad(), pts(), pts(), rad()]
    if name == "capsule_capsule":
        a0, b0, a1 = pts(), pts(), pts()
        b1 = pts()
        b1[:4] = a1[:4] + (b0[:4] - a0[:4])          # parallel segments
        return [a0, b0, rad(), a1, b1, rad()]
    if name == "sphere_box":
        return [pts(), rad(), rot(), pts(), half()]
    if name == "capsule_box":
        a, b, p = pts(), pts(), pts()
        # through the box, 0.05 off its centre (exactly through the centre
        # the sign of a 1e-17 rounding residue picks the subgradient)
        b[:4] = 2 * (p[:4] + 0.05) - a[:4]
        return [a, b, rad(), rot(), p, half()]
    R0, p0 = rot(), pts()
    R1, p1 = rot(), pts()
    if name == "box_box_axis_aligned":
        R0[:6] = R1[:6] = np.eye(3)                   # exactly aligned
    return [R0, p0, half(), R1, p1, half()]


PRIMITIVES = ("sphere_sphere", "sphere_capsule", "capsule_capsule",
              "sphere_box", "capsule_box", "box_box", "box_box_axis_aligned")


def _tangent(g, R):
    """Gradient [n, 3, 3] w.r.t. a rotation, as derivatives along the three
    rotation directions dR = [e_k]x R -- what the solver composes
    (world.py `_compose_pose_grads`).  The raw entries are not comparable:
    terms like |R^T R - I| sit at rounding residues whose sign picks the
    subgradient, and they vanish along rotations."""
    skew_t = np.stack([np.cross(e, np.eye(3)) for e in np.eye(3)])  # [e]x'
    return np.einsum("nij,kli,nlj->nk", g, skew_t, R)


@pytest.mark.parametrize("name", PRIMITIVES)
def test_primitive_values_and_gradients_match_jax(name):
    args = _primitive_inputs(name)
    fj, ft = getattr(jgeom, name), getattr(tgeom, name)
    argnums = tuple(range(len(args)))
    d_j, g_j = jax.vmap(jax.value_and_grad(fj, argnums=argnums))(
        *(jnp.asarray(a) for a in args))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    d_t = ft(*leaves)
    g_t = torch.autograd.grad(d_t.sum(), leaves)
    assert (np.asarray(d_j) < 0).any() and (np.asarray(d_j) > 0).any()
    np.testing.assert_allclose(d_t.detach().numpy(), np.asarray(d_j),
                               rtol=0, atol=TOL)
    for arg, a, b in zip(args, g_t, g_j):
        a, b = a.numpy(), np.asarray(b)
        if arg.ndim == 3:                                # a rotation
            a, b = _tangent(a, arg), _tangent(b, arg)
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_pairs_match_jax():
    names = [(a.name, b.name) for a, b in pr2ish_scene().pairs()]
    assert names == [(a.name, b.name) for a, b in jax_pr2ish_scene().pairs()]
    assert len(names) == 91
