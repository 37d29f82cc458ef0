"""Port parity: the ifopt collision constraints (``ifopt/collision.py``)
against the JAX package, float64 on the CPU.

* discrete and continuous rows and their error-weighted-average Jacobians,
  through ``Problem`` lowering, to 1e-9 on boxbot (one obstacle; and
  three obstacles with two spheres on the link and ``max_num_cnt`` below
  the link-pair count, at configurations where two link pairs tie at the
  top-k cut, so the rows kept and their Jacobians depend on the tie
  order) and on pr2ish at 3 gaps with LVS 2.

The facade's cast solve is in ``test_torch_ifopt_cast.py`` (a file a
worker, each within its time).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu import ifopt as jifo
from trajopt_tpu.collision import world as jworld
from trajopt_tpu.models import benchmarks as jbench
from trajopt_tpu.models import robots as jrobots
from trajopt_tpu_torch import ifopt as tifo
from trajopt_tpu_torch.collision import world as tworld
from trajopt_tpu_torch.models import robots as trobots
from trajopt_tpu_torch.sqp import nlp as tnlp

torch.set_num_threads(2)

PKGS = {"jax": (jifo, jworld, jrobots), "torch": (tifo, tworld, trobots)}


def _boxbot_scene(pkg, obstacles, two_spheres=False):
    _, world, robots = PKGS[pkg]
    scene = world.CollisionScene(robots.boxbot())
    scene.add_link_sphere("boxbot_link", 0.25)
    if two_spheres:
        scene.add_link_sphere("boxbot_link", 0.15, center=[0.3, 0.0, 0.0],
                              name="boxbot_link_sphere2")
    for i, c in enumerate(obstacles):
        scene.add_world_box(f"obstacle{i}", [0.5, 0.5, 0.5], c)
    return scene


def _problem(pkg, scene, n_steps, n_dof, *, lvs, max_num_cnt, margin,
             buffer, discrete=True):
    """A NodesVariables trajectory with a continuous constraint per gap and
    (``discrete``) a discrete one per node."""
    ifo = PKGS[pkg][0]
    prob = ifo.Problem()
    nodes = []
    for t in range(n_steps):
        nd = ifo.Node(f"step{t}")
        nd.add_var("position", n_dof)
        nodes.append(nd)
    nv = prob.add_variable_set(ifo.NodesVariables(
        "trajectory", nodes, np.zeros(n_steps * n_dof)))
    pos = [nv.node_var(t, "position") for t in range(n_steps)]
    kw = dict(margin=margin, coeff=20.0, max_num_cnt=max_num_cnt,
              safety_margin_buffer=buffer)
    for t in range(n_steps - 1):
        prob.add_constraint_set(ifo.ContinuousCollisionConstraint(
            scene, pos[t], pos[t + 1], lvs_substeps=lvs,
            name=f"continuous{t}", **kw))
    if discrete:
        for t in range(n_steps):
            prob.add_constraint_set(ifo.DiscreteCollisionConstraint(
                scene, pos[t], name=f"discrete{t}", **kw))
    return prob


def _jax_rows(nlp, xs):
    """(rows, analytic Jacobians) of every JAX term set at each point, as
    one jitted program."""
    def at(x):
        return [(t.fn(x, {}), t.jac_fn(x, {})) for t in nlp.term_sets]
    return jax.jit(jax.vmap(at))(jnp.asarray(xs))


def _held(tn, ref, xs):
    x = torch.as_tensor(xs)
    for t, (r_j, J_j) in zip(tn.term_sets, ref):
        r, J = tnlp._residual_and_jac(t, x, {})
        np.testing.assert_allclose(r.numpy(), np.asarray(r_j), rtol=0,
                                   atol=1e-9, err_msg=t.name)
        np.testing.assert_allclose(J.numpy(), np.asarray(J_j), rtol=0,
                                   atol=1e-9, err_msg=t.name)


# Three obstacles around the two-sphere link: obstacle 0 nearest on +x,
# obstacles 1 and 2 mirror each other in y, so with the trajectory on
# y = 0 their link pairs' rows tie, and max_num_cnt = 2 cuts between them.
TIE_OBSTACLES = ([1.3, 0.0, 0.0], [0.0, 1.6, 0.0], [0.0, -1.6, 0.0])


@pytest.mark.parametrize("case", ["one_obstacle", "top_k_ties"])
def test_boxbot_rows_and_jacobians_match_jax(case):
    if case == "one_obstacle":
        scenes = {pkg: _boxbot_scene(pkg, [[0.0, 0.0, 0.0]]) for pkg in PKGS}
        kw = dict(lvs=3, max_num_cnt=3, margin=0.2, buffer=0.0)
        rng = np.random.default_rng(0)
        xs = rng.uniform(-1.2, 1.2, (6, 6))
    else:
        scenes = {pkg: _boxbot_scene(pkg, TIE_OBSTACLES, two_spheres=True)
                  for pkg in PKGS}
        kw = dict(lvs=2, max_num_cnt=2, margin=1.6, buffer=0.05)
        rng = np.random.default_rng(1)
        xs = rng.uniform(-0.4, 0.4, (6, 6))
        xs[:4, 1::2] = 0.0                  # four lanes on y = 0
    jp = _problem("jax", scenes["jax"], 3, 2, **kw)
    tp = _problem("torch", scenes["torch"], 3, 2, **kw)
    jn, tn = jp.build(), tp.build()
    assert [(t.name, t.kind.value, t.n_rows) for t in tn.term_sets] == \
        [(t.name, t.kind.value, t.n_rows) for t in jn.term_sets]
    _held(tn, _jax_rows(jn, xs), xs)
    if case == "top_k_ties":
        # the tie is real: uncapped, the two mirrored link pairs' rows are
        # equal, and the kept row's Jacobian points to the lower one
        full = jifo.DiscreteCollisionConstraint(
            scenes["jax"], jifo.Var(0, 2), margin=1.6, coeff=20.0,
            max_num_cnt=None, safety_margin_buffer=0.05)
        d = np.asarray(scenes["jax"].distances(jnp.asarray(xs[0, :2])))
        v = np.asarray(full.values(jifo._VarReader(jnp.asarray(xs[0, :2]),
                                                   {})))
        assert v.shape == (3,) and v[1] == v[2] and v[0] > v[1], (v, d)
        capped = tifo.DiscreteCollisionConstraint(
            scenes["torch"], tifo.Var(0, 2), margin=1.6, coeff=20.0,
            max_num_cnt=2, safety_margin_buffer=0.05)
        J = capped.jacobian(tifo._VarReader(torch.as_tensor(xs[0, :2]), {}))
        assert float(J[1, 1]) > 0.0       # obstacle 1's row (+y), not 2's


def test_pr2ish_rows_and_jacobians_match_jax():
    """pr2ish (91 pairs, self-collision, 3 gaps, LVS 2, the default row cap
    of 3): every gap's sets against the JAX classes on one jitted program
    over the gaps' (q_t, q_t+1) pairs."""
    jscene, tscene = jrobots.pr2ish_scene(), trobots.pr2ish_scene()
    kw = dict(margin=0.05, coeff=20.0, max_num_cnt=3,
              safety_margin_buffer=0.02)
    cont = jifo.ContinuousCollisionConstraint(
        jscene, jifo.Var(0, 8), jifo.Var(8, 8), lvs_substeps=2, **kw)
    disc = jifo.DiscreteCollisionConstraint(jscene, jifo.Var(0, 8), **kw)

    def at(x):
        r = jifo._VarReader(x, {})
        return (cont.values(r), cont.jacobian(r), disc.values(r),
                disc.jacobian(r))

    rng = np.random.default_rng(4)
    n_steps, B = 4, 2
    qs = jbench.PR2ISH_HOME + 0.35 * rng.standard_normal((B, n_steps, 8))
    pairs = np.concatenate([qs[:, :-1], qs[:, 1:]], -1).reshape(-1, 16)
    cv, cJ, dv, dJ = (np.asarray(a).reshape(B, n_steps - 1, *a.shape[1:])
                      for a in jax.jit(jax.vmap(at))(jnp.asarray(pairs)))

    tp = _problem("torch", tscene, n_steps, 8, lvs=2, max_num_cnt=3,
                  margin=0.05, buffer=0.02, discrete=False)
    tn = tp.build()
    x = torch.as_tensor(qs.reshape(B, -1))
    assert len(tn.term_sets) == n_steps - 1
    for g, t in enumerate(tn.term_sets):
        assert (t.name, t.kind.value, t.n_rows) == \
            (f"continuous{g}/ub", "cnt_ineq", 3)
        r, J = tnlp._residual_and_jac(t, x, {})
        np.testing.assert_allclose(r.numpy(), cv[:, g], rtol=0, atol=1e-9)
        cols = slice(8 * g, 8 * g + 16)
        np.testing.assert_allclose(J[..., cols].numpy(), cJ[:, g], rtol=0,
                                   atol=1e-9)
        rest = torch.ones(J.shape[-1], dtype=torch.bool)
        rest[cols] = False
        assert not bool(J[..., rest].any())
    # the discrete set on each node's variable
    for g in range(n_steps - 1):
        ds = tifo.DiscreteCollisionConstraint(
            tscene, tifo.Var(8 * g, 8), **kw)
        reader = tifo._VarReader(x, {})
        np.testing.assert_allclose(ds.values(reader).numpy(), dv[:, g],
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(
            ds.jacobian(reader)[..., 8 * g:8 * g + 8].numpy(),
            dJ[:, g, :, :8], rtol=0, atol=1e-9)
