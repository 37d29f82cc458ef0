"""Port parity: the host reference driver (``sqp/reference_solver.py``),
the native C++ QP (``qp/native.py``) and the LRU cache
(``utils/cache.py``) against the JAX package, float64 on the CPU.

* ``csrc/qp_admm.cpp`` is a byte-identical copy of ``native/qp_admm.cpp``;
* ``solve_qp_native`` equals the JAX package's on seeded QPs, with penalty
  rows and a warm start (the same C++ on the same float64 inputs, built
  with other flags);
* ``LRUCache`` behaves as the JAX one and ``joint_hash`` gives equal bytes;
* ``solve_reference`` against the JAX package's on the three problems of
  ``tests/test_backend_parity.py``: equal status and counts, x within
  1e-6; the port's batched ``make_solve`` against its own
  ``solve_reference`` within 1e-3 (the backend parity budget).

``arm_table.json`` under ``convex_solver: native`` is held in
``test_torch_reference_json.py`` (a file a worker, each within its time).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_json_io import BOXBOT_URDF, SPHEREBOT_URDF, _bot_scene
from trajopt_tpu.collision import world as jworld
from trajopt_tpu.kinematics import chain as jchain
from trajopt_tpu.kinematics import urdf as jurdf
from trajopt_tpu.problem import trajectory as jtraj
from trajopt_tpu.qp import native as jnative
from trajopt_tpu.sqp import reference_solver as jref
from trajopt_tpu.terms import collision as jcoll
from trajopt_tpu.terms import joint as jjoint
from trajopt_tpu.utils import cache as jcache
from trajopt_tpu_torch.collision import world as tworld
from trajopt_tpu_torch.kinematics import chain as tchain
from trajopt_tpu_torch.kinematics import urdf as turdf
from trajopt_tpu_torch.problem import trajectory as ttraj
from trajopt_tpu_torch.qp import native as tnative
from trajopt_tpu_torch.sqp import reference_solver as tref
from trajopt_tpu_torch.terms import collision as tcoll
from trajopt_tpu_torch.terms import joint as tjoint
from trajopt_tpu_torch.utils import cache as tcache

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INF = float("inf")


def test_qp_source_is_a_byte_identical_copy():
    with open(os.path.join(REPO, "native", "qp_admm.cpp"), "rb") as f:
        ref = f.read()
    with open(os.path.join(REPO, "trajopt_tpu_torch", "csrc",
                           "qp_admm.cpp"), "rb") as f:
        assert f.read() == ref
    assert tnative.available()
    # built into the port's build directory, never into native/
    lib = tnative._load()._name
    assert os.path.dirname(lib) == os.path.join(REPO, "trajopt_tpu_torch",
                                                "_build")


def _seeded_qp(seed, n=12, m_cnt=8, penalty=True):
    """A seeded QP: SPD P, constraint rows (hard inequalities, equalities
    and, with ``penalty``, penalty rows with finite c), then box rows."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n)) / np.sqrt(n)
    P = G @ G.T + 0.1 * np.eye(n)
    q = rng.standard_normal(n)
    A = np.concatenate([rng.standard_normal((m_cnt, n)), np.eye(n)])
    bnd = rng.standard_normal(m_cnt)
    kind = np.arange(m_cnt) % 3          # ineq / eq / penalty
    l = np.concatenate([np.where(kind == 1, bnd, -INF), np.full(n, -2.0)])
    u = np.concatenate([bnd, np.full(n, 2.0)])
    c = np.concatenate([np.where((kind == 2) & penalty,
                                 rng.uniform(1, 20, m_cnt), INF),
                        np.full(n, INF)])
    return P, q, A, l, u, c


def _same_qp_result(a, b):
    assert (a.iters, a.converged) == (b.iters, b.converged)
    for f in ("x", "z", "y"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=0,
                                   atol=1e-9, err_msg=f)
    assert abs(a.pri_res - b.pri_res) <= 1e-9
    assert abs(a.dua_res - b.dua_res) <= 1e-9


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_qp_matches_jax(seed):
    args = _seeded_qp(seed)
    got = tnative.solve_qp_native(*args)
    ref = jnative.solve_qp_native(*args)
    assert got.converged
    _same_qp_result(got, ref)
    # warm start from the solution, as the JAX test does
    kw = dict(x0=ref.x, z0=ref.z, y0=ref.y)
    warm = tnative.solve_qp_native(*args, **kw)
    _same_qp_result(warm, jnative.solve_qp_native(*args, **kw))
    assert warm.iters <= got.iters


def test_native_penalty_row_and_options_match_jax():
    # min 0.5(x-3)^2 + 5*max(0, x-1) -> x = 1 (the JAX test's QP)
    args = (np.eye(1), np.array([-3.0]), np.eye(1), np.array([-INF]),
            np.array([1.0]), np.array([5.0]))
    got = tnative.solve_qp_native(*args)
    assert got.converged
    np.testing.assert_allclose(got.x, [1.0], atol=1e-6)
    _same_qp_result(got, jnative.solve_qp_native(*args))
    kw = dict(rho=0.3, max_iter=50, check_every=10, eps_abs=1e-6,
              eps_rel=1e-6)
    args = _seeded_qp(5, penalty=False)
    _same_qp_result(tnative.solve_qp_native(*args, **kw),
                    jnative.solve_qp_native(*args, **kw))


@pytest.mark.parametrize("mod", [jcache, tcache], ids=["jax", "torch"])
def test_lru_cache_behaviour(mod):
    c = mod.LRUCache(capacity=2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1            # a becomes most recent
    c.put("c", 3)                     # evicts b
    assert "b" not in c and "a" in c and len(c) == 2
    c.put("a", 10)
    c.put("d", 4)                     # evicts c, not a
    assert c.get("a") == 10 and "c" not in c
    calls = []
    assert c.get_or_acquire("k", lambda: calls.append(1) or 42) == 42
    assert c.get_or_acquire("k", lambda: calls.append(1) or 42) == 42
    assert len(calls) == 1
    assert (c.hits, c.misses) == (3, 1)
    assert c.get("zz", "dflt") == "dflt"
    c.clear()
    assert len(c) == 0
    with pytest.raises(ValueError):
        mod.LRUCache(0)


def test_joint_hash_equal_bytes():
    rng = np.random.default_rng(3)
    for x in (rng.standard_normal(8), rng.standard_normal((3, 4)),
              np.array([0.1, -0.2, 0.3]) + 1e-13):
        ref = jcache.joint_hash(x)
        assert tcache.joint_hash(x) == ref
        assert tcache.joint_hash(torch.as_tensor(x)) == ref
        assert tcache.joint_hash(x, digits=4) == jcache.joint_hash(x, 4)
    x = np.array([0.1, -0.2, 0.3])
    assert tcache.joint_hash(x) != tcache.joint_hash(x + 1e-6)
    assert tcache.joint_hash(x) != tcache.joint_hash(x.reshape(1, 3))


def _scene(pkg, robot):
    world, chain, urdf_mod = ((jworld, jchain, jurdf) if pkg == "jax"
                              else (tworld, tchain, turdf))
    text = SPHEREBOT_URDF if robot == "spherebot" else BOXBOT_URDF
    return _bot_scene(world, chain, urdf_mod, text,
                      "sphere" if robot == "spherebot" else "box")


def _parity_problem(pkg, name):
    """The three problems of tests/test_backend_parity.py: (problem, init
    [n_steps, 2])."""
    traj, joint, coll = ((jtraj, jjoint, jcoll) if pkg == "jax"
                         else (ttraj, tjoint, tcoll))
    kw = {} if pkg == "jax" else {"device": "cpu"}
    if name == "joint_only":
        n = 5
        prob = traj.TrajOptProblem(n_steps=n, n_dof=2, joint_lower=[-10, -10],
                                   joint_upper=[10, 10], fixed_steps=[0],
                                   **kw)
        prob.add_term(joint.joint_vel(n, 2, is_cost=True))
        prob.add_term(joint.joint_pos(n, 2, is_cost=False,
                                      targets=np.array([1.5, -2.0]),
                                      first_step=n - 1, last_step=n - 1))
        return prob, np.zeros((n, 2))
    if name == "collision":
        s = _scene(pkg, "spherebot")
        prob = traj.TrajOptProblem(n_steps=1, n_dof=2, joint_lower=[-10, -10],
                                   joint_upper=[10, 10], **kw)
        prob.add_term(coll.collision_term(s, 1, margin=0.3, coeff=1.0,
                                          is_cost=True))
        prob.add_term(coll.collision_term(s, 1, margin=0.2, coeff=1.0,
                                          is_cost=False))
        prob.add_term(joint.joint_pos(1, 2, is_cost=True,
                                      targets=np.zeros(2), first_step=0,
                                      last_step=0))
        return prob, np.array([[-0.75, 0.75]])
    s = _scene(pkg, "boxbot")
    n = 3
    prob = traj.TrajOptProblem(n_steps=n, n_dof=2, joint_lower=[-10, -10],
                               joint_upper=[10, 10], fixed_steps=[0, n - 1],
                               **kw)
    prob.add_term(joint.joint_vel(n, 2, is_cost=True))
    prob.add_term(coll.collision_term(s, n, margin=0.05, coeff=20.0,
                                      is_cost=False, evaluator="cast",
                                      fixed_steps=[0, n - 1]))
    return prob, np.array([[-1.9, 0.0], [0.0, 1.2], [1.9, 0.0]])


def _ref_fields(r):
    return (int(r.status), int(r.n_iter), int(r.n_qp_solves))


@pytest.mark.parametrize("name", ["joint_only", "collision", "cast"])
def test_reference_solver_matches_jax(name):
    jprob, init = _parity_problem("jax", name)
    tprob, _ = _parity_problem("torch", name)
    x0 = jnp.asarray(init).reshape(-1)
    lb, ub = jprob.bounds(x0)
    ref = jref.solve_reference(jprob.build(), np.asarray(x0), np.asarray(lb),
                               np.asarray(ub), {})
    xt = torch.as_tensor(init).reshape(1, -1)
    tlb, tub = tprob.bounds(xt)
    got = tref.solve_reference(tprob.build(), xt[0], tlb[0], tub[0], {},
                               device="cpu")
    assert ref.status == 1
    assert _ref_fields(got) == _ref_fields(ref)
    np.testing.assert_allclose(got.x, ref.x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.cost_vals, ref.cost_vals, rtol=0,
                               atol=1e-6)
    # the port's batched solver within the backend parity budget
    res = tprob.make_solve()(xt)
    assert int(res.status[0]) == 1
    np.testing.assert_allclose(res.x[0].numpy(), got.x, rtol=0, atol=1e-3)


def test_reference_solver_time_limit_and_params():
    """max_time 0 ends at once with TIME_LIMIT, as in JAX; a params-keyed
    goal reaches the terms as one lane's entry."""
    n = 4
    kw = dict(n_steps=n, n_dof=2, joint_lower=[-5, -5], joint_upper=[5, 5],
              fixed_steps=[0])
    jprob, tprob = jtraj.TrajOptProblem(**kw), ttraj.TrajOptProblem(
        **kw, device="cpu")
    for prob, joint in ((jprob, jjoint), (tprob, tjoint)):
        prob.add_term(joint.joint_vel(n, 2, is_cost=True))
        prob.add_term(joint.joint_pos(n, 2, is_cost=False, targets="goal",
                                      first_step=n - 1, last_step=n - 1))
    goal = np.array([1.0, -0.5])
    x0 = np.zeros(2 * n)
    lb, ub = np.full(2 * n, -5.0), np.full(2 * n, 5.0)
    lb[:2] = ub[:2] = 0.0
    sqp0 = tref.SQPParams(max_time=0.0)
    got = tref.solve_reference(tprob.build(), x0, lb, ub,
                               {"goal": goal}, sqp0, device="cpu")
    ref = jref.solve_reference(jprob.build(), x0, lb, ub,
                               {"goal": jnp.asarray(goal)},
                               jref.SQPParams(max_time=0.0))
    assert _ref_fields(got) == _ref_fields(ref) == (6, 0, 0)
    got = tref.solve_reference(tprob.build(), x0, lb, ub,
                               {"goal": goal}, device="cpu")
    ref = jref.solve_reference(jprob.build(), x0, lb, ub,
                               {"goal": jnp.asarray(goal)})
    assert _ref_fields(got) == _ref_fields(ref)
    assert got.status == 1
    np.testing.assert_allclose(got.x, ref.x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.x[-2:], goal, atol=1e-4)
