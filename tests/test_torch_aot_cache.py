"""The port's capture cache (``trajopt_tpu_torch/utils/aot_cache.py``) on
the CPU: the JAX module's tiny solve through both ``cached_export``s, the
memo's reuse and invalidation, the source hash, the solver's lane padding
on its real regions, ``eager()``, and the constant uploads hoisted out of
the regions.

On the CPU ``cached_export`` returns the function itself (there is
nothing to capture); the captured path runs in ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` on the card.
"""

import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.problem.trajectory import TrajOptProblem as JaxProblem
from trajopt_tpu.problem.trajectory import stationary_init as jax_init
from trajopt_tpu.terms.joint import joint_pos as jax_joint_pos
from trajopt_tpu.terms.joint import joint_vel as jax_joint_vel
from trajopt_tpu.utils.aot_cache import cached_export as jax_cached_export
from trajopt_tpu_torch.models.benchmarks import (pr2ish_table_batch,
                                                 pr2ish_table_problem)
from trajopt_tpu_torch import ifopt
from trajopt_tpu_torch.problem.trajectory import TrajOptProblem
from trajopt_tpu_torch.problem.trajectory import stationary_init
from trajopt_tpu_torch.qp.admm import ADMMConfig
from trajopt_tpu_torch.sqp import nlp as nlp_mod
from trajopt_tpu_torch.sqp.nlp import Kind, Nlp, TermSet
from trajopt_tpu_torch.sqp.params import SQPParams
from trajopt_tpu_torch.sqp.solver import make_solver
from trajopt_tpu_torch.terms.joint import joint_pos, joint_vel
from trajopt_tpu_torch.terms.user import user_defined_term
from trajopt_tpu_torch.utils import aot_cache


def _tiny_torch_problem():
    """tests/test_aot_cache.py's 5-step, 2-DOF problem in the port."""
    n = 5
    prob = TrajOptProblem(n_steps=n, n_dof=2, joint_lower=[-10, -10],
                          joint_upper=[10, 10], fixed_steps=[0],
                          device="cpu")
    prob.add_term(joint_vel(n, 2, is_cost=True))
    prob.add_term(joint_pos(n, 2, is_cost=False, targets="goal",
                            first_step=n - 1, last_step=n - 1))
    solve = prob.make_solve(device="cpu")
    init = stationary_init(torch.zeros(1, 2, dtype=torch.float64), n)
    goal = torch.tensor([[1.0, 2.0]], dtype=torch.float64)
    return (lambda i, g: solve(i, {"goal": g})), init, goal


def test_cached_export_matches_jax(tmp_path):
    """The tiny solve through the port's ``cached_export`` equals the JAX
    package's (exported into ``tmp_path``, float64) to 1e-9, same status."""
    n = 5
    jprob = JaxProblem(n_steps=n, n_dof=2, joint_lower=[-10, -10],
                       joint_upper=[10, 10], fixed_steps=[0])
    jprob.add_term(jax_joint_vel(n, 2, is_cost=True))
    jprob.add_term(jax_joint_pos(n, 2, is_cost=False, targets="goal",
                                 first_step=n - 1, last_step=n - 1))
    jsolve = jprob.make_solve()
    jinit, jgoal = jax_init(jnp.zeros(2), n), jnp.array([1.0, 2.0])
    jfn = jax_cached_export(lambda i, g: jsolve(i, {"goal": g}),
                            (jinit, jgoal), "k", cache_dir=str(tmp_path))
    ref = jfn(jinit, jgoal)

    fn, init, goal = _tiny_torch_problem()
    exported = aot_cache.cached_export(fn, (init, goal), "k", memo={})
    assert exported is fn           # nothing to capture on the CPU
    got = exported(init, goal)
    assert int(got.status[0]) == int(ref.status) == 1
    np.testing.assert_allclose(got.x[0].numpy(), np.asarray(ref.x),
                               rtol=0, atol=1e-9)


def test_memo_reuse_and_invalidation():
    """The same key and shapes reuse the memo's entry; a new key, shape or
    dtype adds one."""
    fn, init, goal = _tiny_torch_problem()
    memo = {}
    aot_cache.cached_export(fn, (init, goal), "config-a", memo=memo)
    aot_cache.cached_export(fn, (init.clone(), goal.clone()), "config-a",
                            memo=memo)
    assert len(memo) == 1
    aot_cache.cached_export(fn, (init, goal), "config-b", memo=memo)
    assert len(memo) == 2
    two = (torch.cat([init, init]), torch.cat([goal, goal]))
    aot_cache.cached_export(fn, two, "config-a", memo=memo)
    assert len(memo) == 3
    aot_cache.cached_export(fn, (init.float(), goal.float()), "config-a",
                            memo=memo)
    assert len(memo) == 4
    aot_cache.cached_export(fn, (init.float(), goal.float()), "config-a",
                            memo=memo)
    assert len(memo) == 4


def test_source_hash_follows_the_sources(tmp_path):
    """``_source_hash`` changes when a copied package's Python file or
    kernel source changes, and not when a built library appears."""
    root = tmp_path / "pkg"
    shutil.copytree(aot_cache.PKG, root,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    h0 = aot_cache._source_hash(root)
    assert h0 == aot_cache._source_hash(aot_cache.PKG)
    (root / "_build").mkdir()
    (root / "_build" / "libx.so").write_bytes(b"\0")
    assert aot_cache._source_hash(root) == h0
    py = root / "sqp" / "solver.py"
    py.write_text(py.read_text() + "\n# changed\n")
    h1 = aot_cache._source_hash(root)
    assert h1 != h0
    cu = root / "csrc" / "admm_block_chunk.cu"
    cu.write_text(cu.read_text() + "\n// changed\n")
    assert aot_cache._source_hash(root) not in (h0, h1)


def _flagship(n_steps, B):
    """The pr2ish flagship problem (LVS 2) in float64 on the CPU, a
    solver with its settings on the block path, and a seeded batch."""
    prob, _ = pr2ish_table_problem(n_steps=n_steps, lvs_substeps=2,
                                   device="cpu")
    sqp = dataclasses.replace(
        SQPParams(), max_restarts=1,
        qp=ADMMConfig(eps_abs=2e-5, eps_rel=2e-5, max_iter=450,
                      check_every=150, adaptive_rho=False,
                      rho_dual_scale=0.1, ns_refresh=True, ns_tol=1e-4,
                      ns_power_iters=4))
    inits, goals = pr2ish_table_batch(0, B, n_steps, device="cpu")
    x0 = inits.reshape(B, -1)
    return (make_solver(prob.build(), sqp, structured=True), x0,
            *prob.bounds(x0), {"goal": goals})


def test_padding_keeps_lanes_independent(monkeypatch):
    """The solver's convexify and evaluate regions on 3 live lanes padded
    to their bucket of 4 give, lane for lane, the rows of the same 3 lanes
    unpadded, to 1e-12 (a 10-step, 5-lane pr2ish float64 solve)."""
    calls = {}
    real = aot_cache.cached_export

    def record(fn, args, key, **kw):
        calls.setdefault(key.split("|")[0], (fn, args))
        return real(fn, args, key, **kw)

    monkeypatch.setattr(aot_cache, "cached_export", record)
    solve, *args = _flagship(10, 5)
    solve(*args)
    assert {"sqp.init", "sqp.convexify", "sqp.evaluate"} <= set(calls)
    assert aot_cache.bucket(3, 5) == 4
    for name in ("sqp.convexify", "sqp.evaluate"):
        fn, full = calls[name]
        three = aot_cache.take_lanes(full, 3)
        padded = aot_cache.pad_lanes(three, aot_cache.bucket(3, 5))
        assert {t.shape[0] for t in aot_cache.flatten(padded)[0]} == {4}
        got, _ = aot_cache.flatten(aot_cache.take_lanes(fn(*padded), 3))
        want, _ = aot_cache.flatten(fn(*three))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.shape == w.shape
            if g.is_floating_point():
                torch.testing.assert_close(g, w, rtol=0, atol=1e-12,
                                           equal_nan=True)
            else:
                assert torch.equal(g, w)


def test_eager_nests_and_restores(monkeypatch):
    """Under ``eager()`` (nested too) a captured callable runs its function
    and replays nothing; once the outermost context exits it replays
    again."""
    class FakeGraph:
        def replay(self):
            pass

    def fake_capture(self, leaves):
        self.static_in = [t.clone() for t in leaves]
        self.static_out, self.out_spec = aot_cache.flatten(
            self.fn(*aot_cache.unflatten(self.spec, self.static_in)))
        self.graph = FakeGraph()

    monkeypatch.setattr(aot_cache._Graphed, "_capture", fake_capture)
    runs = []

    def fn(x):
        runs.append(1)
        return x * 2

    x = torch.ones(3)
    leaves, spec = aot_cache.flatten((x,))
    g = aot_cache._Graphed(fn, leaves, spec, "test", None, False)
    aot_cache.STATS.reset()
    with aot_cache.eager():
        with aot_cache.eager():
            g(x)
        g(x)
    assert (len(runs), aot_cache.STATS.replays, g.graph) == (2, 0, None)
    torch.testing.assert_close(g(x + 1), 2 * (x + 1))
    assert aot_cache.STATS.replays == 1 and len(runs) == 3
    with aot_cache.eager():
        g(x)
    g(x)
    assert aot_cache.STATS.replays == 2 and len(runs) == 4
    with pytest.raises(ValueError):
        g(torch.ones(4))


def test_regions_upload_no_host_constants(monkeypatch):
    """Once a first solve has built the per-device caches, the flagship's
    convexify and evaluate regions create no tensor from host data
    (``torch.as_tensor`` / ``torch.tensor`` of numpy arrays, lists or
    numbers): a copy from pageable host memory cannot be captured."""
    solve, *args = _flagship(6, 3)
    solve(*args)
    count = {"n": 0, "in_region": False, "regions": set()}
    real = aot_cache.cached_export

    def counting(factory):
        def f(data, *a, **kw):
            if count["in_region"] and not isinstance(data, torch.Tensor):
                count["n"] += 1
            return factory(data, *a, **kw)
        return f

    def wrapped(fn, example, key, **kw):
        exported = real(fn, example, key, **kw)

        def run(*a):
            count["in_region"] = True
            count["regions"].add(key.split("|")[0])
            try:
                return exported(*a)
            finally:
                count["in_region"] = False
        return run

    monkeypatch.setattr(torch, "as_tensor", counting(torch.as_tensor))
    monkeypatch.setattr(torch, "tensor", counting(torch.tensor))
    monkeypatch.setattr(aot_cache, "cached_export", wrapped)
    solve(*args)
    assert {"sqp.convexify", "sqp.evaluate"} <= count["regions"]
    assert count["n"] == 0


def test_memo_keys_non_tensor_leaves():
    """A capture freezes its arguments' non-tensor leaves, so their values
    key the memo (arrays by content): another number or array adds an
    entry, an equal one reuses it, and a captured callable refuses other
    values instead of replaying the first ones."""
    x = torch.ones(3)
    memo = {}

    def f(v, s):
        return v * torch.as_tensor(s)

    for s in (2.0, 2.0, 3.0, np.array([1.0, 2.0, 3.0]),
              np.array([1.0, 2.0, 3.0]), np.array([1.0, 2.0, 3.5])):
        aot_cache.cached_export(f, (x, s), "k", memo=memo)
    assert len(memo) == 4
    leaves, spec = aot_cache.flatten((x, 2.0))
    g = aot_cache._Graphed(f, leaves, spec, "test", None, False)
    with aot_cache.eager():
        torch.testing.assert_close(g(x, 2.0), 2 * x)
        with pytest.raises(ValueError):
            g(x, 3.0)


def _ifopt_line(user: str):
    """A 3-node, 2-DOF ifopt problem (a squared joint-velocity cost, the
    endpoints held) whose endpoint constraint is the library's
    ``JointPosConstraint``s, a ``FunctionalConstraint`` that copies a host
    constant to the lane's device (``ends.to(...)``), or a user's subclass
    of ``ConstraintSet``."""
    prob = ifopt.Problem()
    nodes = []
    for t in range(3):
        nd = ifopt.Node(f"step{t}")
        nd.add_var("position", 2)
        nodes.append(nd)
    init = np.array([[-1.0, 0.0], [0.2, 0.3], [1.0, 0.5]])
    nv = prob.add_variable_set(ifopt.NodesVariables(
        "trajectory", nodes, init.reshape(-1), -5.0, 5.0))
    pos = [nv.node_var(t, "position") for t in range(3)]
    prob.add_cost_set(ifopt.SquaredCost(
        ifopt.JointVelConstraint(np.zeros(2), pos, coeffs=1.0)))
    ends = torch.tensor([-1.0, 0.0, 1.0, 0.5], dtype=torch.float64)

    def endpoints(v):
        return torch.cat([v["trajectory"][:2], v["trajectory"][-2:]]) \
            - ends.to(v["trajectory"])

    class Endpoints(ifopt.ConstraintSet):
        def values(self, vars):  # noqa: A002
            return endpoints(vars)

    if user == "library":
        prob.add_constraint_set(ifopt.JointPosConstraint(ends[:2].numpy(),
                                                         [pos[0]]))
        prob.add_constraint_set(ifopt.JointPosConstraint(ends[2:].numpy(),
                                                         [pos[-1]]))
    elif user == "function":
        prob.add_constraint_set(ifopt.FunctionalConstraint(4, "ends",
                                                           endpoints))
    else:
        prob.add_constraint_set(Endpoints(4, "ends"))
    return prob


def _tiny_nlp(user: str) -> Nlp:
    """The 5-step, 2-DOF joint problem's Nlp with the library's terms, a
    user-defined term, or a ``TermSet`` of the user's own functions."""
    n = 5
    terms = [joint_vel(n, 2, is_cost=True)]
    if user == "user term":
        terms.append(user_defined_term(lambda q, p: q - 1.0, n, 2))
    elif user == "TermSet":
        terms.append(TermSet("mine", Kind.COST_SQ, lambda x, p: x - 1.0,
                             2 * n))
    return Nlp(n=2 * n, term_sets=tuple(terms), block=(n, 2))


@pytest.mark.parametrize("case, user", [
    ("library terms", False), ("user term", True), ("TermSet", True),
    ("ifopt library", False), ("ifopt function", True),
    ("ifopt subclass", True)])
def test_runs_user_code_finds_user_functions(case, user):
    """``runs_user_code`` is true exactly when a term set reaches a
    function the port did not write: a user-defined term, a ``TermSet``
    of user lambdas, an ifopt ``FunctionalConstraint`` or a user's
    ``ConstraintSet`` subclass; the library's terms and sets are not."""
    if case.startswith("ifopt"):
        nlp = _ifopt_line(case.split()[1]).build()
    else:
        nlp = _tiny_nlp(case.split(" terms")[0])
    assert nlp_mod.runs_user_code(nlp) is user


def test_user_code_regions_run_eagerly(monkeypatch):
    """A solver over an Nlp that runs a user's code (an ifopt constraint
    that copies a host constant, ``ends.to(x)``, which a capture cannot
    hold) exports only its dense QP preparation and evaluates its terms
    eagerly; its solve equals the library constraints' solve of the same
    problem to 1e-9 (float64, CPU)."""
    keys = []
    real = aot_cache.cached_export

    def record(fn, args, key, **kw):
        keys.append(key)
        return real(fn, args, key, **kw)

    monkeypatch.setattr(aot_cache, "cached_export", record)
    out = {}
    for user in ("function", "library"):
        keys.clear()
        res, x = _ifopt_line(user).solve(device="cpu")
        out[user] = (res, x["trajectory"], set(keys))
    assert out["function"][2] == {"sqp.qp_prepare"}
    assert {"sqp.init", "sqp.convexify", "sqp.evaluate",
            "sqp.qp_prepare"} <= out["library"][2]
    assert int(out["function"][0].status) == int(out["library"][0].status)
    np.testing.assert_allclose(out["function"][1], out["library"][1],
                               rtol=0, atol=1e-9)
