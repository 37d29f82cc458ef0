"""Port parity: the utilities (``utils/{finite_diff,joints,checkpoint,debug,
profiling,logging}.py``) and the batch split (``parallel/mesh.py``)
against the JAX package, float64 on the CPU.

* finite differences (gradient, Jacobian, Hessian diagonal, Hessian and
  the term-set ``fd_jac_fn``) to 1e-9;
* the joint-subset maps equal;
* checkpoint files written by either package load in the other;
* ``dump_failed_qps`` writes the JAX package's keys, arrays within 1e-9;
* ``solve_counters`` and ``summarize`` equal; ``trace`` writes a Chrome
  trace and ``Timer`` a time;
* the logging levels;
* ``make_sharded_batch_solver`` over two CPU devices against the unsplit
  solve: equal statuses, x within 5e-4 (the JAX test's budget).
"""

import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.parallel import mesh as jmesh
from trajopt_tpu.problem import trajectory as jtraj
from trajopt_tpu.sqp import solver as jsolver
from trajopt_tpu.terms import joint as jjoint
from trajopt_tpu.utils import checkpoint as jckpt
from trajopt_tpu.utils import debug as jdebug
from trajopt_tpu.utils import finite_diff as jfd
from trajopt_tpu.utils import joints as jjoints
from trajopt_tpu.utils import logging as jlog
from trajopt_tpu.utils import profiling as jprof
from trajopt_tpu_torch.models import benchmarks as tbench
from trajopt_tpu_torch.parallel import mesh as tmesh
from trajopt_tpu_torch.problem import trajectory as ttraj
from trajopt_tpu_torch.sqp import solver as tsolver
from trajopt_tpu_torch.sqp.params import SQPStatus
from trajopt_tpu_torch.terms import joint as tjoint
from trajopt_tpu_torch.utils import checkpoint as tckpt
from trajopt_tpu_torch.utils import debug as tdebug
from trajopt_tpu_torch.utils import finite_diff as tfd
from trajopt_tpu_torch.utils import joints as tjoints
from trajopt_tpu_torch.utils import logging as tlog
from trajopt_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)

X = np.array([0.3, -0.7, 0.5])


def _f_scalar(xp):
    return lambda x: xp.sin(x[0]) * x[1] + x[2] ** 3


def _f_vec(xp):
    stack = jnp.stack if xp is jnp else torch.stack
    return lambda x: stack([x[0] * x[1], xp.cos(x[2]), x[0] + 2.0 * x[2]])


@pytest.mark.parametrize("fn", ["num_grad", "num_jac", "num_hessian_diag",
                                "num_hessian"])
def test_finite_differences_match_jax(fn):
    f = _f_vec if fn == "num_jac" else _f_scalar
    ref = getattr(jfd, fn)(f(jnp), jnp.asarray(X))
    got = getattr(tfd, fn)(f(torch), torch.as_tensor(X))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-9)
    ref = getattr(jfd, fn)(f(jnp), jnp.asarray(X), 1e-3)
    got = getattr(tfd, fn)(f(torch), torch.as_tensor(X), 1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-9)
    assert tfd.DEFAULT_EPSILON == jfd.DEFAULT_EPSILON == 1e-5


def test_fd_jac_fn_matches_jax():
    """The FD Jacobian of a term set: per lane in JAX, on the batch in the
    port."""
    def jerr(x, p):
        return jnp.stack([jnp.sin(x[0]) + x[1] * p["k"], x[0] * x[1]])

    def terr(x, p):
        return torch.stack([torch.sin(x[:, 0]) + x[:, 1] * p["k"],
                            x[:, 0] * x[:, 1]], -1)

    rng = np.random.default_rng(0)
    xs, ks = rng.standard_normal((3, 2)), rng.uniform(1, 2, 3)
    ref = np.stack([np.asarray(jfd.fd_jac_fn(jerr)(jnp.asarray(x),
                                                    {"k": k}))
                    for x, k in zip(xs, ks)])
    got = tfd.fd_jac_fn(terr)(torch.as_tensor(xs),
                              {"k": torch.as_tensor(ks)})
    assert got.shape == (3, 2, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-9)


def test_joint_subset_maps_match_jax():
    sup = ["a", "b", "c", "d"]
    sub = ["d", "b"]
    v = np.array([[1.0, 2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0]])
    np.testing.assert_array_equal(tjoints.subset_indices(sup, sub),
                                  jjoints.subset_indices(sup, sub))
    np.testing.assert_array_equal(
        tjoints.get_subset(sup, torch.as_tensor(v), sub).numpy(),
        np.asarray(jjoints.get_subset(sup, jnp.asarray(v), sub)))
    new = np.array([[40.0, 20.0], [80.0, 60.0]])
    vt = torch.as_tensor(v)
    np.testing.assert_array_equal(
        tjoints.update_from_subset(sup, vt, sub, new).numpy(),
        np.asarray(jjoints.update_from_subset(sup, v, sub, new)))
    np.testing.assert_array_equal(vt.numpy(), v)     # a copy was written
    J = np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    np.testing.assert_array_equal(
        tjoints.expand_jacobian_rows(sup, sub, torch.as_tensor(J)).numpy(),
        np.asarray(jjoints.expand_jacobian_rows(sup, sub, J)))
    for mod in (jjoints, tjoints):
        with pytest.raises(KeyError):
            mod.subset_indices(sup, ["e"])


def _results(B=3, n=8, seed=0):
    """The same seeded batch result as each package's SQPResult."""
    rng = np.random.default_rng(seed)
    f = dict(x=rng.standard_normal((B, n)),
             status=np.array([1, 4, 3][:B], np.int32),
             cost_vals=rng.uniform(size=(B, 2)),
             cnt_viols=rng.uniform(size=(B, 1)),
             total_cost=rng.uniform(size=B),
             merit_coeffs=np.full((B, 1), 10.0),
             box_size=np.full(B, 0.1),
             n_iter=np.array([3, 7, 5][:B], np.int32),
             n_qp_solves=np.array([4, 9, 6][:B], np.int32),
             n_func_evals=np.array([5, 10, 7][:B], np.int32))
    return (jsolver.SQPResult(**{k: jnp.asarray(v) for k, v in f.items()}),
            tsolver.SQPResult(**{k: torch.as_tensor(v)
                                 for k, v in f.items()}))


def test_checkpoints_cross_load(tmp_path):
    jres, tres = _results()
    extra = {"tag": np.int64(7), "goals": np.arange(6.0).reshape(3, 2)}
    paths = {pkg: str(tmp_path / f"{pkg}.npz") for pkg in ("jax", "torch")}
    jckpt.save_result(paths["jax"], jres, extra)
    tckpt.save_result(paths["torch"], tres, extra)
    for path in paths.values():
        jr, je = jckpt.load_result(path)
        tr, te = tckpt.load_result(path)
        assert je.keys() == te.keys() == extra.keys()
        for f in tsolver.SQPResult._fields:
            np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                          np.asarray(getattr(jr, f)))
            np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                          np.asarray(getattr(jres, f)))
        for k in extra:
            np.testing.assert_array_equal(te[k].numpy(), je[k])
    with np.load(paths["jax"]) as a, np.load(paths["torch"]) as b:
        assert sorted(a.files) == sorted(b.files)
    trajs = np.arange(24.0).reshape(3, 4, 2)
    for pkg, mod in (("jax", jckpt), ("torch", tckpt)):
        path = str(tmp_path / f"trajs_{pkg}.npz")
        mod.save_trajectories(path, trajs if pkg == "jax"
                              else torch.as_tensor(trajs),
                              params={"goal": np.ones((3, 2))})
        jt, jp = jckpt.load_trajectories(path)
        tt, tp = tckpt.load_trajectories(path)
        np.testing.assert_array_equal(tt.numpy(), jt)
        np.testing.assert_array_equal(tp["goal"].numpy(), jp["goal"])


def _dump_problem(pkg, n=4, d=2):
    traj, joint = (jtraj, jjoint) if pkg == "jax" else (ttraj, tjoint)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    prob = traj.TrajOptProblem(n_steps=n, n_dof=d, joint_lower=[-5] * d,
                               joint_upper=[5] * d, fixed_steps=[0], **kw)
    prob.add_term(joint.joint_vel(n, d, is_cost=True))
    prob.add_term(joint.joint_pos(n, d, is_cost=False, targets="goal",
                                  first_step=n - 1, last_step=n - 1))
    prob.add_term(joint.joint_acc(n, d, is_cost=True, coeffs=[2.0, 3.0]))
    prob.add_term(joint.joint_jerk(n, d, is_cost=False, targets="goal",
                                   upper_tols=[0.1, 0.2],
                                   lower_tols=[-0.1, -0.2]))
    return prob


def test_dump_failed_qps_matches_jax(tmp_path):
    jres, tres = _results()
    goals = np.array([[1.0, 1.0], [2.0, -1.0], [0.5, 0.2]])
    jn, tn = _dump_problem("jax").build(), _dump_problem("torch").build()
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    # the default: the FAILED lane; no lane at TIME_LIMIT: nothing written
    assert tdebug.dump_failed_qps(tn, tres, {"goal": goals}, tpath) == 1
    assert tdebug.dump_failed_qps(
        tn, tres, {"goal": goals}, str(tmp_path / "none.npz"),
        statuses=(SQPStatus.TIME_LIMIT,)) == 0
    assert not os.path.exists(tmp_path / "none.npz")
    n_t = tdebug.dump_failed_qps(
        tn, tres, {"goal": torch.as_tensor(goals)}, tpath,
        statuses=(SQPStatus.CONVERGED, SQPStatus.PENALTY_ITERATION_LIMIT))
    jdebug.dump_failed_qps(
        jn, jres, {"goal": jnp.asarray(goals)}, jpath,
        statuses=(SQPStatus.CONVERGED, SQPStatus.PENALTY_ITERATION_LIMIT))
    assert n_t == 2
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        np.testing.assert_array_equal(b["failed_lanes"], [0, 2])
        for k in a.files:
            assert b[k].shape == a[k].shape, k
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-9,
                                       err_msg=k)
        assert b["lane0_P"].shape == (8, 8)
    # one lane, without the lane axis: a lane-invariant goal passes whole
    one = tsolver.SQPResult(*(f[2] for f in tres))
    assert tdebug.dump_failed_qps(
        tn, one, {"goal": torch.as_tensor(goals[2])}, tpath,
        statuses=(SQPStatus.PENALTY_ITERATION_LIMIT,)) == 1
    with np.load(tpath) as b, np.load(jpath) as a:
        np.testing.assert_allclose(b["lane0_A_cnt"], a["lane2_A_cnt"],
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(b["lane0_b_cnt"], a["lane2_b_cnt"],
                                   rtol=0, atol=1e-9)


def test_counters_summary_trace_and_timer(tmp_path):
    jres, tres = _results()
    assert tprof.solve_counters(tres) == jprof.solve_counters(jres)
    assert tmesh.summarize(tres) == jmesh.summarize(jres)
    prob = _dump_problem("torch")
    solve = prob.make_solve()
    x0 = torch.zeros(2, 4, 2, dtype=torch.float64)
    goals = torch.tensor([[1.0, 1.0], [2.0, -1.0]], dtype=torch.float64)
    log_dir = str(tmp_path / "trace")
    with tprof.trace(log_dir):
        with tprof.Timer() as t:
            res = t.observe(solve(x0, {"goal": goals}))
    assert t.elapsed > 0
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "sqp.convexify" for e in events)
    assert bool((res.status == SQPStatus.CONVERGED).all())
    assert tprof.machine_cache_dir("x").startswith(
        os.path.dirname(jprof.machine_cache_dir("x")))
    assert os.path.basename(tprof.machine_cache_dir("x")) == \
        os.path.basename(jprof.machine_cache_dir("x"))


def test_logging_levels(monkeypatch):
    assert tlog.TRACE == jlog.TRACE == 5
    assert tlog._LEVELS == jlog._LEVELS
    assert logging.getLevelName(tlog.TRACE) == "TRACE"
    log = tlog.get_logger()
    assert log.name == "trajopt_tpu_torch" and log.handlers
    tlog.set_log_level("debug")
    assert log.level == logging.DEBUG
    tlog.set_log_level("WARN")
    assert log.level == logging.WARNING
    monkeypatch.setenv("TRAJOPT_LOG_THRESH", "trace")
    fresh = tlog.get_logger("trajopt_tpu_torch.fresh_for_test")
    assert fresh.level == tlog.TRACE
    with pytest.raises(KeyError):
        tlog.set_log_level("LOUD")


def test_batch_split_over_two_cpu_devices():
    """The JAX test's split (arm7, 6 steps, LVS 2, block path) over two CPU
    devices against the unsplit solve."""
    prob, _ = tbench.arm_table_problem(n_steps=6, lvs_substeps=2,
                                       device="cpu")
    inits, goals = tbench.arm_table_batch(0, 8, 6, device="cpu")
    devices = tmesh.data_parallel_mesh(["cpu", "cpu"])
    assert devices == [torch.device("cpu")] * 2
    split = tmesh.make_sharded_batch_solver(prob, devices)(
        inits, {"goal": goals})
    whole = prob.make_solve(structured=True)(inits, {"goal": goals})
    np.testing.assert_array_equal(split.status.numpy(), whole.status.numpy())
    np.testing.assert_allclose(split.x.numpy(), whole.x.numpy(), rtol=0,
                               atol=5e-4)
    stats = tmesh.summarize(split)
    assert stats["n"] == 8 and stats["converged"] >= 6
    with pytest.raises(ValueError, match="divide"):
        tmesh.make_sharded_batch_solver(prob, ["cpu"] * 3)(
            inits, {"goal": goals})
