"""Port parity for the solver's callbacks and ``callbacks.py``, against the
JAX package in float64 on the CPU.

The port calls its callback once per SQP pass with the live lanes, and the
host-function wrappers call the host function once per live lane in lane
order; so at pass p the snapshots are those of the lanes still running, in
lane order, each at iteration p.  The JAX reference solves each lane on
its own (one ``jit`` per callback, called per lane: the JAX stopping
callback cannot run under ``vmap``), and the port's snapshots, regrouped by
pass, must be the JAX lanes' snapshots: equal iteration numbers and shapes,
values within 1e-9.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from trajopt_tpu import callbacks as jcb
from trajopt_tpu.problem.trajectory import TrajOptProblem as JaxProblem
from trajopt_tpu.terms import joint as jjoint
from trajopt_tpu_torch import callbacks as tcb
from trajopt_tpu_torch.problem.trajectory import TrajOptProblem
from trajopt_tpu_torch.sqp.params import SQPStatus
from trajopt_tpu_torch.terms import joint as tjoint

torch.set_num_threads(2)

N, D = 4, 2
# Goals at growing distances: the lanes need different numbers of SQP
# iterations (the trust box starts at 0.1 and grows by 1.5 per accepted
# step).
GOALS = np.array([[0.05, -0.05], [0.6, -0.4], [2.0, -1.5]])
STOP_AT = 2
TOL = 1e-9


def _problem(cls, joint):
    kw = dict(n_steps=N, n_dof=D, joint_lower=[-10, -10],
              joint_upper=[10, 10], fixed_steps=[0])
    if cls is TrajOptProblem:
        kw["device"] = "cpu"
    prob = cls(**kw)
    prob.add_term(joint.joint_vel(N, D, is_cost=True))
    prob.add_term(joint.joint_pos(N, D, is_cost=False, targets="goal",
                                  first_step=N - 1, last_step=N - 1))
    return prob


def _jax_lanes(make_cb):
    """Per lane: (result, snapshots) of the JAX solve with the host
    callback ``make_cb(list)``'s snapshots appended to that list."""
    seen = []
    solve = jax.jit(_problem(JaxProblem, jjoint).make_solve(
        callback=make_cb(seen)))
    out = []
    for g in GOALS:
        start = len(seen)
        res = jax.tree.map(np.asarray, solve(jnp.zeros((N, D)),
                                             {"goal": jnp.asarray(g)}))
        out.append((res, seen[start:]))
    return out


def _port(make_cb):
    seen = []
    solve = _problem(TrajOptProblem, tjoint).make_solve(
        callback=make_cb(seen))
    res = solve(torch.zeros(len(GOALS), N, D),
                {"goal": torch.as_tensor(GOALS)})
    return res, seen


def _expected_order(lanes):
    """The JAX lanes' snapshots in the port's order: pass by pass, the
    lanes that reach that pass, in lane order."""
    out = []
    for p in range(max(len(s) for _, s in lanes)):
        out += [s[p] for _, s in lanes if len(s) > p]
    return out


def _same_snapshots(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert isinstance(a, tcb.IterationSnapshot)
        assert a.iteration == b.iteration
        for name in ("x", "cost_vals", "cnt_viols", "merit_coeffs"):
            va, vb = getattr(a, name), getattr(b, name)
            assert va.shape == vb.shape, name
            np.testing.assert_allclose(va, vb, rtol=0, atol=TOL, err_msg=name)
        assert abs(a.box_size - b.box_size) <= TOL


def test_iteration_callback_matches_jax(tmp_path):
    lanes = _jax_lanes(lambda seen: jcb.make_iteration_callback(seen.append))
    iters = [int(r.n_iter) for r, _ in lanes]
    assert len(set(iters)) > 1                   # lanes stop at other passes
    assert [len(s) for _, s in lanes] == iters   # one snapshot an iteration
    res, seen = _port(lambda s: tcb.make_iteration_callback(s.append))
    assert res.n_iter.tolist() == iters
    assert (res.status == SQPStatus.CONVERGED).all()
    _same_snapshots(seen, _expected_order(lanes))

    # the CSV logs and merit tables of the same iterations
    logs = []
    for snaps, mod in ((seen, tcb), (_expected_order(lanes), jcb)):
        logger = mod.CsvLogger()
        for s in snaps:
            logger(s)
        paths = [os.path.join(tmp_path, f"{mod.__name__}.{k}.log")
                 for k in ("solver", "vars")]
        logger.write_solver_log(paths[0])
        logger.write_vars_log(paths[1])
        logs.append([np.genfromtxt(p, delimiter=",", skip_header=h)
                     for p, h in zip(paths, (1, 0))])
        assert open(paths[0]).readline() == \
            "iteration,total_cost,max_viol,box_size\n"
    for a, b in zip(*logs):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    # the merit table of each lane's result (the same numbers rendered by
    # both modules: the results themselves differ in the last bits, which
    # the table's 5 digits show for violations of ~1e-15)
    for r, _ in lanes:
        args = (["joint_vel"], r.cost_vals, ["joint_pos"], r.cnt_viols,
                r.merit_coeffs)
        assert tcb.format_merit_table(*args) == jcb.format_merit_table(*args)


def test_stopping_callback_matches_jax():
    """Lanes that reach iteration STOP_AT stop there: status
    STOPPED_BY_CALLBACK, one more iteration counted, the state of the
    iteration before; lanes that converge first are untouched."""
    def host(seen):
        def fn(snap):
            seen.append(snap)
            return snap.iteration < STOP_AT
        return fn

    lanes = _jax_lanes(lambda seen: jcb.make_stopping_callback(host(seen)))
    status = np.array([int(r.status) for r, _ in lanes])
    assert (status == SQPStatus.STOPPED_BY_CALLBACK).any()
    assert (status == SQPStatus.CONVERGED).any()
    res, seen = _port(lambda s: tcb.make_stopping_callback(host(s)))
    _same_snapshots(seen, _expected_order(lanes))
    np.testing.assert_array_equal(res.status.numpy(), status)
    for i, (r, _) in enumerate(lanes):
        assert int(res.n_iter[i]) == int(r.n_iter)
        assert int(res.n_qp_solves[i]) == int(r.n_qp_solves)
        assert int(res.n_func_evals[i]) == int(r.n_func_evals)
        np.testing.assert_allclose(res.x[i].numpy(), r.x, rtol=0, atol=TOL)
        np.testing.assert_allclose(res.merit_coeffs[i].numpy(),
                                   r.merit_coeffs, rtol=0, atol=TOL)
    stopped = res.status == SQPStatus.STOPPED_BY_CALLBACK
    assert (res.n_iter[stopped] == STOP_AT + 1).all()


def test_raw_callback_mask_and_no_callback():
    """A callback may return a per-lane mask directly, or None; a solve
    with a callback that stops nothing equals one without a callback,
    bit for bit."""
    prob = _problem(TrajOptProblem, tjoint)
    x0, goals = torch.zeros(3, N, D), {"goal": torch.as_tensor(GOALS)}
    plain = prob.make_solve()(x0, goals)
    calls = []

    def quiet(it, x, cost_vals, cnt_viols, merit_coeffs, box_size):
        calls.append(x.shape[0])

    logged = prob.make_solve(callback=quiet)(x0, goals)
    for a, b in zip(plain, logged):
        assert torch.equal(a, b)
    assert calls[0] == 3 and len(calls) == int(plain.n_iter.max())

    # at pass 1 the last live lane is lane 2, the slowest
    def last_lane(it, x, cost_vals, cnt_viols, merit_coeffs, box_size):
        return (it == 1) & (torch.arange(x.shape[0]) == x.shape[0] - 1)

    res = prob.make_solve(callback=last_lane)(x0, goals)
    assert int(res.status[2]) == SQPStatus.STOPPED_BY_CALLBACK
    assert int(res.n_iter[2]) == 2
    for a, b in zip(res, plain):
        assert torch.equal(a[:2], b[:2])


def test_host_helpers_match_jax(monkeypatch):
    snap = tcb.IterationSnapshot(3, np.zeros(2), np.ones(1), np.zeros(1),
                                 np.full(1, 10.0), 0.1)
    for mod in (tcb, jcb):
        w = mod.WaitForInput()
        monkeypatch.setattr("builtins.input", lambda *_: "")
        assert w(snap) is True
        monkeypatch.setattr("builtins.input", lambda *_: "q")
        assert w(snap) is False
        assert mod.chain(lambda s: None, lambda s: True)(snap) is True
        assert mod.chain(lambda s: None, lambda s: False)(snap) is False
    args = (["joint_vel", "a_cost_with_a_rather_long_name_here"],
            np.array([1.5, 2e-7]), ["goal"], np.array([0.02]),
            np.array([10.0]))
    assert tcb.format_merit_table(*args) == jcb.format_merit_table(*args)
