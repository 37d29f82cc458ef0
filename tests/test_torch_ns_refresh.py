"""The Newton-Schulz refresh of the block QP's KKT inverse
(``trajopt_tpu_torch/qp/inverse.py``) on the CPU, float64: its plain
version (the arithmetic of ``csrc/ns_refresh.cu``: the banded residual and
the lane-masked update) against the per-lane loop it replaced, on the
flagship's own systems; the fixed-launch plan of the card against the
early-exit plan; the block band the solver derives and M's zeros; the
rescue; the counters.  The kernels themselves are held against this
version in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from trajopt_tpu_torch.models.benchmarks import (flagship_params,
                                                 pr2ish_table_batch,
                                                 pr2ish_table_problem)
from trajopt_tpu_torch.qp import admm_block
from trajopt_tpu_torch.qp import inverse as inv
from trajopt_tpu_torch.sqp import nlp as nlp_mod
from trajopt_tpu_torch.sqp.nlp import Kind, Nlp, TermSet
from trajopt_tpu_torch.terms import joint
from trajopt_tpu_torch.utils import profiling

torch.set_num_threads(2)

N_STEPS, LANES = 6, 3


def _reference(M, X0, *, tol, max_iter, power_iters, target=1.8,
               coarse=False, coarse_tol=5e-2):
    """The refresh as the port ran it before its kernels: a loop over the
    batch while any lane is active, dense ``M @ X``, ``matrix_norm``.
    Returns (X, each lane's iterations over the phases and the rescue)."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype)

    def loop(X, r, k, tol, budget):
        active = (r > tol) & (k < budget)
        while bool(active.any()):
            E = eye - M @ X
            r_new = torch.linalg.matrix_norm(E)
            X = torch.where(active[:, None, None], X + X @ E, X)
            r = torch.where(active, r_new, r)
            k = k + active.to(k.dtype)
            active = (r > tol) & (k < budget)
        return X, k

    B = M.shape[0]
    lam = inv._lam_max_estimate(M, X0, power_iters)
    margin = 1.1 if power_iters >= 8 else 1.2 + 0.8 / max(power_iters, 1)
    X = torch.minimum(M.new_ones(()), target / (margin * lam))[:, None,
                                                                None] * X0
    iters = torch.zeros(B, dtype=torch.int32)
    for phase_tol in ([coarse_tol] if coarse else []) + [tol]:
        X, k = loop(X, M.new_full((B,), float("inf")),
                    torch.zeros(B, dtype=torch.int32), phase_tol, max_iter)
        iters += k
    r = torch.linalg.matrix_norm(eye - M @ X)
    bad = ~torch.isfinite(r) | (r > 1.0)
    X_safe = (target / (torch.linalg.matrix_norm(M) + 1e-30))[:, None,
                                                              None] * eye
    X = torch.where(bad[:, None, None], X_safe, X)
    r0 = torch.where(bad, torch.full_like(r, float("inf")),
                     torch.zeros_like(r))
    X, k = loop(X, r0, torch.zeros(B, dtype=torch.int32), tol, 4 * max_iter)
    return X, iters + k


@pytest.fixture(scope="module")
def flagship():
    """The flagship's refreshes on the CPU: (nlp, [(M, seed)]) from a
    6-step solve on 3 lanes, float64, with the flagship's settings."""
    prob, _ = pr2ish_table_problem(n_steps=N_STEPS, lvs_substeps=2,
                                   device="cpu")
    solve = prob.make_solve(flagship_params(), structured=True)
    inits, goals = pr2ish_table_batch(0, LANES, N_STEPS, dtype=torch.float64,
                                      device="cpu", hard_frac=0.4)
    seen, real = [], admm_block.ns_inverse

    def probe(M, X0, **kw):
        seen.append((M.clone(), X0.clone(), kw["band"]))
        return real(M, X0, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(admm_block, "ns_inverse", probe)
    try:
        solve(inits, {"goal": goals})
    finally:
        mp.undo()
    assert len(seen) >= 2
    return prob.build(), seen


def _refresh(M, X0, *, reads, band=None, **kw):
    """The plain version's refresh with or without its host read each
    iteration: without, every phase runs its max_iter iterations, as the
    card's kernels do."""
    kw = dict(dict(target=1.8, coarse=False, coarse_tol=5e-2), **kw)
    return inv._refresh(inv._Plain, M, X0, band=band, reads=reads, **kw)


def _probe_plain(monkeypatch):
    """Record each plain refresh's state object (its per-lane kt)."""
    made = []

    class Probe(inv._Plain):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(inv, "_Plain", Probe)
    return made


@pytest.mark.parametrize("tol", [1e-4, 1e-10])
def test_plain_refresh_matches_the_per_lane_loop(flagship, monkeypatch,
                                                 tol):
    """On every refresh of the solve: equal per-lane iteration counts and
    X within 1e-12 of the per-lane loop, at the flagship's tolerance and a
    tight one (lanes then stop apart)."""
    _, seen = flagship
    cfg = flagship_params().qp
    kw = dict(tol=tol, max_iter=cfg.ns_max_iter,
              power_iters=cfg.ns_power_iters)
    made = _probe_plain(monkeypatch)
    for M, X0, band in seen:
        X, kt = inv.ns_inverse(M, X0, band=band, **kw), made[-1].kt
        X_ref, k_ref = _reference(M, X0, **kw)
        assert torch.equal(kt, k_ref)
        assert float((X - X_ref).abs().max()) <= 1e-12
    assert len(made) == len(seen)


def test_coarse_phase_matches_the_per_lane_loop(flagship, monkeypatch):
    _, seen = flagship
    M, X0, band = seen[-1]
    kw = dict(tol=1e-9, max_iter=25, power_iters=8, coarse=True)
    made = _probe_plain(monkeypatch)
    X = inv.ns_inverse(M, X0, band=band, **kw)
    X_ref, k_ref = _reference(M, X0, **kw)
    assert torch.equal(made[0].kt, k_ref)
    assert float((X - X_ref).abs().max()) <= 1e-12


@pytest.mark.parametrize("tol", [1e-4, 1e-10])
def test_fixed_launch_plan_equals_early_exit(flagship, monkeypatch, tol):
    """The card's plan (every phase runs its max_iter iterations, stopped
    lanes untouched) against the CPU's early exit, bit for bit; the fixed
    plan makes one host read a refresh."""
    _, seen = flagship
    made = _probe_plain(monkeypatch)
    for M, X0, band in seen:
        kw = dict(tol=tol, max_iter=25, power_iters=4, band=band)
        early = inv.ns_inverse(M, X0, **kw)
        profiling.reset()
        fixed = _refresh(M, X0, reads=False, **kw)
        assert profiling.counters()["host.syncs.qp.ns"] == 1
        assert torch.equal(fixed, early)
        assert torch.equal(made[-1].kt, made[-2].kt)
        assert int(made[-1].kt.max()) < 25      # lanes stopped early


def test_derived_band_holds_the_flagship_system(flagship):
    """The block band the solver derives (K = 2 window steps, joint_vel
    coupling neighbours: hb = 1) bounds M's nonzeros on every refresh, and
    the banded residual equals the dense one there."""
    nlp, seen = flagship
    plan_D, plan_K = nlp.block[1], 2
    assert nlp_mod.block_half_band(nlp, plan_D, plan_K) == 1
    for M, X0, band in seen:
        assert band == (plan_D, 1)
        n = M.shape[-1]
        step = torch.arange(n) // plan_D
        outside = (step[:, None] - step[None, :]).abs() > 1
        assert bool((M[:, outside] == 0).all())
        assert bool((M[:, ~outside] != 0).any())
        dense = M @ X0
        assert float((inv.band_mm(M, X0, band) - dense).abs().max()) \
            <= 1e-12 * float(dense.abs().max())


@pytest.mark.parametrize("deriv,hb", [("pos", 1), ("vel", 1), ("acc", 2),
                                      ("jerk", 3)])
def test_cost_band_widens_the_derived_band(deriv, hb):
    """A squared joint cost states its rows' columns; a wider stencil
    widens the band (K = 2), and its Jacobian is zero outside the stated
    columns."""
    T, D = 6, 3
    t = joint.joint_term(deriv, True, T, D)
    nlp = Nlp(n=T * D, term_sets=(t,), block=(T, D))
    assert nlp_mod.block_half_band(nlp, D, 2) == hb
    x = torch.randn(1, T * D, dtype=torch.float64)
    J = torch.func.jacrev(lambda v: t.fn(v, {}))(x)[0, :, 0]
    cols = np.arange(T * D)[None, :]
    starts, width = np.asarray(t.jac_band[0])[:, None], t.jac_band[1]
    outside = (cols < starts) | (cols >= starts + width)
    assert bool((J[torch.as_tensor(outside)] == 0).all())


def test_unstated_or_full_costs_take_the_dense_band():
    T, D = 4, 2

    def fn(x, p):
        return x[:, :2] * x[:, -2:]

    sq = TermSet("user_sq", Kind.COST_SQ, fn, 2)
    full = TermSet("full", Kind.COST_GENERIC_FULL,
                   lambda x, p: (x * x).sum(-1, keepdim=True), 1)
    diag = TermSet("diag", Kind.COST_GENERIC_DIAG,
                   lambda x, p: (x * x).sum(-1, keepdim=True), 1)
    for sets, want in (((sq,), None), ((full,), None), ((diag,), 1)):
        nlp = Nlp(n=T * D, term_sets=sets, block=(T, D))
        assert nlp_mod.block_half_band(nlp, D, 2) == want


def test_dense_band_equals_the_derived_band(flagship):
    _, seen = flagship
    M, X0, band = seen[0]
    kw = dict(tol=1e-10, max_iter=25, power_iters=4)
    banded = inv.ns_inverse(M, X0, band=band, **kw)
    dense = inv.ns_inverse(M, X0, band=None, **kw)
    assert float((banded - dense).abs().max()) <= 1e-12


@pytest.mark.parametrize("reads", [True, False])
def test_bad_lane_takes_the_rescue(flagship, monkeypatch, reads):
    """A lane whose seed is NaN fails the rescue test and restarts from
    (target / ||M||_F) I; the others are untouched by the rescue.  Result
    and per-lane iterations as the per-lane loop's; the counters hold the
    iterations of both."""
    _, seen = flagship
    M, X0, band = seen[0]
    X0 = X0.clone()
    X0[1] = float("nan")
    kw = dict(tol=1e-8, max_iter=25, power_iters=4)
    made = _probe_plain(monkeypatch)
    profiling.reset()
    X = _refresh(M, X0, band=band, reads=reads, **kw)
    got = profiling.counters()
    X_ref, k_ref = _reference(M, X0, **kw)
    assert torch.isfinite(X).all()
    assert float((X - X_ref).abs().max()) <= 1e-12
    eye = torch.eye(M.shape[-1], dtype=M.dtype)
    r = torch.linalg.matrix_norm(eye - M @ X)
    assert bool((r <= 1e-8).all())
    # the rescue counts its own iterations (kt restarts); the NaN seed
    # stopped the lane's phase after one
    assert int(made[0].kt[1]) == int(k_ref[1]) - 1 > 0
    assert int(made[0].kt[0]) == int(made[0].kt[2]) == 0
    assert got["qp.ns.lane_iters"] == int(k_ref.sum())
    assert got["qp.ns.lane_refreshes"] == M.shape[0]
    if not reads:           # the refresh's read and one rescue group's
        assert got["host.syncs.qp.ns"] == 2


def test_counters_of_a_refresh(flagship):
    """lane_iters is the lanes' iterations, lane_slots the lanes times the
    iterations launched (the fixed plan: every phase's max_iter)."""
    _, seen = flagship
    M, X0, band = seen[0]
    B = M.shape[0]
    kw = dict(tol=1e-4, max_iter=25, power_iters=4, band=band)
    _, k_ref = _reference(M, X0, tol=1e-4, max_iter=25, power_iters=4)
    profiling.reset()
    _refresh(M, X0, reads=False, **kw)
    got = profiling.counters()
    assert got["qp.ns.lane_iters"] == int(k_ref.sum()) > 0
    assert got["qp.ns.lane_refreshes"] == B
    assert got["qp.ns.lane_slots"] == B * 25
    assert got.get("qp.ns.launches", 0) == 0       # plain on the CPU
    profiling.reset()
    inv.ns_inverse(M, X0, **kw)
    got = profiling.counters()
    assert got["qp.ns.lane_slots"] == B * int(k_ref.max())
    assert got["host.syncs.qp.ns"] == int(k_ref.max()) + 1
