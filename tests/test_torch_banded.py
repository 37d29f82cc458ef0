"""Port parity for the gather-banded QP path: ``qp/banded.py``,
``qp/admm_structured.py`` and the SQP driver's gather-banded branch
(``structured=True`` where the row windows are not step-aligned), against
the JAX package in float64 on the CPU, on numpy-seeded inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.qp import banded as jbd
from trajopt_tpu.qp.admm import ADMMConfig as JaxADMMConfig
from trajopt_tpu.qp.admm_structured import StructuredQP as JaxStructuredQP
from trajopt_tpu.qp.admm_structured import \
    solve_qp_structured as jax_solve_qp_structured
from trajopt_tpu.sqp import nlp as jnlp
from trajopt_tpu.sqp.params import SQPParams as JaxSQPParams
from trajopt_tpu.sqp.solver import make_solver as jax_make_solver
from trajopt_tpu_torch.qp import banded as bd
from trajopt_tpu_torch.qp import block_banded as bb
from trajopt_tpu_torch.qp.admm import ADMMConfig
from trajopt_tpu_torch.qp.admm_structured import (StructuredQP,
                                                  solve_qp_structured)
from trajopt_tpu_torch.sqp import nlp as tnlp
from trajopt_tpu_torch.sqp.params import SQPParams, SQPStatus
from trajopt_tpu_torch.sqp.solver import make_solver

torch.set_num_threads(2)

INF = float("inf")
B = 3


def _banded(seed, m=11, n=20, w=5):
    """Per-lane window weights W [B, m, w] and shared starts [m]; the
    last row starts at n - 2, so its window is clamped to the last
    column (zero weights there, as ``tests/test_banded.py`` sets them)."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((B, m, w))
    starts = rng.integers(0, n - w + 1, size=m)
    starts[-1] = n - 2
    W[:, -1, 2:] = 0.0
    return W, starts, n


def test_banded_ops_match_jax():
    W, starts, n = _banded(0)
    rng = np.random.default_rng(1)
    m = W.shape[1]
    x = rng.standard_normal((B, n))
    y = rng.standard_normal((B, m))
    rho = rng.uniform(0.5, 2.0, (B, m))
    e = rng.uniform(0.5, 2.0, (B, m))
    d = rng.uniform(0.5, 2.0, (B, n))
    tm = bd.make_banded(torch.as_tensor(W), starts, n)
    assert (tm.m, tm.w, tm.n) == (m, 5, n)

    def jax_ops(Wl, xl, yl, rl, el, dl):
        jm = jbd.make_banded(Wl, starts, n)
        return (jbd.matvec(jm, xl), jbd.rmatvec(jm, yl), jbd.to_dense(jm),
                jbd.at_r_a(jm, rl), jbd.row_inf_norms(jm),
                jbd.col_inf_norms(jm), jbd.scale_rows(jm, el).W,
                jbd.scale_cols(jm, dl).W)

    ref = jax.vmap(jax_ops)(*map(jnp.asarray, (W, x, y, rho, e, d)))
    t = [torch.as_tensor(v) for v in (x, y, rho, e, d)]
    got = (bd.matvec(tm, t[0]), bd.rmatvec(tm, t[1]), bd.to_dense(tm),
           bd.at_r_a(tm, t[2]), bd.row_inf_norms(tm), bd.col_inf_norms(tm),
           bd.scale_rows(tm, t[3]).W, bd.scale_cols(tm, t[4]).W)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-12)
    dense = bd.to_dense(tm).numpy()
    np.testing.assert_allclose(bd.matvec(tm, t[0]).numpy(),
                               np.einsum("bmn,bn->bm", dense, x), atol=1e-12)
    np.testing.assert_allclose(dense[:, -1, n - 2:], W[:, -1, :2])


CFG = dict(eps_abs=1e-9, eps_rel=1e-9, max_iter=5000, adaptive_rho=False)


def _structured_qps(seed, n=24, m=15, w=6):
    """``tests/test_admm_structured.py``'s random structured QPs, per
    lane: SPD P, banded rows (30 % hard, the rest weight 5) and a box."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n)) * 0.3
    P = G @ G.transpose(0, 2, 1) + 0.2 * np.eye(n)
    q = rng.standard_normal((B, n))
    W = rng.standard_normal((B, m, w))
    starts = rng.integers(0, n - w + 1, size=m)
    ctr = rng.standard_normal((B, m))
    c = np.where(rng.uniform(size=(B, m)) < 0.3, INF, 5.0)
    lb = rng.standard_normal((B, n)) - 2.0
    ub = rng.standard_normal((B, n)) + 2.0
    return (P, q, W, ctr - 0.4, ctr + 0.4, c, lb, ub), starts


def test_solve_qp_structured_matches_jax():
    """A fresh solve and one warm-started from it: equal iteration counts
    and convergence, x, z and y within 1e-9 (measured 7.2e-15)."""
    (P, q, W, l, u, c, lb, ub), starts = _structured_qps(4)
    n, m = P.shape[-1], W.shape[1]
    jcfg = JaxADMMConfig(**CFG)

    def jax_pair(*a):
        qp = JaxStructuredQP(a[0], a[1], jbd.make_banded(a[2], starts, n),
                             *a[3:])
        r1 = jax_solve_qp_structured(qp, jnp.zeros(n), cfg=jcfg)
        r2 = jax_solve_qp_structured(qp, r1.x, zc0=r1.z[:m], zb0=r1.z[m:],
                                     yc0=r1.y[:m], yb0=r1.y[m:], cfg=jcfg)
        return r1, r2

    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(jax_pair))(
        *map(jnp.asarray, (P, q, W, l, u, c, lb, ub))))
    t = [torch.as_tensor(v) for v in (P, q, W, l, u, c, lb, ub)]
    qp = StructuredQP(t[0], t[1], bd.make_banded(t[2], starts, n), *t[3:])
    cfg = ADMMConfig(**CFG)
    r1 = solve_qp_structured(qp, torch.zeros(B, n, dtype=torch.float64),
                             cfg=cfg)
    r2 = solve_qp_structured(qp, r1.x, zc0=r1.z[:, :m], zb0=r1.z[:, m:],
                             yc0=r1.y[:, :m], yb0=r1.y[:, m:], cfg=cfg)
    for got, want in zip((r1, r2), ref):
        assert want.converged.all()
        np.testing.assert_array_equal(got.iters.numpy(), want.iters)
        np.testing.assert_array_equal(got.converged.numpy(), want.converged)
        for name in ("x", "z", "y"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       getattr(want, name), rtol=0,
                                       atol=1e-9, err_msg=name)
    assert (ref[1].iters <= ref[0].iters).all()         # the warm start


def _gather_nlp(mod):
    """A 3-step, 2-dof problem whose constraint and penalty rows start at
    odd columns (not step-aligned): an equality across steps 0-1, a
    nonlinear ring inequality across steps 1-2 and an abs penalty, beside
    a squared pull to per-lane targets ``params["t"]``."""
    jax_side = mod is jnlp
    K = mod.Kind
    if jax_side:
        def cols(x, a, b):
            return x[a:b]

        def band(fn):
            return lambda x, p: fn(x)[None, :]

        def row(v):
            return jnp.atleast_1d(v)

        sign = jnp.array([1.0, -1.0])
    else:
        def cols(x, a, b):
            return x[:, a:b]

        def band(fn):
            return lambda x, p: fn(x)[:, None, :]

        def row(v):
            return v[:, None]

        sign = torch.tensor([1.0, -1.0], dtype=torch.float64)

    def s(x, i):
        return cols(x, i, i + 1)[..., 0]

    sets = (
        mod.TermSet("pull", K.COST_SQ, lambda x, p: 0.7 * (x - p["t"]), 6),
        mod.TermSet("link", K.CNT_EQ,
                    lambda x, p: row(s(x, 1) + s(x, 2) - 1.0), 1,
                    banded_jac=band(lambda x: cols(x, 1, 3) * 0.0 + 1.0),
                    band_starts=np.array([1]), band_width=2),
        mod.TermSet("ring", K.CNT_INEQ,
                    lambda x, p: row(0.5 - s(x, 3) ** 2 - s(x, 4) ** 2), 1,
                    banded_jac=band(lambda x: -2.0 * cols(x, 3, 5)),
                    band_starts=np.array([3]), band_width=2),
        mod.TermSet("abs", K.COST_ABS,
                    lambda x, p: row(s(x, 4) - s(x, 5) + 0.3), 1,
                    weight_fn=lambda p: 2.0,
                    banded_jac=band(lambda x: cols(x, 4, 6) * 0.0 + sign),
                    band_starts=np.array([4]), band_width=2))
    return mod.Nlp(n=6, term_sets=sets, block=(3, 2))


def test_gather_banded_solve_matches_jax():
    """The solver's gather-banded branch on a problem whose row windows
    are not step-aligned (the block plan refuses it, so JAX falls back
    too): equal status and counts, x within 1e-6 (measured 3.3e-16)."""
    nlp = _gather_nlp(tnlp)
    starts, w = tnlp.structured_band(nlp)
    with pytest.raises(ValueError, match="step-aligned"):
        bb.make_plan(starts, w, *nlp.block)
    rng = np.random.default_rng(5)
    x0 = rng.uniform(-0.5, 0.5, (B, 6))
    t = rng.uniform(-0.6, 0.6, (B, 6))
    lb, ub = np.full((B, 6), -2.0), np.full((B, 6), 2.0)
    fields = dict(initial_merit_error_coeff=0.1,
                  rescale_duals_on_escalation=True)

    jsolve = jax_make_solver(_gather_nlp(jnlp), sqp=dataclasses.replace(
        JaxSQPParams(), **fields), structured=True)
    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda a, b, c, d: jsolve(a, b, c, {"t": d})))(
            *map(jnp.asarray, (x0, lb, ub, t))))
    assert (ref.status == SQPStatus.CONVERGED).all()
    assert (ref.merit_coeffs.max(-1) > 0.1).all()       # escalated

    solve = make_solver(nlp, dataclasses.replace(SQPParams(), **fields),
                        structured=True)
    res = solve(*(torch.as_tensor(v) for v in (x0, lb, ub)),
                {"t": torch.as_tensor(t)})
    np.testing.assert_array_equal(res.status.numpy(), ref.status)
    np.testing.assert_array_equal(res.n_iter.numpy(), ref.n_iter)
    np.testing.assert_array_equal(res.n_qp_solves.numpy(), ref.n_qp_solves)
    np.testing.assert_array_equal(res.n_func_evals.numpy(),
                                  ref.n_func_evals)
    np.testing.assert_allclose(res.merit_coeffs.numpy(), ref.merit_coeffs,
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(res.x.numpy(), ref.x, rtol=0, atol=1e-6)
    # without a (T, D) layout the solver takes the same gather-banded path
    flat = make_solver(dataclasses.replace(nlp, block=None),
                       dataclasses.replace(SQPParams(), **fields),
                       structured=True)
    again = flat(*(torch.as_tensor(v) for v in (x0, lb, ub)),
                 {"t": torch.as_tensor(t)})
    for a, b in zip(res, again):
        assert torch.equal(a, b)
