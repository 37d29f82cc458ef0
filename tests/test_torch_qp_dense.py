"""Port parity: the dense QP of ``trajopt_tpu_torch`` against the JAX
package, float64 on the CPU.

* ``ruiz_equilibrate`` and ``solve_qp`` on seeded QPs with hard, soft,
  equality and free rows, in three configurations: fixed rho, adaptive rho
  (per-chunk refactorization) and Anderson acceleration.
* The fused chunk's plain version (``qp/fused_dense.py``) against the JAX
  Pallas kernel itself (``qp/pallas_admm.py``, run in interpret mode) and
  against the ``use_pallas=False`` iteration of ``solve_qp``.
* A lane with a planted NaN stays in its own lane.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.qp import admm as jadmm
from trajopt_tpu.qp import pallas_admm
from trajopt_tpu_torch.qp import admm as tadmm
from trajopt_tpu_torch.qp import fused_dense as fd

torch.set_num_threads(2)

B, N, M_C = 4, 12, 14          # lanes, variables, constraint rows
SIGMA, ALPHA = 1e-6, 1.6


def _qp(seed=0):
    """Seeded batched QPs (numpy, float64): SPD P; 14 constraint rows --
    3 hard inequalities, 2 hard equalities, 4 soft (finite c) inequalities,
    3 soft equalities, 2 free rows (l = -inf, u = +inf, c = inf) -- then N
    hard box rows.  The hard rows hold at a feasible point inside the
    box."""
    rng = np.random.default_rng(seed)
    n, m = N, M_C + N
    G = rng.standard_normal((B, n, n))
    P = G @ G.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    q = rng.standard_normal((B, n))
    Ac = rng.standard_normal((B, M_C, n)) * rng.uniform(0.2, 5, (B, M_C, 1))
    A = np.concatenate([Ac, np.broadcast_to(np.eye(n), (B, n, n))], 1)
    x_feas = rng.uniform(-0.5, 0.5, (B, n))
    ax = np.einsum("bmn,bn->bm", Ac, x_feas)
    kind = np.array([0] * 3 + [1] * 2 + [2] * 4 + [3] * 3 + [4] * 2)
    l = np.where(np.isin(kind, (1, 3)), ax, -np.inf)
    u = np.where(kind == 0, ax + rng.uniform(0.05, 0.3, (B, M_C)),
                 np.where(np.isin(kind, (1, 3)), ax,
                          np.where(kind == 2, ax - 0.2, np.inf)))
    c = np.where(np.isin(kind, (2, 3)), rng.uniform(1, 50, (B, M_C)),
                 np.inf)
    l = np.concatenate([l, np.full((B, n), -1.0)], 1)
    u = np.concatenate([u, np.full((B, n), 1.0)], 1)
    c = np.concatenate([c, np.full((B, n), np.inf)], 1)
    x0 = rng.uniform(-0.3, 0.3, (B, n))
    z0 = np.einsum("bmn,bn->bm", A, x0) + 0.01 * rng.standard_normal((B, m))
    y0 = 0.1 * rng.standard_normal((B, m))
    return [P, q, A, l, u, c], x0, z0, y0


CONFIGS = {
    "fixed_rho": dict(adaptive_rho=False),
    "adaptive_rho": dict(adaptive_rho=True),
    "anderson": dict(adaptive_rho=False, anderson=3, rho_dual_scale=0.1),
}


def _cfgs(name, **kw):
    common = dict(eps_abs=1e-9, eps_rel=1e-9, max_iter=400, check_every=25,
                  **CONFIGS[name])
    common.update(kw)
    return jadmm.ADMMConfig(**common), tadmm.ADMMConfig(**common)


def _jax_solve(data, x0, z0, y0, cfg):
    qp = jadmm.QPData(*(jnp.asarray(v) for v in data))
    f = jax.vmap(lambda p, a, b, c: jadmm.solve_qp(p, a, b, c, cfg=cfg))
    return jax.tree.map(np.asarray, f(qp, jnp.asarray(x0), jnp.asarray(z0),
                                      jnp.asarray(y0)))


def test_ruiz_equilibrate_matches_jax():
    data, _, _, _ = _qp(1)
    data[5][:, 4] = 7.0               # a soft row's weight transforms
    qp_j, sc_j = jax.vmap(lambda p: jadmm.ruiz_equilibrate(p, 10))(
        jadmm.QPData(*(jnp.asarray(v) for v in data)))
    qp_t, sc_t = tadmm.ruiz_equilibrate(
        tadmm.QPData(*(torch.as_tensor(v) for v in data)), 10)
    for a, b in zip((*qp_t, *sc_t), (*qp_j, *sc_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-13)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_solve_qp_matches_jax(name):
    """x, z and y within 1e-8 (float64; the two packages sum the dense
    products in another order, which over 400 iterations stays ~1e-13),
    equal iteration counts and convergence flags."""
    cfg_j, cfg_t = _cfgs(name)
    data, x0, z0, y0 = _qp(0)
    ref = _jax_solve(data, x0, z0, y0, cfg_j)
    got = tadmm.solve_qp(tadmm.QPData(*(torch.as_tensor(v) for v in data)),
                         torch.as_tensor(x0), torch.as_tensor(z0),
                         torch.as_tensor(y0), cfg=cfg_t)
    np.testing.assert_array_equal(got.iters.numpy(), ref.iters)
    np.testing.assert_array_equal(got.converged.numpy(), ref.converged)
    for f in ("x", "z", "y"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(ref, f),
                                   rtol=0, atol=1e-8, err_msg=f)
    # the residuals are differences of O(1) terms: iterates that agree to
    # ~1e-11 give residuals that agree to about that
    np.testing.assert_allclose(got.pri_res.numpy(), ref.pri_res, rtol=0,
                               atol=1e-9)
    # lanes stop at different chunks, so per-lane early exit is exercised
    assert ref.converged.any() and len(set(ref.iters.tolist())) > 1


def test_solve_qp_cold_start_matches_jax():
    """z0 = A x0 and y0 = 0 when no warm start is given."""
    cfg_j, cfg_t = _cfgs("adaptive_rho", max_iter=100)
    data, x0, _, _ = _qp(2)
    qp = jadmm.QPData(*(jnp.asarray(v) for v in data))
    ref = jax.tree.map(np.asarray, jax.vmap(
        lambda p, a: jadmm.solve_qp(p, a, cfg=cfg_j))(qp, jnp.asarray(x0)))
    got = tadmm.solve_qp(tadmm.QPData(*(torch.as_tensor(v) for v in data)),
                         torch.as_tensor(x0), cfg=cfg_t)
    np.testing.assert_array_equal(got.iters.numpy(), ref.iters)
    for f in ("x", "z", "y"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(ref, f),
                                   rtol=0, atol=1e-8, err_msg=f)


def _chunk_operands(seed=3, eq_boost=True):
    """(Minv, A, q, l, u, c, rho, x, z, y) float64 numpy, Minv made exactly
    symmetric (the Pallas body applies rhs @ Minv, admm_iter Minv @ rhs).
    ``eq_boost`` gives hard equality rows rho 100 (OSQP's boost)."""
    data, x0, z0, y0 = _qp(seed)
    P, q, A, l, u, c = data
    rho = np.where(np.isinf(c) & (u - l < 1e-10) & eq_boost, 100.0, 0.1)
    M = P + SIGMA * np.eye(N) + A.transpose(0, 2, 1) @ (rho[..., None] * A)
    Minv = np.linalg.solve(M, np.broadcast_to(np.eye(N), M.shape))
    Minv = 0.5 * (Minv + Minv.transpose(0, 2, 1))
    return [Minv, A, q, l, u, c, rho, x0, z0, y0]


def _plain(ops, n_iters):
    Minv, A, q, l, u, c, rho, x, z, y = (torch.tensor(v) for v in ops)
    return fd.chunk_plain(Minv, A, q, l, u, c / rho, rho, x, z, y,
                          sigma=SIGMA, alpha=ALPHA, n_iters=n_iters)


def test_chunk_plain_matches_pallas_kernel(monkeypatch):
    """The JAX Pallas kernel in interpret mode (the way this CPU runs it).
    Its three dots carry ``preferred_element_type=float32``, so every
    product is rounded to float32 even on float64 inputs, and the rounding
    grows with the conditioning of M: on operands without the rho boost of
    equality rows the two agree to ~1e-6 of the magnitude over 30
    iterations, held at 2e-5."""
    monkeypatch.setattr(pallas_admm.pl, "pallas_call", functools.partial(
        pallas_admm.pl.pallas_call, interpret=True))
    ops = _chunk_operands(eq_boost=False)
    ref = jax.vmap(functools.partial(
        pallas_admm.admm_chunk_pallas, sigma=SIGMA, alpha=ALPHA,
        n_iters=30))(*(jnp.asarray(v) for v in ops))
    got = _plain(ops, 30)
    for a, b in zip(got[:3], ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2e-5 * np.abs(b).max())


def test_chunk_plain_matches_admm_iter():
    """One chunk of ``solve_qp`` with ``use_pallas=False`` (its
    ``admm_iter`` loop) on an unscaled problem (``ruiz_iters=0``) with the
    JAX package's own factorization: the same float64 arithmetic, with the
    dense products summed in another order, to 1e-11 over 40 iterations
    on x and z, and 100x that on y (the dual update multiplies z's rounding
    by rho, 100 on equality rows)."""
    ops = _chunk_operands(4)
    Minv, A, q, l, u, c, rho, x0, z0, y0 = ops
    P = _qp(4)[0][0]
    cfg = jadmm.ADMMConfig(eps_abs=0.0, eps_rel=0.0, max_iter=40,
                           check_every=40, adaptive_rho=False, ruiz_iters=0)
    qp = jadmm.QPData(*(jnp.asarray(v) for v in (P, q, A, l, u, c)))
    ref = jax.vmap(lambda p, a, b, d: jadmm.solve_qp(p, a, b, d, cfg=cfg))(
        qp, jnp.asarray(x0), jnp.asarray(z0), jnp.asarray(y0))
    minv = jax.vmap(lambda p: jadmm._factor(p, cfg, jadmm._row_rho(
        p, cfg, jnp.asarray(1.0))))(qp)
    ops[0] = np.asarray(minv)
    got = _plain(ops, 40)
    for a, b, tol in zip(got[:3], (ref.x, ref.z, ref.y),
                         (1e-11, 1e-11, 1e-9)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=tol)


def test_planted_nan_stays_in_its_lane():
    """A NaN in one lane's q blows up that lane only (its x, z, y go NaN and
    it never reads as converged); the other lanes match a clean run
    exactly."""
    ops = _chunk_operands(5)
    bad = [v.copy() for v in ops]
    bad[2][1, 3] = np.nan
    clean, got = _plain(ops, 20), _plain(bad, 20)
    for a, b in zip(got, clean):
        keep = np.arange(B) != 1
        np.testing.assert_array_equal(a.numpy()[keep], b.numpy()[keep])
    assert torch.isnan(got[0][1]).all() and torch.isnan(got[2][1]).any()

    data, x0, z0, y0 = _qp(5)
    data[1][1, 3] = np.nan
    cfg = tadmm.ADMMConfig(eps_abs=1e-6, eps_rel=1e-6, max_iter=100,
                           check_every=25, adaptive_rho=True)
    res = tadmm.solve_qp(tadmm.QPData(*(torch.as_tensor(v) for v in data)),
                         torch.as_tensor(x0), torch.as_tensor(z0),
                         torch.as_tensor(y0), cfg=cfg)
    assert not bool(res.converged[1]) and int(res.iters[1]) == 100
    assert torch.isnan(res.x[1]).all()
    data[1][1, 3] = 0.0
    clean = tadmm.solve_qp(tadmm.QPData(*(torch.as_tensor(v) for v in data)),
                           torch.as_tensor(x0), torch.as_tensor(z0),
                           torch.as_tensor(y0), cfg=cfg)
    others = torch.arange(B) != 1
    for a, b in zip(res, clean):
        assert torch.equal(a[others], b[others])
    assert torch.isfinite(res.x[others]).all()


def test_chunk_skips_inactive_lanes():
    ops = [torch.as_tensor(v) for v in _chunk_operands(6)]
    Minv, A, q, l, u, c, rho, x, z, y = ops
    args = (Minv, A, q, l, u, c / rho, rho, x, z, y)
    active = torch.tensor([True, False, True, False])
    out = fd.chunk(*args, sigma=SIGMA, alpha=ALPHA, n_iters=5,
                   active=active)
    full = fd.chunk(*args, sigma=SIGMA, alpha=ALPHA, n_iters=5)
    for new, old, ref in zip(out[:3], (x, z, y), full[:3]):
        assert torch.equal(new[~active], old[~active])
        assert torch.equal(new[active], ref[active])
    assert torch.isnan(out[3][~active]).all()
