"""Port parity: the block-banded QP of ``trajopt_tpu_torch`` against the
JAX package, float64 on the CPU.

* The fused chunk's plain version (``qp/fused_block.py``) against the JAX
  ``_build_chunk_fn`` called unbatched (its XLA path) and vmapped (the
  Pallas kernel in interpret mode, as tests/test_pallas_block.py runs it),
  with the slot-major layout converted here.
* ``prepare_qp_block`` + ``solve_qp_block_prepared`` on a QP captured from
  a 10-step pr2ish convexification (Cholesky and Newton-Schulz inverses),
  and on the escalated-penalty toy of
  tests/test_qp_admm.py::test_rho_dual_scale_beats_dual_starvation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.qp import admm_block as jab
from trajopt_tpu.qp import block_banded as jbb
from trajopt_tpu.qp.admm import ADMMConfig as JaxADMMConfig
from trajopt_tpu.qp.pallas_block import _build_chunk_fn, pack_wk
from trajopt_tpu_torch.models.benchmarks import (pr2ish_table_batch,
                                                 pr2ish_table_problem)
from trajopt_tpu_torch.qp import admm_block as tab
from trajopt_tpu_torch.qp import block_banded as tbb
from trajopt_tpu_torch.qp import fused_block as fb
from trajopt_tpu_torch.qp.admm import ADMMConfig
from trajopt_tpu_torch.sqp import nlp as nlp_mod
from trajopt_tpu_torch.sqp.solver import block_qp

torch.set_num_threads(2)

T, D, K, R, B = 4, 2, 2, 3, 5
SIGMA, ALPHA, RHO_B, N_ITERS = 1e-6, 1.6, 0.1, 40
CHUNK_TOL = 1e-10


def _chunk_inputs(seed=0):
    """Seeded chunk operands in the port's layout (float64 numpy): SPD P,
    M^-1 of the matching x-update system, hard / penalty / inert rows."""
    rng = np.random.default_rng(seed)
    n, m, KD = T * D, T * R, K * D
    live = np.zeros((T, R), bool)
    live[:T - K + 1, :2] = True
    Wb = rng.standard_normal((B, T, R, KD)) * live[None, :, :, None]
    live = live.reshape(-1)
    hard = live & (np.arange(m) % R == 0)
    bnd = rng.standard_normal((B, m))
    lc = np.where(live & (np.arange(m) % 2 == 0), bnd, -np.inf)
    uc = np.where(live, bnd, np.inf)
    c = np.where(hard, np.inf, np.where(live, rng.uniform(1, 50, (B, m)),
                                        0.0))
    rho_c = np.full((B, m), 0.1)
    cr = np.where(np.isinf(c), np.inf, c / rho_c)
    A = rng.standard_normal((B, n, n))
    P = A @ A.transpose(0, 2, 1) / n + np.eye(n)
    bd = rng.uniform(0.5, 1.5, (B, n))
    plan = tbb.BlockPlan(T=T, D=D, K=K, R=R, m=0, w=KD,
                         blk_index=np.zeros(0, np.int64),
                         scatter_idx=np.zeros(0, np.int64))
    Wt = torch.as_tensor(Wb)
    M = (torch.as_tensor(P) + SIGMA * torch.eye(n)
         + tbb.at_r_a(tbb.BlockBanded(Wt, plan), torch.as_tensor(rho_c))
         + torch.diag_embed(torch.as_tensor(RHO_B * bd * bd)))
    x = rng.standard_normal((B, n)) * 0.1
    ops = dict(
        Minv=torch.linalg.inv(M).numpy(), Wb=Wb, P=P,
        q=rng.standard_normal((B, n)), lc=lc, uc=uc, cr=cr, rho_c=rho_c,
        lb=-rng.uniform(0.1, 1, (B, n)), ub=rng.uniform(0.1, 1, (B, n)),
        bd=bd, Ec=rng.uniform(0.5, 2, (B, m)), Eb=rng.uniform(0.5, 2, (B, n)),
        Dd=rng.uniform(0.5, 2, (B, n)), cobj=rng.uniform(0.5, 2, (B,)),
        x=x, zc=tbb.matvec_wb(Wt, torch.as_tensor(x), D).numpy(),
        zb=bd * x, yc=rng.standard_normal((B, m)) * 0.01 * live,
        yb=np.zeros((B, n)))
    return ops


def _port_chunk(ops):
    args = [torch.as_tensor(ops[k]) for k in fb._ARG_NAMES]
    state, stats = fb.chunk_plain(*args, D=D, sigma=SIGMA, alpha=ALPHA,
                                  rho_b=RHO_B, n_iters=N_ITERS)
    return [v.numpy() for v in (*state, *stats)]


def _jax_args(ops):
    """The JAX kernel's operands per lane: Wk [K, R, n] layers and [R, T]
    slot-major row vectors."""
    jplan = jbb.BlockPlan(T=T, D=D, K=K, R=R, m=0, w=K * D,
                          blk_index=np.zeros(0, np.int32),
                          scatter_idx=np.zeros(0, np.int32))

    def slot(v):
        return jnp.asarray(v).reshape(B, T, R).transpose(0, 2, 1)

    Wk = jax.vmap(lambda w: pack_wk(w, jplan))(jnp.asarray(ops["Wb"]))
    return [jnp.asarray(ops["Minv"]), Wk, jnp.asarray(ops["P"]),
            jnp.asarray(ops["q"]), slot(ops["lc"]), slot(ops["uc"]),
            slot(ops["cr"]), slot(ops["rho_c"]), jnp.asarray(ops["lb"]),
            jnp.asarray(ops["ub"]), jnp.asarray(ops["bd"]), slot(ops["Ec"]),
            jnp.asarray(ops["Eb"]), jnp.asarray(ops["Dd"]),
            jnp.asarray(ops["cobj"]).reshape(B, 1), jnp.asarray(ops["x"]),
            slot(ops["zc"]), jnp.asarray(ops["zb"]), slot(ops["yc"]),
            jnp.asarray(ops["yb"])]


def _from_jax(out):
    """JAX chunk outputs (batched) -> the port's layout."""
    x, zc3, zb, yc3, yb, *stats = (np.asarray(v) for v in out)

    def rows(v3):
        return v3.transpose(0, 2, 1).reshape(v3.shape[0], -1)

    return [x, rows(zc3), zb, rows(yc3), yb,
            *(s.reshape(-1) for s in stats)]


@pytest.mark.parametrize("mode", ["unbatched", "vmapped"])
def test_chunk_plain_matches_jax(mode):
    ops = _chunk_inputs()
    fn = _build_chunk_fn(T, D, K, R, N_ITERS, SIGMA, ALPHA, RHO_B, 2, True)
    args = _jax_args(ops)
    if mode == "unbatched":    # XLA path, lane by lane
        outs = [fn(*(a[b] for a in args)) for b in range(B)]
        out = [np.stack([np.asarray(o[i]) for o in outs])
               for i in range(10)]
    else:                      # Pallas kernel (interpret), sub_batch 2
        out = jax.vmap(fn)(*args)
    got = _port_chunk(ops)
    for a, b in zip(got, _from_jax(out)):
        np.testing.assert_allclose(a, b, rtol=0, atol=CHUNK_TOL)


def test_chunk_nan_lane_reads_not_converged():
    ops = _chunk_inputs(1)
    ops["q"][2, 3] = np.nan
    got = _port_chunk(ops)
    pri, dua = got[5], got[6]
    assert np.isnan(pri[2]) and np.isnan(dua[2])
    assert np.isfinite(np.delete(pri, 2)).all()


def test_chunk_inactive_lanes_keep_state():
    ops = _chunk_inputs(2)
    args = [torch.as_tensor(ops[k]) for k in fb._ARG_NAMES]
    active = torch.tensor([True, False, True, False, True])
    state, stats = fb.chunk(*args, D=D, sigma=SIGMA, alpha=ALPHA,
                            rho_b=RHO_B, n_iters=N_ITERS, active=active)
    full, _ = fb.chunk_plain(*args, D=D, sigma=SIGMA, alpha=ALPHA,
                             rho_b=RHO_B, n_iters=N_ITERS)
    for new, old, ref in zip(state, args[15:], full):
        assert torch.equal(new[~active], old[~active])
        assert torch.equal(new[active], ref[active])
    assert torch.isnan(stats.pri[~active]).all()


def test_chunk_cuda_refuses_cpu_tensors():
    """The kernel wrapper never falls back to the plain version."""
    args = [torch.as_tensor(v, dtype=torch.float32)
            for v in map(_chunk_inputs().get, fb._ARG_NAMES)]
    before = fb.COUNTER.launches
    with pytest.raises(ValueError, match="CUDA"):
        fb.chunk_cuda(*args, D=D, sigma=SIGMA, alpha=ALPHA, rho_b=RHO_B,
                      n_iters=1)
    assert fb.COUNTER.launches == before


def test_block_banded_helpers_match_jax():
    """make_plan / from_rows / to_block / from_block / matvec / rmatvec /
    norms / scaling / at_r_a / to_dense on rows with step-aligned windows,
    some overhanging the trajectory end."""
    rng = np.random.default_rng(4)
    Tn, Dn, w, m = 5, 3, 6, 11
    starts = rng.integers(0, Tn, m) * Dn
    plan_t = tbb.make_plan(starts, w, Tn, Dn)
    plan_j = jbb.make_plan(starts, w, Tn, Dn)
    assert (plan_t.T, plan_t.K, plan_t.R) == (plan_j.T, plan_j.K, plan_j.R)
    np.testing.assert_array_equal(plan_t.scatter_idx, plan_j.scatter_idx)
    W = rng.standard_normal((2, m, w))
    v = rng.standard_normal((2, m))
    x = rng.standard_normal((2, Tn * Dn))
    d = rng.uniform(0.5, 2, (2, Tn * Dn))
    C_t = tbb.from_rows(torch.as_tensor(W), plan_t)
    C_j = [jbb.from_rows(jnp.asarray(Wl), plan_j) for Wl in W]
    e = rng.uniform(0.5, 2, (2, plan_t.m_blk))

    def jax_rows(f):
        return np.stack([np.asarray(f(b)) for b in range(2)])

    pairs = [
        (C_t.Wb, jax_rows(lambda b: C_j[b].Wb)),
        (tbb.to_block(torch.as_tensor(v), plan_t, -1.0),
         jax_rows(lambda b: jbb.to_block(jnp.asarray(v[b]), plan_j, -1.0))),
        (tbb.from_block(tbb.to_block(torch.as_tensor(v), plan_t), plan_t), v),
        (tbb.matvec(C_t, torch.as_tensor(x)),
         jax_rows(lambda b: jbb.matvec(C_j[b], jnp.asarray(x[b])))),
        (tbb.rmatvec(C_t, torch.as_tensor(e)),
         jax_rows(lambda b: jbb.rmatvec(C_j[b], jnp.asarray(e[b])))),
        (tbb.row_inf_norms(C_t), jax_rows(lambda b: jbb.row_inf_norms(C_j[b]))),
        (tbb.col_inf_norms(C_t), jax_rows(lambda b: jbb.col_inf_norms(C_j[b]))),
        (tbb.scale_cols(tbb.scale_rows(C_t, torch.as_tensor(e)),
                        torch.as_tensor(d)).Wb,
         jax_rows(lambda b: jbb.scale_cols(jbb.scale_rows(
             C_j[b], jnp.asarray(e[b])), jnp.asarray(d[b])).Wb)),
        (tbb.at_r_a(C_t, torch.as_tensor(e)),
         jax_rows(lambda b: jbb.at_r_a(C_j[b], jnp.asarray(e[b])))),
        (tbb.to_dense(C_t), jax_rows(lambda b: jbb.to_dense(C_j[b]))),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=1e-12)


# ---------------------------------------------------------------- solves

QP_CFG = dict(eps_abs=2e-5, eps_rel=2e-5, max_iter=450, check_every=150,
              adaptive_rho=False, rho_dual_scale=0.1, ruiz_iters=10,
              ns_tol=1e-4, ns_power_iters=4)
SOLVE_TOL = 1e-9


def _captured_qp():
    """Block QP arrays (numpy, 3 lanes) captured from the port's
    convexification of pr2ish at 10 steps (held against JAX by
    tests/test_torch_slice.py), plus its plan and trust box."""
    prob, _ = pr2ish_table_problem(n_steps=10, lvs_substeps=2, device="cpu")
    nlp = prob.build()
    inits, goals = pr2ish_table_batch(3, 3, 10, device="cpu")
    rng = np.random.default_rng(3)
    x = inits.reshape(3, -1) + 0.02 * torch.as_tensor(
        rng.standard_normal((3, nlp.n)))
    params = {"goal": goals}
    model = nlp_mod.convexify_structured(
        nlp, x, params, nlp_mod.linear_jacobians(nlp, x, params))
    plan = tbb.make_plan(*nlp_mod.structured_band(nlp), *nlp.block)
    coeffs = torch.full((3, nlp_mod.num_cnt_groups(nlp)), 10.0)
    coeffs[1, ::2] = 1e3                     # an escalated lane
    qp = block_qp(nlp, plan, model, coeffs, x)
    lb, ub = prob.bounds(x)
    box = (torch.maximum(lb, x - 0.1), torch.minimum(ub, x + 0.1))
    arrays = dict(P=qp.P, q=qp.q, Wb=qp.C.Wb, l=qp.l, u=qp.u, c=qp.c,
                  x=x, lb=box[0], ub=box[1])
    return {k: v.numpy() for k, v in arrays.items()}, plan


def _port_prepare_solve(a, plan, cfg, minv0=None):
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    qp = tab.BlockQP(P=t["P"], q=t["q"], C=tbb.BlockBanded(t["Wb"], plan),
                     l=t["l"], u=t["u"], c=t["c"], lb=t["lb"], ub=t["ub"])
    prep = tab.prepare_qp_block(qp, cfg, minv0=minv0)
    return prep, tab.solve_qp_block_prepared(prep, t["lb"], t["ub"], t["x"],
                                             cfg=cfg)


def _jax_prepare_solve(a, plan, cfg, minv0=None):
    jplan = jbb.BlockPlan(*plan)

    def one(P, q, Wb, l, u, c, x, lb, ub, m0):
        qp = jab.BlockQP(P=P, q=q, C=jbb.BlockBanded(Wb, jplan), l=l, u=u,
                         c=c, lb=lb, ub=ub)
        prep = jab.prepare_qp_block(qp, cfg, minv0=m0)
        return prep, jab.solve_qp_block_prepared(prep, lb, ub, x, cfg=cfg)

    keys = ("P", "q", "Wb", "l", "u", "c", "x", "lb", "ub")
    ops = [jnp.asarray(a[k]) for k in keys]
    if minv0 is None:
        return jax.jit(jax.vmap(lambda *v: one(*v, None)))(*ops)
    return jax.jit(jax.vmap(one))(*ops, jnp.asarray(minv0))


def _assert_results_match(res_t, res_j):
    for name in ("x", "z", "y", "pri_res", "dua_res"):
        np.testing.assert_allclose(getattr(res_t, name).numpy(),
                                   np.asarray(getattr(res_j, name)),
                                   rtol=SOLVE_TOL, atol=SOLVE_TOL,
                                   err_msg=name)
    np.testing.assert_array_equal(res_t.iters.numpy(), np.asarray(res_j.iters))
    np.testing.assert_array_equal(res_t.converged.numpy(),
                                  np.asarray(res_j.converged))


def test_prepare_and_solve_match_jax_on_pr2ish_qp():
    a, plan = _captured_qp()
    cfg_t, cfg_j = ADMMConfig(**QP_CFG), JaxADMMConfig(**QP_CFG)
    prep_t, res_t = _port_prepare_solve(a, plan, cfg_t)
    prep_j, res_j = _jax_prepare_solve(a, plan, cfg_j)
    np.testing.assert_allclose(prep_t.Minv.numpy(), np.asarray(prep_j.Minv),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(prep_t.sq.C.Wb.numpy(),
                               np.asarray(prep_j.sq.C.Wb), rtol=1e-12,
                               atol=1e-12)
    _assert_results_match(res_t, res_j)
    assert res_t.converged.any()

    # Newton-Schulz refresh from the Cholesky inverse after escalating
    # every lane's merit coefficients (the solver's carried inverse).
    a2 = dict(a, c=np.where(np.isinf(a["c"]), a["c"], a["c"] * 10.0))
    prep2_t, res2_t = _port_prepare_solve(a2, plan, cfg_t,
                                          minv0=prep_t.Minv)
    prep2_j, res2_j = _jax_prepare_solve(a2, plan, cfg_j,
                                         minv0=np.asarray(prep_j.Minv))
    np.testing.assert_allclose(prep2_t.Minv.numpy(),
                               np.asarray(prep2_j.Minv), rtol=1e-9,
                               atol=1e-9)
    _assert_results_match(res2_t, res2_j)


@pytest.mark.parametrize("rho_dual_scale", [0.0, 0.1])
def test_dual_starvation_toy_matches_jax(rho_dual_scale):
    """min 0.5 x^2 + 1e5 hinge(1 - x)  s.t. x <= 0.5 (hard row), box
    |x| <= 10, as a one-step block QP; fixed rho stalls, the dual-scale
    rescale converges to x = 0.5 -- in both packages alike."""
    inf = np.inf
    plan = tbb.make_plan(np.zeros(2, np.int64), 1, 1, 1)
    a = dict(P=np.eye(1)[None], q=np.zeros((1, 1)),
             Wb=np.ones((1, 1, 2, 1)), l=np.array([[1.0, -inf]]),
             u=np.array([[inf, 0.5]]), c=np.array([[1e5, inf]]),
             x=np.zeros((1, 1)), lb=np.full((1, 1), -10.0),
             ub=np.full((1, 1), 10.0))
    kw = dict(adaptive_rho=False, max_iter=1000, check_every=50,
              eps_abs=1e-9, eps_rel=1e-9, rho_dual_scale=rho_dual_scale)
    _, res_t = _port_prepare_solve(a, plan, ADMMConfig(**kw))
    _, res_j = _jax_prepare_solve(a, plan, JaxADMMConfig(**kw))
    _assert_results_match(res_t, res_j)
    if rho_dual_scale:
        assert bool(res_t.converged[0])
        assert abs(float(res_t.x[0, 0]) - 0.5) < 1e-4
    else:
        assert abs(float(res_t.x[0, 0]) - 0.5) > 0.2
