"""Port on the card: the hand-written chunk kernels (block and dense), the
convex search kernel, the primitive narrowphase kernel and the
Newton-Schulz refresh kernels against their plain versions, the wrappers'
checks and launch counts, a small solve of each QP path (and a swept
problem on the dense path), the flagship's refreshes and solves with the
refresh's kernels against its plain version, the convex narrowphase and
an SDF grid's queries against the CPU, and captured regions against eager
runs.

The narrowphase kernels are also held on ragged query counts, shapes
outside the convex kernel's compile-time set, and a primitive call of
one group or an empty batch.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed (``--noconftest`` skips the JAX set-up of tests/conftest.py):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from trajopt_tpu_torch.collision import convex as tcvx
from trajopt_tpu_torch.collision import fused_convex as tfc
from trajopt_tpu_torch.collision import fused_primitive as tfp
from trajopt_tpu_torch.models.benchmarks import (arm_table_batch,
                                                 arm_table_problem,
                                                 flagship_params,
                                                 pr2ish_table_batch,
                                                 pr2ish_table_problem)
from trajopt_tpu_torch.qp import admm_block
from trajopt_tpu_torch.qp import block_banded as bb
from trajopt_tpu_torch.qp import fused_block as fb
from trajopt_tpu_torch.qp import fused_dense as fd
from trajopt_tpu_torch.qp import inverse as inv
from trajopt_tpu_torch.qp.inverse import cholesky_inverse
from trajopt_tpu_torch.qp.admm import ADMMConfig
from trajopt_tpu_torch.sqp.params import SQPParams, SQPStatus
from trajopt_tpu_torch.utils import aot_cache, profiling


def _count(name):
    """The registry's counter ``name`` (0 before its first count)."""
    return profiling.counters().get(name, 0)


pytestmark = pytest.mark.cuda

# (T, D, K, R, B) by the cluster size fused_block.cluster_plan gives: a
# small shape that takes one block per problem; the flagship's QP shape at
# a small batch (two); shapes whose n > 256 takes one thread a column in
# the rhs (four and eight); and the arm7 block path's QP shape (one), with
# D and R that are not multiples of 4.
SHAPES = {"cs1": (6, 3, 2, 5, 9), "cs2": (30, 8, 2, 40, 5),
          "cs4": (24, 16, 1, 10, 5), "cs8": (30, 16, 1, 10, 5),
          "arm7": (30, 7, 1, 15, 5)}
CLUSTER = {"cs1": 1, "cs2": 2, "cs4": 4, "cs8": 8, "arm7": 1}


def _kw(D):
    return dict(D=D, sigma=1e-6, alpha=1.6, rho_b=0.1, n_iters=60)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, seed=0, shape="cs1"):
    """Seeded float32 chunk operands with hard, penalty and inert rows (4
    live rows a step, the rest inert padding) and the live-row mask."""
    T, D, K, R, B = SHAPES[shape]
    rng = np.random.default_rng(seed)
    n, m, KD = T * D, T * R, K * D
    live = np.zeros((T, R), bool)
    live[:T - K + 1, :4] = True
    Wb = rng.standard_normal((B, T, R, KD)) * live[None, :, :, None]
    live = live.reshape(-1)
    bnd = rng.standard_normal((B, m))
    c = np.where(live & (np.arange(m) % R == 0), np.inf,
                 np.where(live, rng.uniform(1, 50, (B, m)), 0.0))
    rho_c = np.full((B, m), 0.1)
    A = rng.standard_normal((B, n, n))
    P = A @ A.transpose(0, 2, 1) / n + np.eye(n)
    bd = rng.uniform(0.5, 1.5, (B, n))
    f64 = dict(dtype=torch.float64, device=dev)
    Wt = torch.as_tensor(Wb, **f64)
    plan = bb.BlockPlan(T=T, D=D, K=K, R=R, m=0, w=KD,
                        blk_index=np.zeros(0, np.int64),
                        scatter_idx=np.zeros(0, np.int64))
    M = (torch.as_tensor(P, **f64) + 1e-6 * torch.eye(n, **f64)
         + bb.at_r_a(bb.BlockBanded(Wt, plan), torch.as_tensor(rho_c, **f64))
         + torch.diag_embed(torch.as_tensor(0.1 * bd * bd, **f64)))
    x = torch.as_tensor(rng.standard_normal((B, n)) * 0.1, **f64)
    ops = [torch.linalg.inv(M), Wt, torch.as_tensor(P, **f64),
           rng.standard_normal((B, n)),
           np.where(live & (np.arange(m) % 2 == 0), bnd, -np.inf),
           np.where(live, bnd, np.inf),
           np.where(np.isinf(c), np.inf, c / rho_c), rho_c,
           -rng.uniform(0.1, 1, (B, n)), rng.uniform(0.1, 1, (B, n)), bd,
           rng.uniform(0.5, 2, (B, m)), rng.uniform(0.5, 2, (B, n)),
           rng.uniform(0.5, 2, (B, n)), rng.uniform(0.5, 2, (B,)),
           x, bb.matvec_wb(Wt, x, D), torch.as_tensor(bd, **f64) * x,
           rng.standard_normal((B, m)) * 0.01 * live, np.zeros((B, n))]
    return [torch.as_tensor(v, dtype=torch.float32, device=dev).contiguous()
            for v in ops], torch.as_tensor(live, device=dev)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_matches_plain_version(cuda, shape):
    args, live = _inputs(cuda, shape=shape)
    assert fb.cluster_plan(*SHAPES[shape][:4])[0] == CLUSTER[shape]
    KW = _kw(SHAPES[shape][1])
    args[3][4, 2] = float("nan")                 # a blown-up lane
    before = _count("qp.block_chunk.launches")
    got = fb.chunk_cuda(*args, **KW)
    assert _count("qp.block_chunk.launches") == before + 1
    ref = fb.chunk_plain(*[a.double() for a in args], **KW)
    plain = fb.chunk_plain(*args, **KW)
    for g, r, p in zip((*got[0], *got[1]), (*ref[0], *ref[1]),
                       (*plain[0], *plain[1])):
        assert torch.equal(torch.isnan(g), torch.isnan(r))
        ok = ~torch.isnan(r)
        err_k = (g[ok].double() - r[ok]).abs().max()
        err_p = (p[ok].double() - r[ok]).abs().max()
        # float32 sums in another order: within 4x the plain float32
        # version's own distance to float64, plus 1e-6 of the magnitude
        assert err_k <= 4 * err_p + 1e-6 * r[ok].abs().max()
    assert torch.isnan(got[1].pri[4]) and torch.isnan(got[1].dua[4])
    others = torch.arange(len(args[0]), device=cuda) != 4
    assert not torch.isnan(torch.stack(got[1])[:, others]).any()
    for rows in (got[0][1], got[0][3]):          # zc, yc: inert rows stay 0
        assert (rows[others][:, ~live] == 0).all()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_skips_inactive_lanes(cuda, shape):
    args, _ = _inputs(cuda, seed=1, shape=shape)
    KW = _kw(SHAPES[shape][1])
    active = torch.arange(len(args[0]), device=cuda) % 3 != 0
    state, stats = fb.chunk(*args, **KW, active=active)
    for new, old in zip(state, args[15:]):
        assert torch.equal(new[~active], old[~active])
    assert torch.isnan(stats.pri[~active]).all()
    assert torch.isfinite(stats.pri[active]).all()


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args, _ = _inputs(cuda)
    KW = _kw(SHAPES["cs1"][1])
    with pytest.raises(TypeError):
        fb.chunk_cuda(*[a.double() for a in args], **KW)
    bad = list(args)
    bad[0] = args[0].transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fb.chunk_cuda(*bad, **KW)
    bad[0] = args[0][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        fb.chunk_cuda(*bad, **KW)


def test_shape_no_cluster_takes_raises_before_launch(cuda):
    """T 30, D 17, K 2, R 68: n = 510 and m = 2040 are within the threads'
    reach, but the weights alone take 285,600 B, more than any block of
    any cluster size can hold."""
    T, D, K, R = 30, 17, 2, 68
    n, m = T * D, T * R
    sizes = [(1, n, n), (1, T, R, K * D), (1, n, n)] + [(1, n)] \
        + [(1, m)] * 4 + [(1, n)] * 3 + [(1, m)] + [(1, n)] * 2 + [(1,)] \
        + [(1, n), (1, m), (1, n), (1, m), (1, n)]
    args = [torch.ones(s, device=cuda) for s in sizes]
    before = _count("qp.block_chunk.launches")
    with pytest.raises(ValueError, match="no cluster"):
        fb.chunk_cuda(*args, **_kw(D))
    assert _count("qp.block_chunk.launches") == before


def test_small_solve_on_the_card(cuda):
    prob, _ = pr2ish_table_problem(n_steps=6, lvs_substeps=2)
    # the flagship's float32 QP settings (__graft_entry__._solver_params)
    qp = ADMMConfig(eps_abs=2e-5, eps_rel=2e-5, max_iter=450,
                    check_every=150, adaptive_rho=False, rho_dual_scale=0.1,
                    ns_refresh=True, ns_tol=1e-4, ns_power_iters=4)
    solve = prob.make_solve(SQPParams(max_restarts=1, qp=qp),
                            structured=True)
    inits, goals = pr2ish_table_batch(0, 4, 6)
    assert inits.device.type == "cuda" and inits.dtype == torch.float32
    before = _count("qp.block_chunk.launches")
    res = solve(inits, {"goal": goals})
    assert _count("qp.block_chunk.launches") > before
    assert (res.status == SQPStatus.CONVERGED).all()
    assert torch.isfinite(res.x).all()


# (B, n, m) by the kernel fused_dense.cluster_plan picks: ragged (n and m
# not multiples of 32) in one block; arm7's dense QP shape in a cluster of
# three; the JSON front end's arm7 Cartesian-reach document (30 steps,
# lvs_discrete) in a cluster of five; a cluster of seven; and a shape no
# cluster of eight holds, which takes the streaming kernel (cs = 0).
DENSE = {"ragged": (5, 37, 61), "arm7": (4, 210, 449),
         "json_arm7": (4, 210, 888), "cs7": (4, 300, 700),
         "stream": (4, 400, 1200)}
DENSE_CLUSTER = {"ragged": 1, "arm7": 3, "json_arm7": 5, "cs7": 7,
                 "stream": 0}
DKW = dict(sigma=1e-6, alpha=1.6, n_iters=40)


def _dense_inputs(dev, seed=0, shape="ragged"):
    """Seeded float32 dense-chunk operands: hard (inequality, equality with
    rho 100, box) and penalty rows."""
    B, n, m = DENSE[shape]
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device=dev)
    m_c = m - n
    A = np.concatenate([rng.standard_normal((B, m_c, n)),
                        np.broadcast_to(np.eye(n), (B, n, n))], 1)
    kind = rng.integers(0, 4, (B, m_c))
    bnd = rng.standard_normal((B, m_c))
    l = np.concatenate([np.where(kind >= 2, bnd, -np.inf),
                        -np.ones((B, n))], 1)
    u = np.concatenate([bnd, np.ones((B, n))], 1)
    c = np.concatenate([np.where(kind % 2 == 0, np.inf,
                                 rng.uniform(1, 50, (B, m_c))),
                        np.full((B, n), np.inf)], 1)
    rho = np.where(np.isinf(c) & (u - l < 1e-10), 100.0, 0.1)
    G = rng.standard_normal((B, n, n)) / np.sqrt(n)
    At = torch.as_tensor(A, **f64)
    M = (torch.as_tensor(G @ G.transpose(0, 2, 1) + np.eye(n), **f64)
         + At.transpose(1, 2) @ (torch.as_tensor(rho, **f64)[..., None] * At))
    x = rng.standard_normal((B, n)) * 0.1
    ops = [cholesky_inverse(M), At, rng.standard_normal((B, n)), l, u,
           c / rho, rho, x, np.einsum("bmn,bn->bm", A, x),
           rng.standard_normal((B, m)) * 0.01]
    return [torch.as_tensor(v, dtype=torch.float32, device=dev).contiguous()
            for v in ops]


@pytest.mark.parametrize("shape", sorted(DENSE))
def test_dense_kernel_matches_plain_version(cuda, shape):
    assert fd.cluster_plan(*DENSE[shape][1:])[0] == DENSE_CLUSTER[shape]
    args = _dense_inputs(cuda, shape=shape)
    args[2][3, 4] = float("nan")                 # a blown-up lane
    before = _count("qp.dense_chunk.launches")
    got = fd.chunk_cuda(*args, **DKW)
    assert _count("qp.dense_chunk.launches") == before + 1
    ref = fd.chunk_plain(*[a.double() for a in args], **DKW)
    plain = fd.chunk_plain(*args, **DKW)
    for g, r, p in zip(got, ref, plain):
        assert torch.equal(torch.isnan(g), torch.isnan(r))
        ok = ~torch.isnan(r)
        err_k = (g[ok].double() - r[ok]).abs().max()
        err_p = (p[ok].double() - r[ok]).abs().max()
        # float32 sums in another order: within 4x the plain float32
        # version's own distance to float64, plus 1e-6 of the magnitude
        assert err_k <= 4 * err_p + 1e-6 * r[ok].abs().max()
    assert all(torch.isnan(t[3]).all() for t in got)
    others = torch.arange(len(args[0]), device=cuda) != 3
    assert not any(torch.isnan(t[others]).any() for t in got)


@pytest.mark.parametrize("shape", sorted(DENSE))
def test_dense_kernel_skips_inactive_lanes(cuda, shape):
    assert fd.cluster_plan(*DENSE[shape][1:])[0] == DENSE_CLUSTER[shape]
    args = _dense_inputs(cuda, seed=1, shape=shape)
    active = torch.arange(len(args[0]), device=cuda) % 2 == 0
    full = fd.chunk_cuda(*args, **DKW)
    out = fd.chunk(*args, **DKW, active=active)
    for new, old, ref in zip(out[:3], args[7:], full[:3]):
        assert torch.equal(new[~active], old[~active])
        assert torch.equal(new[active], ref[active])
    assert torch.isnan(out[3][~active]).all()


def test_dense_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args = _dense_inputs(cuda)
    with pytest.raises(TypeError):
        fd.chunk_cuda(*[a.double() for a in args], **DKW)
    bad = list(args)
    bad[1] = args[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fd.chunk_cuda(*bad, **DKW)
    bad[1] = args[1][:, :-1].contiguous()     # one row short of l, u, ...
    with pytest.raises(ValueError, match="shape"):
        fd.chunk_cuda(*bad, **DKW)
    wide = [torch.zeros(1, 600, 600, device=cuda),
            torch.zeros(1, 3, 600, device=cuda)]
    wide += [torch.zeros(1, k, device=cuda) for k in (600, 3, 3, 3, 3)]
    wide += [torch.zeros(1, 600, device=cuda), torch.zeros(1, 3, device=cuda),
             torch.zeros(1, 3, device=cuda)]
    with pytest.raises(ValueError, match="column range"):
        fd.chunk_cuda(*wide, **DKW)


def test_small_dense_solve_on_the_card(cuda):
    prob, _ = arm_table_problem(n_steps=6)
    # the arm7 workload's float32 QP settings (__graft_entry__._solver_params)
    qp = ADMMConfig(eps_abs=2e-5, eps_rel=2e-5, max_iter=60, check_every=20,
                    adaptive_rho=False, rho_dual_scale=0.1)
    solve = prob.make_solve(SQPParams(max_restarts=1, qp=qp))
    inits, goals = arm_table_batch(1, 4, 6)
    assert inits.device.type == "cuda" and inits.dtype == torch.float32
    before = _count("qp.dense_chunk.launches")
    res = solve(inits, {"goal": goals})
    assert _count("qp.dense_chunk.launches") > before
    assert (res.status == SQPStatus.CONVERGED).all()
    assert torch.isfinite(res.x).all()


def test_swept_solve_on_the_dense_path(cuda):
    """A cast (swept) problem on the default dense path: its collision
    term gives the narrowphase's analytic dense Jacobian, so the solve
    runs through the primitive kernel and differentiates nothing through
    it."""
    prob, _ = pr2ish_table_problem(n_steps=6, lvs_substeps=2)
    qp = ADMMConfig(eps_abs=2e-5, eps_rel=2e-5, max_iter=450,
                    check_every=150, adaptive_rho=False, rho_dual_scale=0.1)
    solve = prob.make_solve(SQPParams(max_restarts=1, qp=qp))
    inits, goals = pr2ish_table_batch(0, 4, 6)
    dense = _count("qp.dense_chunk.launches")
    prim = _count("collision.primitive.launches")
    res = solve(inits, {"goal": goals})
    assert _count("qp.dense_chunk.launches") > dense
    assert _count("collision.primitive.launches") > prim
    assert (res.status == SQPStatus.CONVERGED).all()
    assert torch.isfinite(res.x).all()


def _plain_dense_chunk(*args, active=None, **kw):
    """``fused_dense.chunk`` with the plain version on any device."""
    out = fd.chunk_plain(*args, **kw)
    if active is None:
        return out
    keep = active[:, None]
    x, z, y = (torch.where(keep, new, old)
               for new, old in zip(out[:3], args[7:]))
    return x, z, y, torch.where(keep, out[3], torch.full_like(out[3],
                                                              float("nan")))


def test_json_solve_on_the_card(cuda, monkeypatch):
    """The port's arm_table.json (10 steps) through the JSON front end on
    the card: in float64 (the dense chunk's plain version on the card)
    equal to the CPU's float64 solve (counts equal, x within 1e-6); in
    float32 through ``JsonProblem.solve()``, launching the dense kernel and
    converging."""
    import os

    from trajopt_tpu_torch.models.benchmarks import ARM7_HOME
    from trajopt_tpu_torch.models.robots import arm7, arm7_scene
    from trajopt_tpu_torch.problem.json_io import (Environment,
                                                   load_problem_file)
    from trajopt_tpu_torch.sqp.solver import make_solver

    path = os.path.join(os.path.dirname(__file__), "..", "trajopt_tpu_torch",
                        "data", "config", "arm_table.json")
    env = Environment(arm7(), arm7_scene(), ARM7_HOME)

    def solve64(dev):
        jp = load_problem_file(path, env, device=dev)
        x0 = jp.init_traj.reshape(1, -1).to(dev)
        res = make_solver(jp.prob.build(), jp.sqp)(x0, *jp.prob.bounds(x0),
                                                   {})
        return res._replace(**{k: v.cpu() for k, v in res._asdict().items()})

    with monkeypatch.context() as m:
        m.setattr(fd, "chunk", _plain_dense_chunk)
        card64 = solve64(cuda)
    cpu64 = solve64("cpu")
    for name in ("status", "n_iter", "n_qp_solves", "n_func_evals"):
        assert torch.equal(getattr(card64, name), getattr(cpu64, name)), name
    assert (card64.x - cpu64.x).abs().max() <= 1e-6

    jp = load_problem_file(path, env)
    before = _count("qp.dense_chunk.launches")
    res = jp.solve()
    assert _count("qp.dense_chunk.launches") > before
    assert res.x.device.type == "cuda" and res.x.dtype == torch.float32
    assert int(res.status[0]) == SQPStatus.CONVERGED


def _held(card, plain, ref, floor=1e-3):
    """The card's float32 result against the CPU's float64 one: at most 4x
    the CPU float32 result's own distance to float64, plus ``floor`` of
    the magnitude (the pattern of the chunk-kernel tests above)."""
    card, plain = card.double().cpu(), plain.double().cpu()
    err_k = (card - ref).abs().max()
    err_p = (plain - ref).abs().max()
    return err_k <= 4 * err_p + floor * max(1.0, float(ref.abs().max()))


def test_ipm_on_the_card(cuda):
    """solve_qp_ipm in float32 on the card (the solver's float32 settings)
    against float64 on the CPU, on random QPs with hard inequality, hard
    equality and penalty rows."""
    from trajopt_tpu_torch.qp.admm import QPData
    from trajopt_tpu_torch.qp.ipm import IPMConfig, solve_qp_ipm
    rng = np.random.default_rng(0)
    B, n, m = 16, 12, 18
    G = rng.standard_normal((B, n, n))
    P = G @ G.transpose(0, 2, 1) + 0.5 * np.eye(n)
    center = rng.standard_normal((B, m)) * 0.3
    half = 0.2 + rng.uniform(size=(B, m))
    l, u = center - half, center + half
    l[:, :2] = u[:, :2] = center[:, :2]
    c = np.full((B, m), np.inf)
    c[:, 2:8] = 5.0
    qp = [P, rng.standard_normal((B, n)), rng.standard_normal((B, m, n)),
          l, u, c]
    f32 = IPMConfig(eps=2e-5, eps_res=1e-3, reg=1e-7)
    got = solve_qp_ipm(QPData(*(torch.as_tensor(a, dtype=torch.float32,
                                                device=cuda) for a in qp)),
                       cfg=f32)
    plain = solve_qp_ipm(QPData(*(torch.as_tensor(a, dtype=torch.float32)
                                  for a in qp)), cfg=f32)
    ref = solve_qp_ipm(QPData(*(torch.as_tensor(a, dtype=torch.float32)
                                .double() for a in qp)))
    assert ref.converged.all()
    assert int(got.converged.sum()) >= int(plain.converged.sum()) - 1
    assert _held(got.x, plain.x, ref.x)


def test_structured_qp_on_the_card(cuda):
    """solve_qp_structured (gather-banded ADMM) in float32 on the card
    against float64 on the CPU, 600 iterations (eps 0)."""
    from trajopt_tpu_torch.qp import banded as bd
    from trajopt_tpu_torch.qp.admm_structured import (StructuredQP,
                                                      solve_qp_structured)
    rng = np.random.default_rng(1)
    B, n, m, w = 8, 24, 15, 6
    G = rng.standard_normal((B, n, n)) * 0.3
    ctr = rng.standard_normal((B, m))
    arrays = [G @ G.transpose(0, 2, 1) + 0.2 * np.eye(n),
              rng.standard_normal((B, n)), rng.standard_normal((B, m, w)),
              ctr - 0.4, ctr + 0.4,
              np.where(rng.uniform(size=(B, m)) < 0.3, np.inf, 5.0),
              rng.standard_normal((B, n)) - 2.0,
              rng.standard_normal((B, n)) + 2.0]
    starts = rng.integers(0, n - w + 1, size=m)
    cfg = ADMMConfig(eps_abs=0.0, eps_rel=0.0, max_iter=600, check_every=50,
                     adaptive_rho=False)

    def solve(dtype, dev):
        t = [torch.as_tensor(a, dtype=torch.float32).to(dtype=dtype,
                                                         device=dev)
             for a in arrays]
        qp = StructuredQP(t[0], t[1], bd.make_banded(t[2], starts, n), *t[3:])
        return solve_qp_structured(qp, torch.zeros(B, n, dtype=dtype,
                                                   device=dev), cfg=cfg)

    got = solve(torch.float32, cuda)
    assert got.x.device.type == cuda.type
    assert _held(got.x, solve(torch.float32, "cpu").x,
                 solve(torch.float64, "cpu").x)


def _plain_chunk(*args, active=None, **kw):
    """``fused_block.chunk`` with the plain version on any device."""
    state, stats = fb.chunk_plain(*args, **kw)
    if active is None:
        return state, stats
    state = tuple(torch.where(active[:, None], new, old)
                  for new, old in zip(state, args[15:]))
    stats = type(stats)(*(torch.where(active, v, torch.full_like(
        v, float("nan"))) for v in stats))
    return state, stats


def test_restart_family_solve_on_the_card(cuda, monkeypatch):
    """A pr2ish borderline solve (10 steps, 3 lanes, seed 7) whose lane 0
    runs out of its one merit increase and re-seeds from the multi-start
    family at its one restart.  In float64 (the chunk's plain version on
    the card) the card and the CPU agree: equal counts, x within 1e-6.  In
    float32 the card (block kernel) takes the CPU's path (equal status and
    counts) and agrees with the plain chunk on the card within 4x the
    CPU's own float32 spread under a 1e-6 change of the inits; card and
    CPU x differ by ~1e-2 on the re-seeded lane, with the plain chunk on
    the card as with the kernel: the float32 library linear algebra of
    the two devices, not the kernel, moves it."""
    import dataclasses

    from trajopt_tpu_torch.models.benchmarks import pr2ish_restart_family
    from trajopt_tpu_torch.sqp.solver import make_solver
    qp = ADMMConfig(eps_abs=2e-5, eps_rel=2e-5, max_iter=450,
                    check_every=150, adaptive_rho=False, rho_dual_scale=0.1,
                    ns_refresh=True, ns_tol=1e-4, ns_power_iters=4)
    params = dataclasses.replace(SQPParams(qp=qp), max_restarts=1,
                                 max_merit_coeff_increases=1)

    def solve(dev, dtype=torch.float32, shift=None, plain=False):
        with monkeypatch.context() as m:
            if plain:
                m.setattr(fb, "chunk", _plain_chunk)
            prob, _ = pr2ish_table_problem(n_steps=10, lvs_substeps=2,
                                           device=dev)
            inits, goals = pr2ish_table_batch(7, 3, 10, dtype=dtype,
                                              device=dev, hard_frac=1.0)
            x0 = inits.reshape(3, -1)
            if shift is not None:
                x0 = torch.cat([x0[:, :8], x0[:, 8:] + shift.to(x0)], 1)
            res = make_solver(prob.build(), params, structured=True)(
                x0, *prob.bounds(x0),
                {"goal": goals,
                 "restart_inits": pr2ish_restart_family(goals, 10)})
        return res._replace(**{k: v.cpu() for k, v in res._asdict().items()})

    counts = ("status", "n_iter", "n_qp_solves", "n_func_evals")
    card64 = solve(cuda, torch.float64, plain=True)
    cpu64 = solve("cpu", torch.float64)
    for name in counts:
        assert torch.equal(getattr(card64, name), getattr(cpu64, name)), name
    assert (card64.x - cpu64.x).abs().max() <= 1e-6

    card, cpu = solve(cuda), solve("cpu")
    for name in counts:
        assert torch.equal(getattr(card, name), getattr(cpu, name)), name
    assert int(((cpu.n_func_evals - cpu.n_qp_solves - 1) > 0).sum()) >= 1
    noise = torch.as_tensor(np.random.default_rng(0).uniform(
        -1e-6, 1e-6, (3, 72)))
    spread = (solve("cpu", shift=noise).x - cpu.x).abs().amax(-1)
    plain = solve(cuda, plain=True)
    tol = torch.clamp_min(4 * spread, 1e-4)
    assert ((card.x - plain.x).abs().amax(-1) <= tol).all()


def _narrowphase(dev, dtype, n=12, seed=11):
    """The unified pr2ish scene's discrete and swept distances with their
    Jacobians (all pairs through the convex GJK + SAT kernel) at seeded
    configurations, on ``dev`` in ``dtype``, returned on the CPU in
    float64."""
    _, scene = pr2ish_table_problem(n_steps=4, lvs_substeps=2,
                                    unify_narrowphase=True, device="cpu")
    tree = scene.tree
    rng = np.random.default_rng(seed)
    q0 = rng.uniform(tree.lower + 0.05, tree.upper - 0.05, (n, 8))
    q1 = np.clip(q0 + 0.3 * rng.standard_normal((n, 8)), tree.lower,
                 tree.upper)
    q0, q1 = (torch.as_tensor(v, dtype=dtype, device=dev) for v in (q0, q1))
    out = [*scene.distances_and_jac(tree.fk_with_axes(q0)),
           *scene.swept_distances_and_jac(tree.fk_with_axes(q0),
                                          tree.fk_with_axes(q1))]
    return [t.double().cpu() for t in out]


def test_convex_narrowphase_on_the_card(cuda):
    """Float64 on the card equals the CPU (the same elementwise
    arithmetic); float32 on the card lies within twice the CPU float32's
    own distance to float64, plus 1e-6."""
    cpu = torch.device("cpu")
    ref = _narrowphase(cpu, torch.float64)
    for g, r in zip(_narrowphase(cuda, torch.float64), ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-9)
    own = [(c - r).abs().max() for c, r in
           zip(_narrowphase(cpu, torch.float32), ref)]
    for g, r, e in zip(_narrowphase(cuda, torch.float32), ref, own):
        assert float((g - r).abs().max()) <= 2 * float(e) + 1e-6


def _convex_battery():
    """The hull pairs of the JAX package's convex batteries
    (tests/test_torch_convex.py ``_pairs``), built with the port alone:
    vertex-form primitives, boxes at four offsets, separated, penetrating
    and grazing random hulls.  Returns (Va, Vb, axes, valid) as float64
    numpy arrays."""
    def box(half, center=(0.0, 0.0, 0.0)):
        return np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                         for sz in (-1, 1)]) * half + np.asarray(center)

    pairs = [(np.zeros((1, 3)), np.array([[2.0, 0, 0]]), [], []),
             (np.zeros((1, 3)), np.array([[0.6, 0, 0]]), [], []),
             (np.array([[-0.3, 0.0, 0.0], [0.3, 0.0, 0.0]]),
              box(0.2, [0.0, 0.0, 1.0]), [np.eye(3)],
              [np.array([[1.0, 0, 0]]), np.eye(3)])]
    pairs += [(box(0.5), box(0.5, [off, 0, 0]), [np.eye(3), np.eye(3)],
               [np.eye(3), np.eye(3)]) for off in (1.6, 1.1, 0.8, 0.5)]
    for seed, n, shift in ((3, 40, None), (7, 30, 0.3), (11, 40, None)):
        rng = np.random.default_rng(seed)
        for _ in range(6):
            A, Na, Ea = tcvx.hull_of(rng.normal(size=(n, 3)))
            pts = rng.normal(size=(n, 3))
            B, Nb, Eb = tcvx.hull_of(pts + (
                rng.uniform(-shift, shift, size=3) if shift else
                np.array([4.0 if seed == 3 else 5.0, 0.5, 0.0])))
            if seed == 11:      # grazing: moved along the GJK witness
                wa, wb = (w.numpy() for w in tcvx._gjk_weights(
                    torch.as_tensor(A), torch.as_tensor(B)))
                z = wa @ A - wb @ B
                d0 = np.linalg.norm(z)
                B = B + (d0 - rng.uniform(2e-4, 1e-3)) * z / d0
            pairs.append((A, B, [Na, Nb], [Ea, Eb]))
    n_v = max(max(len(a), len(b)) for a, b, _, _ in pairs)
    rows = []
    for _, _, normals, edges in pairs:
        ax = list(normals)
        if len(edges) == 2:
            ea, eb = (torch.as_tensor(e) for e in edges)
            ax.append(tcvx.edge_cross_axes(
                ea, torch.ones(len(ea), dtype=torch.bool), eb,
                torch.ones(len(eb), dtype=torch.bool))[0].numpy())
        rows.append(np.concatenate(ax) if ax else np.zeros((0, 3)))
    k = max(max(len(r) for r in rows), 1)

    def pad(v, n):
        return np.pad(v, ((0, n - len(v)), (0, 0)), mode="edge")

    return (np.stack([pad(a, n_v) for a, _, _, _ in pairs]),
            np.stack([pad(b, n_v) for _, b, _, _ in pairs]),
            np.stack([pad(r, k) if len(r) else np.zeros((k, 3))
                      for r in rows]),
            np.stack([np.arange(k) < len(r) for r in rows]))


def _search_inputs(dev, dtype):
    """The search's inputs (Va, Vb, axes, valid, cax) on the battery and
    on every call of the unified scene's four queries at 16 seeded
    configurations (tests/test_torch_cuda.py ``_narrowphase``)."""
    Va, Vb, axes, valid = (torch.as_tensor(a, device=dev) for a in
                           _convex_battery())
    Va, Vb, axes = (t.to(dtype) for t in (Va, Vb, axes))
    out = [(Va, Vb, axes, valid, Va.mean(-2) - Vb.mean(-2))]
    search = tfc.select

    def record(*args):
        out.append(tuple(t.detach().clone() for t in args[:5]))
        return search(*args)

    tfc.select = record
    try:
        _narrowphase(dev, dtype, n=16)
    finally:
        tfc.select = search
    return out


def _hold_search(inputs, tol):
    """Kernel against plain search on ``inputs``: the selections equal but
    for near ties (at most 1 % of the queries), whose distances through
    the epilogue agree within ``tol``.  Returns the kernel's result."""
    got = tfc.select_cuda(*inputs)
    ref = tfc.select_plain(*inputs)
    diff = torch.zeros(got.k.shape[:-1], dtype=torch.bool, device=got.k.device)
    for a, b in zip(got, ref):
        diff |= (a != b).reshape(*diff.shape, -1).any(-1)
    Va, Vb, axes, _, cax = inputs
    d = [tcvx._epilogue(Va, 0.0, Vb, 0.0, axes, cax, sel)
         for sel in (got, ref)]
    assert float((d[0] - d[1]).abs().max()) <= tol
    assert int(diff.sum()) <= 0.01 * diff.numel()
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_convex_search_kernel_matches_plain(cuda, dtype):
    """The search kernel against its plain version on the JAX batteries
    and on the unified pr2ish scene's 16 x 91 queries; broadcast inputs
    (stride 0) give the contiguous inputs' bits; the wrapper counts one
    launch a call."""
    tol = 1e-5 if dtype == torch.float32 else 1e-10
    inputs = _search_inputs(cuda, dtype)
    assert len(inputs) == 5                  # battery, discrete, 3 swept
    profiling.reset()
    for inp in inputs:
        _hold_search(inp, tol)
    assert _count("collision.convex.launches") == len(inputs)
    Va, Vb, axes, valid, _ = inputs[0]
    shift = 0.01 * torch.arange(3, dtype=dtype, device=cuda)[:, None, None,
                                                              None]
    lanes = (Va + shift, Vb.expand(3, *Vb.shape), axes.expand(3, *axes.shape),
             valid.expand(3, *valid.shape))
    lanes += ((lanes[0].mean(-2) - lanes[1].mean(-2)),)
    wide = tfc.select_cuda(*lanes)
    dense = tfc.select_cuda(*(t.contiguous() for t in lanes))
    for a, b in zip(wide, dense):
        assert torch.equal(a, b)


def _random_search_inputs(dev, dtype, n, A, B, K, seed=0):
    """Seeded search inputs of ``n`` queries: random vertex sets (the last
    vertex of a third of A's rows repeating the first, as edge-mode
    padding does), random axes with a mask, the centroid axis."""
    rng = np.random.default_rng(seed)
    Va = rng.normal(size=(n, A, 3))
    Va[: n // 3, -1] = Va[: n // 3, 0]
    Vb = rng.normal(size=(n, B, 3)) + 2.0 * rng.normal(size=(n, 1, 3))
    axes = rng.normal(size=(n, K, 3))
    valid = rng.uniform(size=(n, K)) < 0.8
    Va, Vb, axes = (torch.as_tensor(a, dtype=dtype, device=dev)
                    for a in (Va, Vb, axes))
    return (Va, Vb, axes, torch.as_tensor(valid, device=dev),
            Va.mean(-2) - Vb.mean(-2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_convex_search_kernel_ragged_and_run_time_shapes(cuda, dtype):
    """The search kernel (one thread a query, several queries a thread)
    against its plain version on query counts that are multiples of
    neither 16 nor a block's share, at the compile-time shapes (A, B) =
    (4, 8), (2, 2), (8, 8) and at shapes outside them (hulls of 12 and 20
    vertices; 1 and 3), and a ragged call equal to the same queries inside
    a full one."""
    tol = 1e-5 if dtype == torch.float32 else 1e-10
    for n, A, B, K in ((45, 4, 8, 17), (13, 2, 2, 3), (21, 8, 8, 24),
                       (19, 12, 20, 30), (5, 1, 3, 0)):
        inputs = _random_search_inputs(cuda, dtype, n, A, B, K)
        got = _hold_search(inputs, tol)
        full = tfc.select_cuda(*_random_search_inputs(cuda, dtype, 48, A, B,
                                                      K))
        part = tfc.select_cuda(*(t[:n] for t in _random_search_inputs(
            cuda, dtype, 48, A, B, K)))
        for a, b in zip(part, full):
            assert torch.equal(a, b[:n])
        assert got.idA.shape == (n, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_convex_search_kernel_large_hulls(cuda, dtype):
    """The run-time instantiation reads the vertex rows through their
    strides, so it takes hulls of any size: 200 x 200 vertices and 400 x
    300 (more than a block's shared memory could stage a thread) against
    the plain version; a broadcast Vb (stride 0) gives the contiguous
    inputs' bits."""
    tol = 1e-5 if dtype == torch.float32 else 1e-10
    for n, A, B, K in ((300, 200, 200, 30), (37, 400, 300, 8)):
        Va, Vb, axes, valid, cax = _random_search_inputs(cuda, dtype, n, A,
                                                         B, K)
        assert _hold_search((Va, Vb, axes, valid, cax), tol).idA.shape \
            == (n, 4)
        wide = (Va, Vb[:1].expand(n, B, 3), axes, valid,
                Va.mean(-2) - Vb[:1].mean(-2))
        dense = tuple(t.contiguous() for t in wide)
        for a, b in zip(tfc.select_cuda(*wide), tfc.select_cuda(*dense)):
            assert torch.equal(a, b)


def test_convex_search_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    Va, Vb, axes, valid = (torch.as_tensor(a, device=cuda) for a in
                           _convex_battery())
    cax = Va.mean(-2) - Vb.mean(-2)
    with pytest.raises(TypeError):
        tfc.select_cuda(Va.half(), Vb, axes, valid, cax)
    with pytest.raises(TypeError):
        tfc.select_cuda(Va, Vb.float(), axes, valid, cax)
    with pytest.raises(ValueError, match="shape"):
        tfc.select_cuda(Va, Vb, axes[:-1], valid, cax)
    with pytest.raises(ValueError, match="CUDA"):
        tfc.select_cuda(Va, Vb.cpu(), axes, valid, cax)



def test_node_maps_name_every_replayed_kernel(cuda):
    """A 6-step flagship solve on 8 lanes, its regions captured by a first
    solve, then profiled: every replay traces as many device spans as its
    graph's node map (``aot_cache.node_maps``) holds, kernels, copies and
    memsets in the map's order, and each primitive kernel it launches lies
    in a ``collision.primitive`` node; the solve's device-to-host copies
    are its counted host syncs."""
    prob, _ = pr2ish_table_problem(n_steps=6, lvs_substeps=2)
    solve = prob.make_solve(flagship_params(), structured=True)
    inits, goals = pr2ish_table_batch(0, 8, 6, hard_frac=0.25)
    solve(inits, {"goal": goals})
    torch.cuda.synchronize()
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        solve(inits, {"goal": goals})
        torch.cuda.synchronize()
    got = profiling.counters()
    assert got["capture.replays"] > 0 and "capture.captures" not in got
    maps = aot_cache.node_maps()
    dev_t = torch.autograd.DeviceType.CUDA
    replays, graph_at, spans, d2h = [], {}, {}, 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == dev_t:
            if name.startswith(("sqp.", "qp.", "collision.")):
                continue                    # a range's device annotation
            spans.setdefault(e.correlation_id(), []).append(
                (e.start_ns(), name))
            d2h += "DtoH" in name
        elif ".replay." in name:
            replays.append((e.start_ns(), e.end_ns(), name))
        elif name.startswith("cudaGraphLaunch"):
            graph_at[e.correlation_id()] = e.start_ns()
    assert d2h == got["host.syncs"] > 0
    assert len(graph_at) == got["capture.replays"]
    prim = 0
    for corr, t in graph_at.items():
        (name,) = [n for a, b, n in replays if a <= t <= b]
        kinds, paths = maps[name]
        run = [n for _, n in sorted(spans.get(corr, []))]
        assert len(run) == len(kinds), name
        for n, kind, path in zip(run, kinds, paths):
            assert ("Memcpy" in n, "Memset" in n) == \
                (kind == "memcpy", kind == "memset"), (name, n, kind)
            if tfp.KERNEL in n:
                assert "collision.primitive" in path, (name, n, path)
                prim += 1
    assert prim > 0

def test_captured_convex_narrowphase_equals_eager(cuda):
    """A region holding the search kernel (``convex_convex`` on the
    battery), captured with ``aot_cache.cached_export``, replays equal to
    its eager run on new inputs; the wrapper is called while the region is
    warmed up and captured, not when it is replayed, and the launch counter
    counts the warm-up, every replay and every eager run."""
    Va, Vb, axes, valid = (torch.as_tensor(a, device=cuda, dtype=torch.float32
                                           if a.dtype != bool else None)
                           for a in _convex_battery())

    def region(va, vb, ax, v):
        return tcvx.convex_convex(va, 0.05, vb, 0.0, ax, v)

    args = (Va, Vb, axes, valid)
    f = aot_cache.cached_export(region, args, "convex-search-test", memo={})
    aot_cache.STATS.reset()
    profiling.reset()
    f(*args)
    captured_at = _count("collision.convex.launches")
    assert captured_at >= 1 and aot_cache.STATS.captures == 1
    for step in (0.01, -0.02):
        moved = (Va + step, Vb, axes, valid)
        assert torch.equal(f(*moved), region(*moved))
    assert aot_cache.STATS.replays >= 2
    # two replays and two eager runs
    assert _count("collision.convex.launches") == captured_at + 4


def test_sdf_query_on_the_card(cuda):
    """An SDF grid's queries and gradients on the card equal the CPU's in
    float64; in float32 they lie within twice the CPU float32's own
    distance to float64, plus 1e-6."""
    from trajopt_tpu_torch.collision.geometry import point_box_sdf
    from trajopt_tpu_torch.collision.sdf_grid import bake_sdf

    grid = bake_sdf(lambda p: point_box_sdf(
        p - torch.tensor([0.3, 0.0, 0.5], dtype=p.dtype),
        torch.tensor([0.2, 0.3, 0.1], dtype=p.dtype)),
        [-1, -1, -0.5], [1, 1, 1.5], 0.05)
    pts = np.random.default_rng(0).uniform(-1.3, 1.8, (500, 3))

    def query(dev, dt):
        p = torch.tensor(pts, dtype=dt, device=dev, requires_grad=True)
        d = grid.query(p)
        (g,) = torch.autograd.grad(d.sum(), [p])
        return d.detach().double().cpu(), g.double().cpu()

    cpu = torch.device("cpu")
    ref = query(cpu, torch.float64)
    for got, r in zip(query(cuda, torch.float64), ref):
        np.testing.assert_allclose(got.numpy(), r.numpy(), rtol=0, atol=1e-12)
    own = [(c - r).abs().max() for c, r in zip(query(cpu, torch.float32),
                                                ref)]
    for g, r, e in zip(query(cuda, torch.float32), ref, own):
        assert float((g - r).abs().max()) <= 2 * float(e) + 1e-6


def _ifopt_problem(name, pr2_steps=4):
    """Small ifopt problems on the port alone: the boxbot cast facade
    problem (3 steps, the middle node off the obstacle's center) and the
    PR2 planning problem of chip_smoke.py phase 12 at ``pr2_steps``
    steps."""
    from trajopt_tpu_torch import ifopt
    from trajopt_tpu_torch.collision.world import CollisionScene
    from trajopt_tpu_torch.models.benchmarks import PR2ISH_HOME, pr2ish_goals
    from trajopt_tpu_torch.models.robots import boxbot, pr2ish_scene

    prob = ifopt.Problem()
    if name == "boxbot":
        scene = CollisionScene(boxbot())
        scene.add_link_sphere("boxbot_link", 0.25)
        scene.add_world_box("obstacle0", [0.5, 0.5, 0.5], [0.0, 0.0, 0.0])
        n_steps, D = 3, 2
        init = np.array([[-1.9, 0.0], [0.1, 0.05], [1.9, 0.0]])
        lower, upper = -10.0, 10.0
        kw = dict(margin=0.05, lvs_substeps=3, max_num_cnt=None)
        ends = torch.tensor([-1.9, 0.0, 1.9, 0.0], dtype=torch.float64)
        prob.add_constraint_set(ifopt.FunctionalConstraint(
            4, "endpoints", lambda v: torch.cat(
                [v["trajectory"][:2], v["trajectory"][-2:]])
            - ends.to(v["trajectory"])))
    else:
        scene = pr2ish_scene()
        n_steps, D = pr2_steps, 8
        goal = pr2ish_goals(0, 1)[0]
        w = np.linspace(0.0, 1.0, n_steps)[:, None]
        init = PR2ISH_HOME * (1.0 - w) + goal * w
        lower = np.tile(scene.tree.lower, n_steps)
        upper = np.tile(scene.tree.upper, n_steps)
        lower[:8] = upper[:8] = PR2ISH_HOME
        kw = dict(margin=0.025, lvs_substeps=2, max_num_cnt=3)
    nodes = []
    for t in range(n_steps):
        nd = ifopt.Node(f"step{t}")
        nd.add_var("position", D)
        nodes.append(nd)
    nv = prob.add_variable_set(ifopt.NodesVariables(
        "trajectory", nodes, init.reshape(-1), lower, upper))
    pos = [nv.node_var(t, "position") for t in range(n_steps)]
    prob.add_cost_set(ifopt.SquaredCost(
        ifopt.JointVelConstraint(np.zeros(D), pos, coeffs=5.0)))
    if name != "boxbot":
        prob.add_constraint_set(ifopt.JointPosConstraint(goal, [pos[-1]]))
    for t in range(n_steps - 1):
        prob.add_constraint_set(ifopt.ContinuousCollisionConstraint(
            scene, pos[t], pos[t + 1], coeff=20.0, name=f"collision{t}",
            **kw))
    return prob


@pytest.mark.parametrize("name", ["boxbot", "pr2ish"])
def test_ifopt_solve_on_the_card(cuda, monkeypatch, name):
    """An ifopt problem through ``Problem.solve()`` in float64 on the card
    (the dense chunk's plain version there) equals the CPU's solve: status
    and counts equal, x within 1e-9."""
    prob = _ifopt_problem(name)
    with monkeypatch.context() as m:
        m.setattr(fd, "chunk", _plain_dense_chunk)
        card, card_x = prob.solve(dtype=torch.float64, device=cuda)
    cpu, cpu_x = prob.solve(dtype=torch.float64, device="cpu")
    for f in ("status", "n_iter", "n_qp_solves", "n_func_evals"):
        assert int(getattr(card, f)) == int(getattr(cpu, f)), f
    assert int(cpu.status) == SQPStatus.CONVERGED
    np.testing.assert_allclose(card_x["trajectory"], cpu_x["trajectory"],
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", ["boxbot", "pr2ish"])
def test_reference_driver_on_the_card(cuda, name):
    """``solve_reference`` with convexify and evaluation on the card in
    float64 (the C++ QP on the host) equals the CPU's, x within 1e-9."""
    from trajopt_tpu_torch.sqp.reference_solver import solve_reference

    prob = _ifopt_problem(name)
    args = (prob.build(), prob.initial_values(), *prob.bounds(), {})
    card = solve_reference(*args, device=cuda, dtype=torch.float64)
    cpu = solve_reference(*args, device="cpu")
    assert (card.status, card.n_iter, card.n_qp_solves) == \
        (cpu.status, cpu.n_iter, cpu.n_qp_solves)
    assert cpu.status == SQPStatus.CONVERGED
    np.testing.assert_allclose(card.x, cpu.x, rtol=0, atol=1e-9)


def test_captured_solve_equals_eager_on_the_card(cuda, monkeypatch):
    """A float64 10-step flagship solve on 5 lanes (the chunk's plain
    version on the card) with its regions captured equals the same solve
    under ``aot_cache.eager()`` to 1e-9: equal counts, replays in the
    captured run and none in the eager one."""
    monkeypatch.setattr(fb, "chunk", _plain_chunk)
    prob, _ = pr2ish_table_problem(n_steps=10, lvs_substeps=2)
    qp = ADMMConfig(eps_abs=2e-5, eps_rel=2e-5, max_iter=450,
                    check_every=150, adaptive_rho=False, rho_dual_scale=0.1,
                    ns_refresh=True, ns_tol=1e-4, ns_power_iters=4)
    solve = prob.make_solve(SQPParams(max_restarts=1, qp=qp),
                            structured=True)
    inits, goals = pr2ish_table_batch(0, 5, 10, dtype=torch.float64,
                                      hard_frac=0.4)
    aot_cache.STATS.reset()
    with aot_cache.eager():
        eager = solve(inits, {"goal": goals})
    assert aot_cache.STATS.replays == aot_cache.STATS.captures == 0
    captured = solve(inits, {"goal": goals})
    assert aot_cache.STATS.replays > 0 and aot_cache.STATS.captures > 0
    for f in ("status", "n_iter", "n_qp_solves", "n_func_evals"):
        assert torch.equal(getattr(captured, f), getattr(eager, f)), f
    assert float((captured.x - eager.x).abs().max()) <= 1e-9


def test_capture_raises_on_a_host_sync(cuda):
    """A region that reads a value on the host (``.item()``) fails at its
    capture with an error; it does not carry on eagerly.  In a child
    process, so that the failed capture leaves this one's device alone."""
    import subprocess
    import sys

    code = (
        "import torch\n"
        "from trajopt_tpu_torch.utils import aot_cache\n"
        "x = torch.ones(4, device='cuda')\n"
        "f = aot_cache.cached_export(lambda v: v * v.sum().item(), (x,),\n"
        "                            'sync', memo={})\n"
        "try:\n"
        "    f(x)\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', aot_cache.STATS.replays, type(e).__name__)\n"
        "else:\n"
        "    print('RAN')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert "RAISED 0" in out.stdout, out.stdout + out.stderr


def test_captured_ifopt_solve_equals_cpu(cuda, monkeypatch):
    """The ifopt PR2 problem (8 steps) through ``Problem.solve()`` in
    float64 on the card, its regions captured (the dense chunk's plain
    version), equals the CPU's: status and counts equal, x within 1e-9."""
    prob = _ifopt_problem("pr2ish", pr2_steps=8)
    aot_cache.STATS.reset()
    with monkeypatch.context() as m:
        m.setattr(fd, "chunk", _plain_dense_chunk)
        card, card_x = prob.solve(dtype=torch.float64, device=cuda)
    assert aot_cache.STATS.replays > 0
    cpu, cpu_x = prob.solve(dtype=torch.float64, device="cpu")
    for f in ("status", "n_iter", "n_qp_solves", "n_func_evals"):
        assert int(getattr(card, f)) == int(getattr(cpu, f)), f
    np.testing.assert_allclose(card_x["trajectory"], cpu_x["trajectory"],
                               rtol=0, atol=1e-9)


def test_user_functions_run_eagerly_on_the_card(cuda, monkeypatch):
    """The boxbot ifopt problem, whose user constraint copies a host
    constant to the card (``ends.to(...)``, which a capture cannot hold):
    the solver sees the user's function when it is made, evaluates the
    terms eagerly and captures its QP preparation; float64 equals the
    CPU's solve, counts equal, x within 1e-9."""
    from trajopt_tpu_torch.sqp import nlp as nlp_mod

    prob = _ifopt_problem("boxbot")
    assert nlp_mod.runs_user_code(prob.build())
    aot_cache.STATS.reset()
    with monkeypatch.context() as m:
        m.setattr(fd, "chunk", _plain_dense_chunk)
        card, card_x = prob.solve(dtype=torch.float64, device=cuda)
    assert aot_cache.STATS.replays > 0
    cpu, cpu_x = prob.solve(dtype=torch.float64, device="cpu")
    for f in ("status", "n_iter", "n_qp_solves", "n_func_evals"):
        assert int(getattr(card, f)) == int(getattr(cpu, f)), f
    np.testing.assert_allclose(card_x["trajectory"], cpu_x["trajectory"],
                               rtol=0, atol=1e-9)


def test_captures_follow_non_tensor_params(cuda, monkeypatch):
    """Two solves of one solver that differ only in a numpy param (the
    lanes' goals) each equal the CPU's to 1e-9 and reach their own goals:
    the solver takes the param as a tensor, so the second solve does not
    replay the first one's goals."""
    from trajopt_tpu_torch.problem.trajectory import TrajOptProblem
    from trajopt_tpu_torch.sqp.solver import make_solver
    from trajopt_tpu_torch.terms.joint import joint_pos, joint_vel

    monkeypatch.setattr(fd, "chunk", _plain_dense_chunk)
    n = 5
    prob = TrajOptProblem(n_steps=n, n_dof=2, joint_lower=[-10, -10],
                          joint_upper=[10, 10], fixed_steps=[0],
                          device="cpu")
    prob.add_term(joint_vel(n, 2, is_cost=True))
    prob.add_term(joint_pos(n, 2, is_cost=False, targets="goal",
                            first_step=n - 1, last_step=n - 1))
    solver = make_solver(prob.build(), SQPParams())
    aot_cache.STATS.reset()
    for goal in (np.array([[1.0, 2.0]] * 3), np.array([[-1.5, 0.5]] * 3)):
        out = {}
        for dev in (cuda, torch.device("cpu")):
            x0 = torch.zeros(3, 2 * n, dtype=torch.float64, device=dev)
            out[dev.type] = solver(x0, *prob.bounds(x0), {"goal": goal})
        card, cpu = out["cuda"], out["cpu"]
        assert torch.equal(card.status.cpu(), cpu.status)
        np.testing.assert_allclose(card.x.cpu().numpy(), cpu.x.numpy(),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(cpu.x[:, -2:].numpy(), goal, atol=1e-4)
    assert aot_cache.STATS.replays > 0


def _flagship_poses(dev, dtype, B=16):
    """The flagship scene and its first convexification's poses on ``B``
    lanes (straight-line inits, LVS 2): the swept endpoints' and the
    sub-segment starts' (R, p, z, o), strided views of one FK call."""
    _, scene = pr2ish_table_problem(n_steps=30, lvs_substeps=2, device=dev)
    inits, _ = pr2ish_table_batch(0, B, 30, device=dev)
    x = inits.to(dtype)
    a, b = x[:, :-1], x[:, 1:]
    fr = torch.linspace(0.0, 1.0, 3, dtype=dtype, device=dev)
    q = a[:, :, None, :] + fr[:, None] * (b - a)[:, :, None, :]
    fk = scene.tree.fk_with_axes(q)
    return (scene, tuple(t[:, :, :-1] for t in fk),
            tuple(t[:, :, 1:] for t in fk), tuple(t[:, :, 0] for t in fk))


def _kernel_and_plain(scene, kind, fks, params=None):
    like = fks[0][0]
    plan = tfp.plan_of(scene, kind, like)
    n_jac = (2 if kind == "swept" else 1) * (len(fks[0]) > 2)
    got = scene._outputs(kind, like, n_jac)
    tfp.query_cuda(plan, fks, params, got)
    ref = tfp.query_plain(scene, plan, fks, params,
                          scene._outputs(kind, like, n_jac))
    return got, ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["swept", "pairs"])
def test_primitive_kernel_matches_plain(cuda, kind, dtype):
    """Kernel against plain version on the flagship's gaps (16 lanes),
    Jacobians and values: float64 within 1e-12 (d) and 1e-9 (J) on every
    query; float32 beyond 1e-5 / 1e-4 on at most 0.1 % of the queries
    (near ties of segment_box's scan), the values within 1e-5."""
    scene, f0, f1, fd = _flagship_poses(cuda, dtype)
    fks = (f0, f1) if kind == "swept" else (fd,)
    f64 = dtype == torch.float64
    d_tol, j_tol = (1e-12, 1e-9) if f64 else (1e-5, 1e-4)
    profiling.reset()
    for jac in (True, False):
        got, ref = _kernel_and_plain(
            scene, kind, tuple(f if jac else f[:2] for f in fks))
        dd = (got[0] - ref[0]).abs()
        bad = dd > d_tol
        for g, r in zip(got[1:], ref[1:]):
            bad |= (g - r).abs().amax(-1) > j_tol
        assert float(dd.max()) <= d_tol
        assert int(bad.sum()) <= (0 if f64 else 1e-3 * bad.numel())
    assert _count("collision.primitive.launches") == 2


def test_primitive_kernel_reads_broadcasts_as_strides(cuda):
    """One configuration broadcast over the lanes (stride 0) and a ball
    center broadcast over gaps and sub-segments give the contiguous
    copies' results bit for bit."""
    scene, f0, f1, _ = _flagship_poses(cuda, torch.float32, B=1)
    scene.add_world_sphere("ball", 0.1, center_param="ball")
    f0, f1 = (tuple(t.expand(6, *t.shape[1:]) for t in f)
              for f in (f0, f1))
    ball = torch.tensor([[0.7, -0.3, 0.8]], device=cuda).expand(6, 3)
    wide = _kernel_and_plain(scene, "swept", (f0, f1), {"ball": ball})[0]
    dense = _kernel_and_plain(
        scene, "swept", tuple(tuple(t.contiguous() for t in f)
                              for f in (f0, f1)),
        {"ball": ball.contiguous()})[0]
    for a, b in zip(wide, dense):
        assert torch.equal(a, b)


def _capsule_box_scene(dev):
    """One link capsule against one world box: every query of the swept
    entry is one group, a capsule swept against static geometry."""
    from trajopt_tpu_torch.collision import world as tw
    from trajopt_tpu_torch.models.robots import pr2ish
    scene = tw.CollisionScene(pr2ish())
    scene.add_link_capsule("r_forearm_link", 0.05, [0.0, 0.0, 0.0],
                           [0.3, 0.0, 0.0], name="arm")
    scene.add_world_box("table", [0.4, 0.5, 0.03], [0.7, -0.2, 0.6])
    return scene


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_primitive_kernel_one_group_ragged_and_empty(cuda, dtype):
    """A query of one kernel group (a capsule swept against a static box,
    four lanes a query) on 7 queries, against the plain version as
    ``test_primitive_kernel_matches_plain`` holds it, one launch a call;
    an empty batch launches nothing."""
    scene = _capsule_box_scene(cuda)
    tree = scene.tree
    rng = np.random.default_rng(4)
    q0 = rng.uniform(tree.lower, tree.upper, (7, 8))
    q1 = np.clip(q0 + 0.5 * rng.standard_normal((7, 8)), tree.lower,
                 tree.upper)
    q0, q1 = (torch.as_tensor(q, dtype=dtype, device=cuda) for q in (q0, q1))
    fks = (tree.fk_with_axes(q0), tree.fk_with_axes(q1))
    plan = tfp.plan_of(scene, "swept", fks[0][0])
    assert [(m, k) for m, k, _, _ in plan.kernel_groups] == \
        [("static", ("capsule", "box"))]
    f64 = dtype == torch.float64
    d_tol, j_tol = (1e-12, 1e-9) if f64 else (1e-5, 1e-4)
    profiling.reset()
    for jac in (True, False):
        got, ref = _kernel_and_plain(
            scene, "swept", tuple(f if jac else f[:2] for f in fks))
        dd = (got[0] - ref[0]).abs()
        bad = dd > d_tol
        for g, r in zip(got[1:], ref[1:]):
            bad |= (g - r).abs().amax(-1) > j_tol
        assert float(dd.max()) <= d_tol
        assert int(bad.sum()) <= (0 if f64 else 1e-3 * bad.numel())
    assert _count("collision.primitive.launches") == 2
    assert _count("collision.primitive.kernels") == 2
    empty = tuple(tuple(t[:0] for t in f) for f in fks)
    outs = scene._outputs("swept", empty[0][0], 2)
    tfp.query_cuda(plan, empty, None, outs)
    assert outs[0].shape == (0, scene.n_pairs)
    assert _count("collision.primitive.launches") == 2
    assert _count("collision.primitive.kernels") == 2


def test_primitive_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    scene, f0, f1, _ = _flagship_poses(cuda, torch.float32, B=2)
    plan = tfp.plan_of(scene, "swept", f0[0])
    outs = scene._outputs("swept", f0[0], 2)
    with pytest.raises(ValueError, match="cuda"):
        tfp.query_cuda(plan, tuple(tuple(t.cpu() for t in f)
                                   for f in (f0, f1)), None, outs)
    with pytest.raises(TypeError):
        tfp.query_cuda(plan, (tuple(t.half() for t in f0), f1), None, outs)
    with pytest.raises(ValueError, match="endpoint"):
        tfp.query_cuda(plan, (f0, f1[:2]), None, outs)
    with pytest.raises(ValueError, match="outputs"):
        tfp.query_cuda(plan, (f0, f1), None,
                       (outs[0], outs[1].transpose(-1, -2), outs[2]))
    with pytest.raises(ValueError, match="device or dtype"):
        tfp.query_cuda(plan, tuple(tuple(t.double() for t in f)
                                   for f in (f0, f1)), None,
                       tuple(o.double() for o in outs))


def test_primitive_query_refuses_transforms_and_grad(cuda):
    """The kernel returns values and Jacobians, not an autograd graph: a
    ``torch.func`` transform or an input that requires grad raises on the
    card (the CPU's plain version differentiates)."""
    scene, f0, f1, _ = _flagship_poses(cuda, torch.float32, B=2)
    f0, f1 = (tuple(t.contiguous() for t in f[:2]) for f in (f0, f1))
    with pytest.raises(ValueError, match="torch.func"):
        torch.func.vmap(lambda R0, p0, R1, p1: scene.swept_distances(
            (R0, p0), (R1, p1)))(*f0, *f1)
    with pytest.raises(ValueError, match="differentiate"):
        scene.swept_distances((f0[0], f0[1].requires_grad_(True)), f1)
    with torch.no_grad():
        assert torch.isfinite(scene.swept_distances(f0, f1)).all()


def test_captured_primitive_narrowphase_equals_eager(cuda):
    """A region holding the primitive kernel (the flagship scene's swept
    Jacobians), captured with ``aot_cache.cached_export``, replays equal
    to its eager run on new inputs; the wrapper is called while the
    region is warmed up and captured, not when it is replayed, and the
    launch counter counts the warm-up, every replay and every eager run."""
    scene, f0, f1, _ = _flagship_poses(cuda, torch.float32, B=4)
    f0, f1 = (tuple(t.contiguous() for t in f) for f in (f0, f1))

    def region(*ts):
        return scene.swept_distances_and_jac(ts[:4], ts[4:])

    args = (*f0, *f1)
    f = aot_cache.cached_export(region, args, "primitive-test", memo={})
    aot_cache.STATS.reset()
    profiling.reset()
    f(*args)
    captured_at = _count("collision.primitive.launches")
    assert captured_at >= 1 and aot_cache.STATS.captures == 1
    for step in (0.01, -0.02):
        moved = (*f0[:1], f0[1] + step, *f0[2:], *f1[:1], f1[1] + step,
                 *f1[2:])
        for a, b in zip(f(*moved), region(*moved)):
            assert torch.equal(a, b)
    assert aot_cache.STATS.replays >= 2
    # two replays and two eager runs
    assert _count("collision.primitive.launches") == captured_at + 4


# (B, T, D) of the Newton-Schulz refresh's tests: the flagship's QP shape
# at the benchmark cell's batch, and an odd shape (n = 91: no multiple of
# 4, steps of 7 rows straddling the residual kernel's 8-row tiles).
NS_SHAPES = {"flagship": (512, 30, 8), "odd": (7, 13, 7)}


def _ns_system(shape, dtype, dev, seed=0):
    """Seeded block-tridiagonal SPD systems M = I + sum of 4-row windows
    over K = 2 steps (eigenvalues in about [1, 11]) and seeds X0, the
    inverses of perturbed systems, the perturbation growing across lanes
    (so lanes stop apart); lane 3's seed is NaN (it takes the rescue).
    Returns (M, X0, band)."""
    B, T, D = NS_SHAPES[shape]
    rng = np.random.default_rng(seed)
    n, KD = T * D, 2 * D

    def windows(scale):
        W = rng.standard_normal((B, T - 1, 4, KD)) * scale
        out = np.zeros((B, n, n))
        for t in range(T - 1):
            out[:, t * D:t * D + KD, t * D:t * D + KD] += np.einsum(
                "brk,brl->bkl", W[:, t], W[:, t])
        return out

    M = np.eye(n) + windows(0.4)
    X0 = np.linalg.inv(M + windows(1.0)
                       * np.linspace(0.001, 0.1, B)[:, None, None])
    X0[3] = np.nan
    return (torch.as_tensor(M, dtype=dtype, device=dev).contiguous(),
            torch.as_tensor(X0, dtype=dtype, device=dev).contiguous(),
            (D, 1))


def _ns_states(monkeypatch):
    """Record each refresh's state (kernel or plain route) with every
    lane's residual and iterations at its stop, before the final residual
    (a rescue restarts the iteration counts)."""
    made = []

    def probe(cls):
        class Probe(cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

            def residual(self, tol, budget, mode):
                if mode == inv.FINAL and not hasattr(self, "r_stop"):
                    self.r_stop = self.r.clone().cpu()
                    kt = self.st[:, inv.S_KT] if isinstance(
                        self, inv._Card) else self.kt
                    self.kt_stop = kt.long().cpu()
                super().residual(tol, budget, mode)
        return Probe

    monkeypatch.setattr(inv, "_Card", probe(inv._Card))
    monkeypatch.setattr(inv, "_Plain", probe(inv._Plain))
    return made


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", sorted(NS_SHAPES))
def test_ns_kernels_match_plain_version(cuda, monkeypatch, shape, dtype):
    """The kernels (``ns_residual``, ``ns_update``) against the plain
    version on the card: per-lane iteration counts equal, in float32 except
    on a lane whose residual at the earlier stop lies within rounding of
    tol (1 % of it); X equal to rounding where the counts are; every lane
    that stopped on its test, the rescued one included, within tol in
    float64 arithmetic."""
    M, X0, band = _ns_system(shape, dtype, cuda)
    f32 = dtype == torch.float32
    tol = 1e-4 if f32 else 1e-10
    kw = dict(tol=tol, max_iter=25, power_iters=4, band=band)
    made = _ns_states(monkeypatch)
    before = _count("qp.ns.launches")
    X_k = inv.ns_inverse(M, X0, **kw)
    X_p = inv.ns_inverse_plain(M, X0, **kw)
    torch.cuda.synchronize()
    card, plain = made
    assert isinstance(card, inv._Card) and isinstance(plain, inv._Plain)
    # 25 iterations of two launches and the final residual, then the rescue
    assert _count("qp.ns.launches") - before >= 51
    kt_k, kt_p = card.kt_stop, plain.kt_stop
    B = M.shape[0]
    lanes = torch.arange(B) != 3
    diff = (kt_k != kt_p) & lanes
    if f32:
        early = torch.where(kt_k < kt_p, card.r_stop, plain.r_stop)
        assert ((kt_k - kt_p).abs()[diff] == 1).all()
        assert ((early[diff] / tol - 1).abs() <= 1e-2).all()
        assert int(diff.sum()) <= max(1, B // 50)
    else:
        assert not diff.any()
    assert int(kt_k.min()) < int(kt_k[lanes].max()) < 25   # lanes stop apart
    # the rescued lane's iterations, from its restart
    rescue_k = int(card.st[3, inv.S_KT])
    assert rescue_k > 0 and (rescue_k == int(plain.kt[3]) or f32)
    same = (~diff).to(cuda)
    scale = float(X_p.abs().max())
    assert float((X_k - X_p)[same].abs().max()) <= (1e-4 if f32 else 1e-9) \
        * scale
    assert torch.isfinite(X_k).all()
    Md, Xd = M.double(), X_k.double()
    r = torch.linalg.matrix_norm(torch.eye(M.shape[-1], dtype=Md.dtype,
                                           device=cuda) - Md @ Xd).cpu()
    stopped = kt_k < 25
    stopped[3] = True
    assert (r[stopped] <= tol).all()
    assert stopped.all()


def test_flagship_refresh_runs_the_kernels(cuda, monkeypatch):
    """A 6-step flagship solve (float32, 8 lanes): every refresh launches
    the kernels with one host read and none takes the plain route."""
    plain, calls, real = [], [], admm_block.ns_inverse

    class NoPlain(inv._Plain):
        def __init__(self, *a, **kw):
            plain.append(1)
            super().__init__(*a, **kw)

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(inv, "_Plain", NoPlain)
    monkeypatch.setattr(admm_block, "ns_inverse", counted)
    prob, _ = pr2ish_table_problem(n_steps=6, lvs_substeps=2)
    solve = prob.make_solve(flagship_params(), structured=True)
    inits, goals = pr2ish_table_batch(0, 8, 6)
    profiling.reset()
    res = solve(inits, {"goal": goals})
    got = profiling.counters()
    assert calls and not plain
    assert got["qp.ns.launches"] >= 51 * len(calls)
    assert got["host.syncs.qp.ns"] == len(calls)
    assert 0 < got["qp.ns.lane_iters"] <= got["qp.ns.lane_slots"]
    assert (res.status == SQPStatus.CONVERGED).all()


def _flagship_solve(dtype, lanes, hard_frac=0.0, perturb=None):
    """A 10-step flagship solve (LVS 2, the flagship's settings) on
    ``lanes`` seeded lanes in ``dtype`` (``make_solver``: ``make_solve``
    solves in float32 on the card); with ``perturb`` every init step after
    the first moved by a uniform +-1e-6 drawn from that seed."""
    from trajopt_tpu_torch.sqp.solver import make_solver
    prob, _ = pr2ish_table_problem(n_steps=10, lvs_substeps=2)
    inits, goals = pr2ish_table_batch(0, lanes, 10, dtype=dtype,
                                      hard_frac=hard_frac)
    if perturb is not None:
        noise = np.random.default_rng(perturb).uniform(
            -1e-6, 1e-6, (lanes, 9, inits.shape[-1]))
        inits = torch.cat([inits[:, :1], inits[:, 1:] + torch.as_tensor(
            noise, dtype=dtype, device=inits.device)], 1)
    x0 = inits.reshape(lanes, -1)
    return make_solver(prob.build(), flagship_params(), structured=True)(
        x0, *prob.bounds(x0), {"goal": goals})


def test_flagship_refreshes_on_kernels_equal_plain(cuda, monkeypatch):
    """Every refresh of a float64 10-step flagship solve (5 lanes, 2 on
    borderline goals; the chunk's plain version on the card) run by the
    kernels and by the plain version on the same system and seed: equal
    per-lane iterations and X within 1e-10 of its magnitude (the solve goes
    on with the kernels' X)."""
    monkeypatch.setattr(fb, "chunk", _plain_chunk)
    made = _ns_states(monkeypatch)
    seen = []

    def both(M, X0, **kw):
        X_k = inv.ns_inverse(M, X0, **kw)
        X_p = inv.ns_inverse_plain(M, X0, **kw)
        card, plain = made[-2:]
        seen.append((torch.equal(card.kt_stop, plain.kt_stop),
                     float((X_k - X_p).abs().max() / X_p.abs().max())))
        return X_k

    monkeypatch.setattr(admm_block, "ns_inverse", both)
    _flagship_solve(torch.float64, 5, hard_frac=0.4)
    assert len(seen) >= 2
    assert all(eq for eq, _ in seen), seen
    assert max(d for _, d in seen) <= 1e-10, seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_flagship_solve_with_kernel_refresh_equals_plain(cuda, monkeypatch,
                                                         dtype):
    """A 10-step flagship solve on 8 uniform lanes with the refresh's
    kernels against the same solve with its plain version, held as
    chip_smoke.py phase 6 holds a kernel route against its plain one:
    statuses equal and converged lanes' x within 1e-3 (float64 with the
    chunk's plain version, which alone takes float64)."""
    if dtype == torch.float64:
        monkeypatch.setattr(fb, "chunk", _plain_chunk)
    before = _count("qp.ns.launches")
    kernel = _flagship_solve(dtype, 8)
    assert kernel.x.dtype == dtype
    assert _count("qp.ns.launches") > before
    monkeypatch.setattr(admm_block, "ns_inverse", inv.ns_inverse_plain)
    plain = _flagship_solve(dtype, 8)
    assert torch.equal(kernel.status, plain.status)
    conv = kernel.status == SQPStatus.CONVERGED
    assert conv.any()
    assert float((kernel.x - plain.x)[conv].abs().max()) <= 1e-3


def test_flagship_float32_borderline_lanes_with_kernel_refresh(cuda,
                                                                monkeypatch):
    """A float32 10-step flagship solve on 16 lanes, 40 % on borderline
    goals, with the refresh's kernels against the same solve with its
    plain version.  The kernel route repeats itself bit for bit, so where
    the routes part it is the refresh's float32 rounding (its norms and
    products sum in another order) moving a borderline lane onto another
    path: statuses equal on every lane; a converged lane with equal SQP
    iteration and QP counts within 1e-3, or within 4x the plain route's
    own move under two 1e-6 changes of the inits (a borderline QP stopped
    at the float32 ADMM's loose tolerance moves that far, as
    ``chip_smoke.py`` phase 6 holds it); a lane whose counts changed may
    end elsewhere."""
    kernel = _flagship_solve(torch.float32, 16, hard_frac=0.4)
    again = _flagship_solve(torch.float32, 16, hard_frac=0.4)
    assert torch.equal(kernel.x, again.x)
    assert torch.equal(kernel.n_iter, again.n_iter)
    monkeypatch.setattr(admm_block, "ns_inverse", inv.ns_inverse_plain)
    plain = _flagship_solve(torch.float32, 16, hard_frac=0.4)
    own = torch.stack([
        (_flagship_solve(torch.float32, 16, hard_frac=0.4, perturb=k).x
         - plain.x).abs().amax(-1) for k in range(2)]).amax(0)
    dx = (kernel.x - plain.x).abs().amax(-1)
    seen = (f"statuses {kernel.status.tolist()} / {plain.status.tolist()}, "
            f"SQP iterations {kernel.n_iter.tolist()} / "
            f"{plain.n_iter.tolist()}, QP solves "
            f"{kernel.n_qp_solves.tolist()} / {plain.n_qp_solves.tolist()}, "
            f"|dx| {[f'{v:.2e}' for v in dx.tolist()]}, the plain route's "
            f"own move {[f'{v:.2e}' for v in own.tolist()]}")
    assert torch.equal(kernel.status, plain.status), seen
    same = (kernel.n_iter == plain.n_iter) \
        & (kernel.n_qp_solves == plain.n_qp_solves) \
        & (kernel.status == SQPStatus.CONVERGED)
    assert int(same.sum()) >= 8, seen
    limit = torch.clamp_min(4.0 * own, 1e-3)
    assert bool((dx[same] <= limit[same]).all()), seen
