"""Port parity: the convex narrowphase (``collision/convex.py``) and the
convex branches of ``collision/world.py`` against the JAX package, float64
on the CPU.

``convex_convex`` on the batteries of the JAX package's
``tests/test_convex.py`` -- vertex-form primitives, separated and
penetrating random hulls, grazing pairs built 2e-4 to 1e-3 apart along the
GJK witness -- values to 1e-10 and envelope gradients (w.r.t. vertices
and axes) to 1e-9; the GJK weights, the 4x4 subset solves and
``hull_of`` equal; the unified pr2ish scene's and a hull scene's four
query functions to 1e-9 with equal groups; a call split over lanes equal
to the unsplit call bit for bit.  The search of ``collision/fused_convex.py``
(the kernel's plain version) on the same battery: its GJK weights and its
SAT gap equal the JAX functions', and the wrapper's dispatch; the
witness's sorting network against ``torch.sort``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.collision import convex as jcvx
from trajopt_tpu.collision.world import CollisionScene as JScene
from trajopt_tpu.models import robots as jrobots
from trajopt_tpu.models.benchmarks import (ARM7_GOAL, ARM7_HOME,
                                           PR2ISH_GOAL, PR2ISH_HOME)
from trajopt_tpu_torch.collision import convex as tcvx
from trajopt_tpu_torch.collision import fused_convex as tfc
from trajopt_tpu_torch.collision import world as tworld
from trajopt_tpu_torch.collision.world import CollisionScene as TScene
from trajopt_tpu_torch.models import robots as trobots

torch.set_num_threads(2)

VAL_TOL, GRAD_TOL, SCENE_TOL = 1e-10, 1e-9, 1e-9
ARM7_TURN = np.array([0.9, 0.6, 0.5, -1.6, 0.4, 1.1, 0.7])


def _box(half, center=(0.0, 0.0, 0.0)):
    return np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                     for sz in (-1, 1)]) * np.asarray(half, float) \
        + np.asarray(center, float)


def _pad(rows, n):
    """Edge-mode vertex padding (the scene's layout), or zero rows for
    normals/edges."""
    rows = np.asarray(rows, float).reshape(-1, 3)
    if len(rows) == 0:
        return np.zeros((n, 3))
    return np.pad(rows, ((0, n - len(rows)), (0, 0)), mode="edge")


def _pairs():
    """Hull pairs of the JAX tests' batteries: (Va, ra, Vb, rb, Na, Nb,
    Ea, Eb)."""
    out = [(np.zeros((1, 3)), 0.5, np.array([[2.0, 0, 0]]), 0.3,
            None, None, None, None),
           (np.zeros((1, 3)), 0.5, np.array([[0.6, 0, 0]]), 0.3,
            None, None, None, None),
           (np.array([[-0.3, 0.0, 0.0], [0.3, 0.0, 0.0]]), 0.1,
            _box([0.2] * 3, [0.0, 0.0, 1.0]), 0.0, None, np.eye(3),
            np.array([[1.0, 0, 0]]), np.eye(3))]
    for off in (1.6, 1.1, 0.8, 0.5):
        out.append((_box([0.5] * 3), 0.0, _box([0.5] * 3, [off, 0, 0]), 0.0,
                    np.eye(3), np.eye(3), np.eye(3), np.eye(3)))
    # random hulls, separated and overlapping (test_hull_distance_...)
    rng = np.random.default_rng(3)
    for _ in range(6):
        A, Na, Ea = tcvx.hull_of(rng.normal(size=(40, 3)))
        B, Nb, Eb = tcvx.hull_of(rng.normal(size=(40, 3))
                                 + np.array([4.0, 0.5, 0]))
        out.append((A, 0.0, B, 0.0, Na, Nb, Ea, Eb))
    # penetrating clouds (test_gjk_certificate_residual_at_penetration)
    rng = np.random.default_rng(7)
    for _ in range(6):
        A, Na, Ea = tcvx.hull_of(rng.normal(size=(30, 3)))
        B, Nb, Eb = tcvx.hull_of(rng.normal(size=(30, 3))
                                 + rng.uniform(-0.3, 0.3, size=3))
        out.append((A, 0.05, B, 0.0, Na, Nb, Ea, Eb))
    # grazing: separated pairs moved along the GJK witness to a gap of
    # 2e-4 .. 1e-3 (test_grazing_battery_no_false_penetration)
    rng = np.random.default_rng(11)
    for _ in range(6):
        A, Na, Ea = tcvx.hull_of(rng.normal(size=(40, 3)))
        B, Nb, Eb = tcvx.hull_of(rng.normal(size=(40, 3))
                                 + np.array([5.0, 0.5, 0.0]))
        wa, wb = (np.asarray(w) for w in jcvx._gjk_weights(
            jnp.asarray(A), jnp.asarray(B)))
        z = wa @ A - wb @ B
        d0 = np.linalg.norm(z)
        B = B + (d0 - rng.uniform(2e-4, 1e-3)) * z / d0
        out.append((A, 0.0, B, 0.0, Na, Nb, Ea, Eb))
    return out


def _batch(pairs):
    """Stacked inputs (numpy): Va, ra, Vb, rb, axes, valid."""
    n_v = max(max(len(p[0]), len(p[2])) for p in pairs)
    Va, Vb, ra, rb, axes, valid = [], [], [], [], [], []
    k = 0
    rows = []
    for A, r_a, B, r_b, Na, Nb, Ea, Eb in pairs:
        ax = [np.zeros((0, 3)) if v is None else np.asarray(v, float)
              for v in (Na, Nb)]
        if Ea is not None and Eb is not None:
            cx, _ = jcvx.edge_cross_axes(
                jnp.asarray(Ea), jnp.ones(len(Ea), bool), jnp.asarray(Eb),
                jnp.ones(len(Eb), bool))
            ax.append(np.asarray(cx))
        ax = np.concatenate(ax)
        rows.append(ax)
        k = max(k, len(ax), 1)
        Va.append(_pad(A, n_v))
        Vb.append(_pad(B, n_v))
        ra.append(r_a)
        rb.append(r_b)
    for ax in rows:
        axes.append(_pad(ax, k) if len(ax) else np.zeros((k, 3)))
        valid.append(np.arange(k) < len(ax))
    return (np.stack(Va), np.array(ra), np.stack(Vb), np.array(rb),
            np.stack(axes), np.stack(valid))


@pytest.fixture(scope="module")
def battery():
    args = _batch(_pairs())
    Va, ra, Vb, rb, axes, valid = (jnp.asarray(a) for a in args)

    def f(va, vb, ax, r_a, r_b, v):
        return jcvx.convex_convex(va, r_a, vb, r_b, ax, v)

    # Op by op: under jit XLA fuses a*b + c into one rounding wherever it
    # fuses, which moves near-ties (a winning face normal leaves the face's
    # vertices tied up to rounding) and so the subgradient.
    with jax.disable_jit():
        d, g = jax.vmap(jax.value_and_grad(f, argnums=(0, 1, 2)))(
            Va, Vb, axes, ra, rb, valid)
    return args, np.asarray(d), [np.asarray(x) for x in g]


def test_battery_covers_both_branches(battery):
    _, d, _ = battery
    assert (d < -1e-3).sum() >= 6 and (d > 0).sum() >= 10
    assert ((d > 0) & (d < 2e-3)).sum() >= 5      # grazing pairs


def test_convex_convex_values_and_gradients_match_jax(battery):
    (Va, ra, Vb, rb, axes, valid), d_j, g_j = battery
    leaves = [torch.tensor(a, requires_grad=True) for a in (Va, Vb, axes)]
    d = tcvx.convex_convex(leaves[0], torch.as_tensor(ra), leaves[1],
                           torch.as_tensor(rb), leaves[2],
                           torch.as_tensor(valid))
    g = torch.autograd.grad(d.sum(), leaves)
    np.testing.assert_allclose(d.detach().numpy(), d_j, rtol=0,
                               atol=VAL_TOL)
    for gt, gj in zip(g, g_j):
        np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=GRAD_TOL)


def test_gjk_weights_match_jax(battery):
    (Va, _, Vb, _, _, _), _, _ = battery
    with jax.disable_jit():
        wa_j, wb_j = jax.vmap(jcvx._gjk_weights)(jnp.asarray(Va),
                                                 jnp.asarray(Vb))
    wa, wb = tcvx._gjk_weights(torch.as_tensor(Va), torch.as_tensor(Vb))
    np.testing.assert_allclose(wa.numpy(), np.asarray(wa_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(wb.numpy(), np.asarray(wb_j), rtol=0,
                               atol=1e-12)


def _selection(args):
    """The plain search's inputs and result on the battery (torch)."""
    Va, _, Vb, _, axes, valid = (torch.as_tensor(a) for a in args)
    cax = Va.mean(-2) - Vb.mean(-2)
    return (Va, Vb, axes, valid, cax), tfc.select_plain(Va, Vb, axes, valid,
                                                        cax)


def test_selection_gjk_weights_match_jax(battery):
    """The search's best simplex, as vertex weights, equals JAX
    ``_gjk_weights``; its witness vector is the weights' witness."""
    args, _, _ = battery
    (Va, Vb, _, _, _), sel = _selection(args)
    with jax.disable_jit():
        wa_j, wb_j = jax.vmap(jcvx._gjk_weights)(jnp.asarray(args[0]),
                                                 jnp.asarray(args[2]))
    for idx, V, w_j in ((sel.idA, Va, wa_j), (sel.idB, Vb, wb_j)):
        w = tcvx._slot_weights(idx, sel.lam, V.shape[-2])
        np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0,
                                   atol=1e-12)
    z_j = np.einsum("bn,bnk->bk", np.asarray(wa_j), args[0]) \
        - np.einsum("bn,bnk->bk", np.asarray(wb_j), args[2])
    np.testing.assert_allclose(sel.z.numpy(), z_j, rtol=0, atol=1e-12)


def test_selection_sat_gap_matches_jax(battery):
    """The winning gap recomputed from the search's axis and vertices
    equals JAX ``_sat_depth`` over the same K + 2 axes, on the separated
    and on the penetrating pairs."""
    args, _, _ = battery
    (Va, Vb, axes, valid, cax), sel = _selection(args)
    full = tcvx._all_axes(axes, cax, sel.z)
    fvalid = torch.cat([valid, torch.ones(len(valid), 2, dtype=torch.bool)],
                       -1)
    gap = tcvx._sat_gap(Va, Vb, tcvx._gather_rows(full, sel.k)[..., 0, :],
                        sel.flip, sel.ia, sel.ib)
    with jax.disable_jit():
        gap_j = np.asarray(jax.vmap(jcvx._sat_depth)(
            *(jnp.asarray(t.numpy()) for t in (Va, Vb, full, fvalid))))
    assert (gap_j > 0).sum() >= 10 and (gap_j < -1e-3).sum() >= 6
    np.testing.assert_allclose(gap.numpy(), gap_j, rtol=0, atol=VAL_TOL)
    np.testing.assert_allclose(
        tcvx._sat_depth(Va, Vb, full, fvalid).numpy(), gap_j, rtol=0,
        atol=VAL_TOL)


def test_selection_dispatch(battery):
    """CPU tensors take the plain search (no launch counted); meta tensors
    get the outputs' shapes; the kernel's launcher refuses CPU tensors
    before it builds anything."""
    args, _, _ = battery
    inputs, plain = _selection(args)
    before = tfc.COUNTER.launches
    got = tfc.select(*inputs)
    assert tfc.COUNTER.launches == before
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    meta = tfc.select(*(t.to("meta") for t in inputs))
    for a, b in zip(meta, plain):
        assert a.device.type == "meta"
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    with pytest.raises(ValueError, match="CUDA"):
        tfc.select_cuda(*inputs)


def test_batch_layout_reads_broadcasts_as_strides():
    """The kernel's batch indexing: size-1 dims dropped, neighbours every
    tensor steps through as one merged, broadcast dims kept at stride 0,
    more than MAX_DIMS strided dims refused."""
    Va = torch.zeros(3, 1, 5, 7, 4, 3)
    Vb = torch.zeros(5, 7, 8, 3).expand(3, 1, 5, 7, 8, 3)
    valid = torch.ones(5, 7, 2, dtype=torch.bool).expand(3, 1, 5, 7, 2)
    sizes, strides = tfc._batch_layout(Va.shape[:-2], [Va, Vb, valid])
    assert sizes == [3, 35]
    assert strides == [[420, 12], [0, 24], [0, 2]]
    steps = valid[:, :, :1].expand(3, 1, 5, 7, 2)    # one mask a pair
    sizes, strides = tfc._batch_layout(Va.shape[:-2], [Va, Vb, steps])
    assert sizes == [3, 5, 7]
    assert strides == [[420, 84, 12], [0, 168, 24], [0, 0, 2]]
    odd = torch.zeros(2, 2, 2, 2, 2, 6, 3)[..., ::2, :]
    sizes, strides = tfc._batch_layout(odd.shape[:-2], [odd])
    assert sizes == [32] and strides == [[18]]
    flipped = torch.zeros(2, 2, 2, 2, 2, 4, 3).permute(4, 3, 2, 1, 0, 5, 6)
    with pytest.raises(ValueError, match="at most"):
        tfc._batch_layout(flipped.shape[:-2], [flipped])
    assert tfc.select_flops(4, 8, 17) > 25_000


def test_sort4_matches_torch_sort():
    """The witness's sorting network gives ``torch.sort``'s values on
    random int64 rows, rows with duplicates and edge-mode padded index 0
    (every slot at vertex 0 and mixes of it)."""
    rng = np.random.default_rng(5)
    rows = [rng.integers(0, 40, (200, 4)), rng.integers(0, 3, (200, 4)),
            np.zeros((1, 4), np.int64), np.array([[0, 7, 0, 3], [5, 0, 0, 0],
                                                  [2, 2, 1, 1]]),
            np.array(list(np.ndindex(4, 4, 4, 4)))]
    for r in rows:
        idx = torch.as_tensor(r, dtype=torch.long)
        got = tcvx._sort4(idx)
        assert got.dtype == torch.long
        assert torch.equal(got, torch.sort(idx, dim=-1, stable=True).values)
    batched = torch.as_tensor(rng.integers(0, 9, (3, 5, 4)))
    assert torch.equal(tcvx._sort4(batched),
                       torch.sort(batched, dim=-1).values)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gjk_stops_at_its_fixed_point(dtype):
    """A query stopped after its ``gjk_steps`` (the step that returns its
    slots and weights bit for bit, where the search kernel stops it) has
    the best simplex of all 16 steps, on random pairs of 4 x 8 and of
    30 x 40 vertices (a third of them padded edge-mode)."""
    rng = np.random.default_rng(11)
    for A, B in ((4, 8), (30, 40)):
        Va = rng.normal(size=(300, A, 3))
        Va[:100, -1] = Va[:100, 0]
        Vb = rng.normal(size=(300, B, 3)) + rng.normal(size=(300, 1, 3))
        Va, Vb = (torch.as_tensor(v, dtype=dtype) for v in (Va, Vb))
        steps = tfc.gjk_steps(Va, Vb)
        assert steps.shape == (300,) and steps.dtype == torch.long
        assert int(steps.min()) >= 1 and int(steps.max()) <= tcvx.GJK_ITERS
        assert int((steps < tcvx.GJK_ITERS).sum()) > 0
        full = tcvx._gjk_slots(Va, Vb)
        for s in steps.unique().tolist():
            m = steps == s
            for a, b in zip(tcvx._gjk_slots(Va[m], Vb[m], s), full):
                assert torch.equal(a, b[m])


def test_simplex_subproblem_matches_jax():
    rng = np.random.default_rng(0)
    W = rng.normal(size=(64, 4, 3))
    W[:8, 3] = W[:8, 2]                    # degenerate (repeated) points
    W[8:16] *= 1e-3
    G = np.einsum("bij,bkj->bik", W, W) + np.eye(4)
    b = rng.normal(size=(64, 4))
    with jax.disable_jit():     # op by op, as the battery
        chol = jax.vmap(jcvx._chol4_solve)(jnp.asarray(G), jnp.asarray(b))
        lam = jax.vmap(jcvx._closest_on_simplex)(jnp.asarray(W))
    np.testing.assert_allclose(
        tcvx._chol4_solve(torch.as_tensor(G), torch.as_tensor(b)).numpy(),
        np.asarray(chol), rtol=0, atol=1e-12)
    got = tcvx._closest_on_simplex(torch.as_tensor(W)).numpy()
    lam = np.asarray(lam)
    # the 8 rows with a repeated point may split its weight either way
    np.testing.assert_allclose(got[8:], lam[8:], rtol=0, atol=1e-12)
    merged = np.concatenate([got[:8, :2], got[:8, 2:].sum(-1, keepdims=True)],
                            -1)
    np.testing.assert_allclose(
        merged, np.concatenate([lam[:8, :2], lam[:8, 2:].sum(-1,
                                                             keepdims=True)],
                               -1), rtol=0, atol=1e-12)


def test_edge_cross_axes_match_jax():
    rng = np.random.default_rng(1)
    ea, eb = rng.normal(size=(4, 3)), rng.normal(size=(3, 3))
    va, vb = np.array([1, 1, 0, 1], bool), np.array([1, 0, 1], bool)
    c_j, v_j = jcvx.edge_cross_axes(jnp.asarray(ea), jnp.asarray(va),
                                    jnp.asarray(eb), jnp.asarray(vb))
    c, v = tcvx.edge_cross_axes(torch.as_tensor(ea), torch.as_tensor(va),
                                torch.as_tensor(eb), torch.as_tensor(vb))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), rtol=0,
                               atol=1e-15)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_j))


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_hull_of_matches_jax(seed):
    pts = np.random.default_rng(seed).normal(size=(50, 3))
    for kw in ({}, {"max_vertices": 12, "max_edges": 5}):
        for t, j in zip(tcvx.hull_of(pts, **kw), jcvx.hull_of(pts, **kw)):
            np.testing.assert_array_equal(t, j)


def _hull_scene(pkg):
    """arm7 with convex hulls on three links, a sphere, self-collision on,
    a world hull and a world box -- the same scene in either package."""
    rng = np.random.default_rng(4)
    clouds = [0.08 * rng.normal(size=(20, 3)) + [0, 0, 0.2]
              for _ in range(3)]
    world = 0.1 * rng.normal(size=(25, 3)) + [0.45, 0.1, 0.9]
    robots, Scene = (jrobots, JScene) if pkg == "jax" else (trobots, TScene)
    s = Scene(robots.arm7(), check_self_collision=True)
    for link, c in zip(("link_2", "link_4", "link_6"), clouds):
        s.add_link_convex(link, c)
    s.add_link_sphere("link_7", 0.05, [0, 0, 0.08])
    s.add_link_capsule("link_3", 0.05, [0, 0, 0.0], [0, 0, 0.2])
    s.add_world_convex("rock", world, radius=0.01)
    s.add_world_box("post", [0.05, 0.05, 0.30], [0.39, 0.03, 1.00])
    return s


def _unified(pkg):
    s = (jrobots if pkg == "jax" else trobots).pr2ish_scene()
    s.unify_narrowphase = True
    return s


SCENES = {"unified_pr2ish": _unified, "hulls_arm7": _hull_scene}


def _configs(tree, n_dof, home, goal):
    """(q [G, n], q0, q1): a straight line home -> goal through obstacles,
    random configurations and gaps, and q0 == q1 gaps."""
    rng = np.random.default_rng(0)
    w = np.linspace(0.0, 1.0, 8)[:, None]
    line = home * (1 - w) + goal * w
    rand0 = rng.uniform(tree.lower, tree.upper, (4, n_dof))
    rand1 = np.clip(rand0 + 0.3 * rng.standard_normal((4, n_dof)),
                    tree.lower, tree.upper)
    same = 0.5 * (line[:-1] + line[1:])[::2]
    q0 = np.concatenate([line[:-1], rand0, same])
    q1 = np.concatenate([line[1:], rand1, same])
    return np.concatenate([line, rand0]), q0, q1


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene_case(request):
    name = request.param
    js, ts = SCENES[name]("jax"), SCENES[name]("torch")
    if name == "unified_pr2ish":
        q, q0, q1 = _configs(ts.tree, 8, PR2ISH_HOME, PR2ISH_GOAL)
    else:
        # A line that moves every joint: along ARM7_HOME -> ARM7_GOAL only
        # the base joint moves, so every self pair keeps its relative pose,
        # the swept minimum's two endpoints tie up to rounding and either
        # endpoint's gradient is right: those gaps (appended below) are
        # held by J0 + J1.
        q, q0, q1 = _configs(ts.tree, 7, ARM7_HOME, ARM7_TURN)
    if name == "hulls_arm7":
        # gaps along ARM7_HOME -> ARM7_GOAL appended (the tie case below)
        w = np.linspace(0.0, 1.0, 6)[:, None]
        line = ARM7_HOME * (1 - w) + ARM7_GOAL * w
        q0, q1 = np.concatenate([q0, line[:-1]]), np.concatenate([q1,
                                                                line[1:]])
    # the JAX value-only functions' distances are these functions' values;
    # one compile
    dj, sj = jax.tree.map(np.asarray, jax.jit(lambda a, b, c: (
        jax.vmap(js.distances_and_jac)(a),
        jax.vmap(js.swept_distances_and_jac)(b, c)))(
            *(jnp.asarray(v) for v in (q, q0, q1))))
    ref = dict(d=dj[0], dj=dj, s=sj[0], sj=sj)
    return name, js, ts, (q, q0, q1), ref


def test_scene_groups_match_jax(scene_case):
    _, js, ts, _, _ = scene_case
    assert [(a.name, b.name) for a, b in ts.pairs()] == \
        [(a.name, b.name) for a, b in js.pairs()]
    groups, sdf, _ = ts._pair_groups()
    assert [(k, list(i)) for k, i, _, _ in groups] == \
        [(k, list(i)) for k, i, _, _ in js._pair_groups()]
    mv, st, _, _ = ts._swept_groups()
    jmv, jst, _ = js._swept_groups()
    for got, ref in ((mv, jmv), (st, jst)):
        assert [(k, list(i)) for k, i, _, _ in got] == \
            [(k, list(i)) for k, i, _, _ in ref]
        for (_, _, a, b), (_, _, ja, jb) in zip(got, ref):
            for side, jside in ((a, ja), (b, jb)):
                for key in side:
                    if key != "p_params":
                        np.testing.assert_array_equal(side[key], jside[key])


def test_scene_queries_match_jax(scene_case):
    name, _, ts, (q, q0, q1), ref = scene_case
    tree = ts.tree
    q, q0, q1 = (torch.as_tensor(v) for v in (q, q0, q1))
    d = ts.distances(tree.fk(q))
    dj, J = ts.distances_and_jac(tree.fk_with_axes(q))
    s = ts.swept_distances(tree.fk(q0), tree.fk(q1))
    sj, J0, J1 = ts.swept_distances_and_jac(tree.fk_with_axes(q0),
                                            tree.fk_with_axes(q1))
    assert ref["d"].min() < 0 and ref["s"].min() < 0   # penetration seen
    n = ref["sj"][1].shape[0] - (5 if name == "hulls_arm7" else 0)
    for got, want in ((d, ref["d"]), (dj, ref["dj"][0]), (J, ref["dj"][1]),
                      (s, ref["s"]), (sj, ref["sj"][0]),
                      (J0[:n], ref["sj"][1][:n]), (J1[:n], ref["sj"][2][:n]),
                      (J0[n:] + J1[n:], ref["sj"][1][n:] + ref["sj"][2][n:])):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=SCENE_TOL)


def test_lane_split_is_bit_identical(monkeypatch):
    """A convex group split over lanes (a tiny ``CONVEX_CHUNK_ELEMS``)
    returns the unsplit call's bits."""
    scene = _unified("torch")
    tree = scene.tree
    rng = np.random.default_rng(2)
    q0 = torch.as_tensor(rng.uniform(tree.lower, tree.upper, (5, 2, 8)))
    q1 = q0 + 0.2 * torch.as_tensor(rng.standard_normal((5, 2, 8)))
    f0, f1 = tree.fk_with_axes(q0), tree.fk_with_axes(q1)
    whole = scene.swept_distances_and_jac(f0, f1) + \
        scene.distances_and_jac(f0)
    monkeypatch.setattr(tworld, "CONVEX_CHUNK_ELEMS", 1)
    assert len(scene._lane_slices(("convex", "convex"),
                                  *(scene._tensors(g, q0) for g in
                                    scene._swept_groups()[1][0][2:]),
                                  f0[0], swept=True)) == 5
    split = scene.swept_distances_and_jac(f0, f1) + \
        scene.distances_and_jac(f0)
    for a, b in zip(whole, split):
        assert torch.equal(a, b)


def test_max_cross_edges_caps_edge_arrays():
    """The scene's cross-edge cap truncates the ranked edge set; the
    separated distance does not move (JAX: test_max_cross_edges_...)."""
    pts = np.random.default_rng(5).normal(size=(60, 3))
    out = []
    for cap in (4, 6):
        for pkg, robots, Scene in (("jax", jrobots, JScene),
                                   ("torch", trobots, TScene)):
            s = Scene(robots.boxbot())
            s.max_cross_edges = cap
            s.add_link_convex("boxbot_link", pts)
            s.add_world_convex("whull", pts * 0.8 + np.array([3.0, 0.2, 0.1]))
            groups = s._pair_groups()
            groups = groups[0] if pkg == "torch" else groups
            (_, _, a, b), = groups
            assert a["edges"].shape[1] <= cap and b["edges"].shape[1] <= cap
            if pkg == "jax":
                out.append(float(jax.jit(s.distances)(jnp.zeros(2))[0]))
            else:
                out.append(float(s.distances(s.tree.fk(
                    torch.zeros(2, dtype=torch.float64)))[0]))
    np.testing.assert_allclose(out, out[0], rtol=0, atol=1e-9)


def test_convex_p_param_is_rejected():
    s = TScene(trobots.boxbot())
    s.add_link_sphere("boxbot_link", 0.2)
    s.add_world_box("b", [0.1] * 3, center_param="c")
    s.unify_narrowphase = True
    with pytest.raises(ValueError, match="p_param"):
        s.distances(s.tree.fk(torch.zeros(2, dtype=torch.float64)),
                    {"c": torch.zeros(3, dtype=torch.float64)})
