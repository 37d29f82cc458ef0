"""The primitive narrowphase kernel's arithmetic on the CPU: its device
functions (``csrc/primitive_narrowphase.cuh``) compiled as host C++
(``csrc/primitive_host.cpp``, g++) and driven through the wrapper's own
layout (``fused_primitive.query_host``), held in float64 against the JAX
package and the plain PyTorch version on the pr2ish gaps of
``test_torch_collision`` (penetrating gaps and q0 == q1 ties included),
against the plain version for every group key the kernel takes on a small
synthetic scene, through strided batches with per-lane ``center_param``
centers; and the wrapper's dispatch by device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_collision import _gaps
from trajopt_tpu.models.robots import pr2ish_scene as jax_pr2ish_scene
from trajopt_tpu_torch.collision import fused_primitive as fp
from trajopt_tpu_torch.collision import geometry as geom
from trajopt_tpu_torch.collision import world as tw
from trajopt_tpu_torch.models.robots import pr2ish, pr2ish_scene
from trajopt_tpu_torch.utils import profiling


def _count(name):
    """The registry's counter ``name`` (0 before its first count)."""
    return profiling.counters().get(name, 0)


torch.set_num_threads(2)

TOL = 1e-9


def _host(scene, kind, fks, params=None):
    """The host build's outputs of ``scene``'s primitive groups (every
    column the kernel writes) and the plan."""
    like = fks[0][0]
    plan = fp.plan_of(scene, kind, like)
    jac = len(fks[0]) > 2
    outs = scene._outputs(kind, like, (2 if kind == "swept" else 1) * jac)
    outs = tuple(o.fill_(float("nan")) for o in outs)
    fp.query_host(plan, fks, params, outs)
    return outs, plan


@pytest.fixture(scope="module")
def pr2ish_reference():
    """JAX's swept entry on the gaps and discrete entry at their
    endpoints (float64)."""
    scene = jax_pr2ish_scene()
    q0, q1 = (jnp.asarray(v) for v in _gaps())
    swept = jax.jit(jax.vmap(scene.swept_distances_and_jac))(q0, q1)
    disc = jax.jit(jax.vmap(scene.distances_and_jac))(
        jnp.concatenate([q0, q1]))
    return [np.asarray(v) for v in (*swept, *disc)]


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=TOL, err_msg=what)


def test_host_build_swept_matches_jax_and_plain(pr2ish_reference):
    scene = pr2ish_scene()
    tree = scene.tree
    q0, q1 = (torch.as_tensor(v) for v in _gaps())
    f0, f1 = tree.fk_with_axes(q0), tree.fk_with_axes(q1)
    got, plan = _host(scene, "swept", (f0, f1))
    assert not plan.plain and len(plan.kernel_groups) == 5
    plain = scene.swept_distances_and_jac(f0, f1)
    for name, g, j, p in zip(("d", "J0", "J1"), got, pr2ish_reference[:3],
                             plain):
        _close(g, j, f"{name} against JAX")
        _close(g, p, f"{name} against plain")
    (d,), _ = _host(scene, "swept", (f0[:2], f1[:2]))
    _close(d, pr2ish_reference[0], "value-only d against JAX")
    assert float(d.min()) < -0.01 and float(d[13:22].min()) < 0.0


def test_host_build_discrete_matches_jax_and_plain(pr2ish_reference):
    scene = pr2ish_scene()
    q = torch.as_tensor(np.concatenate(_gaps()))
    fk = scene.tree.fk_with_axes(q)
    got, plan = _host(scene, "pairs", (fk,))
    assert not plan.plain
    plain = scene.distances_and_jac(fk)
    for name, g, j, p in zip(("d", "J"), got, pr2ish_reference[3:], plain):
        _close(g, j, f"{name} against JAX")
        _close(g, p, f"{name} against plain")
    (d,), _ = _host(scene, "pairs", (fk[:2],))
    _close(d, pr2ish_reference[3], "value-only d against JAX")


def synthetic_scene() -> tw.CollisionScene:
    """Every group key the kernel takes, and box-box ones it does not: a
    link box on the right forearm, link spheres and capsules on the right
    arm and the head, a world sphere whose center comes from
    ``params["ball"]``, a world capsule and a world box."""
    s = tw.CollisionScene(pr2ish())
    s.add_link_box("r_forearm_link", [0.12, 0.04, 0.03], [0.15, 0.0, 0.0],
                   name="rbox")
    s.add_link_sphere("r_wrist_roll_link", 0.05, [0.02, 0.0, 0.0],
                      name="rs")
    s.add_link_capsule("r_upper_arm_link", 0.06, [0.05, 0.0, 0.0],
                       [0.35, 0.0, 0.0], name="rc")
    s.add_link_capsule("r_gripper_link", 0.03, [0.02, 0.0, 0.0],
                       [0.16, 0.0, 0.0], name="gc")
    s.add_link_sphere("head_link", 0.12, name="hs")
    s.add_world_sphere("ball", 0.1, center_param="ball")
    s.add_geom(tw.CollGeom("rod", tw.CAPSULE, (0.04,),
                           ea=np.array([0.5, -0.6, 0.4]),
                           eb=np.array([0.6, 0.2, 1.2])))
    s.add_world_box("table", [0.3, 0.5, 0.03], [0.8, -0.1, 0.65])
    return s


def _synthetic_inputs(n=10, seed=3):
    """Seeded gaps (the last three with q0 == q1) and per-lane ball
    centers near the arm."""
    tree = pr2ish()
    rng = np.random.default_rng(seed)
    q0 = rng.uniform(tree.lower, tree.upper, (n, 8))
    q1 = np.clip(q0 + 0.4 * rng.standard_normal((n, 8)), tree.lower,
                 tree.upper)
    q1[-3:] = q0[-3:]
    ball = rng.uniform([0.3, -0.6, 0.5], [0.8, 0.2, 1.3], (n, 3))
    return (torch.as_tensor(q0), torch.as_tensor(q1),
            {"ball": torch.as_tensor(ball)})


@pytest.fixture(scope="module")
def synthetic():
    """Host build and plain version of the synthetic scene's four entry
    points (float64)."""
    scene = synthetic_scene()
    q0, q1, params = _synthetic_inputs()
    f0, f1 = scene.tree.fk_with_axes(q0), scene.tree.fk_with_axes(q1)
    out = {}
    for kind, fks, plain in (
            ("pairs", (f0,), scene.distances_and_jac(f0, params)),
            ("swept", (f0, f1), scene.swept_distances_and_jac(f0, f1,
                                                               params))):
        got, plan = _host(scene, kind, fks, params)
        (d,), _ = _host(scene, kind, tuple(f[:2] for f in fks), params)
        out[kind] = (plan, got, d, plain)
    out["d"] = out["pairs"][3][0]
    return out


def test_synthetic_scene_covers_every_key(synthetic):
    taken = {(m, k) for kind in ("pairs", "swept")
             for m, k, _, _ in synthetic[kind][0].kernel_groups}
    assert taken == fp.KEYS
    left = {(g.mode, g.key) for kind in ("pairs", "swept")
            for g in synthetic[kind][0].plain}
    assert left and not left & fp.KEYS
    d = synthetic["d"]
    assert float(d.min()) < 0.0 < float(d.max())


@pytest.mark.parametrize("mode,key", sorted(fp.KEYS))
def test_host_build_matches_plain_for_every_key(synthetic, mode, key):
    kind = "pairs" if mode == "pairs" else "swept"
    plan, got, d, plain = synthetic[kind]
    (group,) = [g for g in plan.groups if (g.mode, g.key) == (mode, key)]
    cols = torch.as_tensor(group.idx)
    names = ("d", "J") if kind == "pairs" else ("d", "J0", "J1")
    for name, g, p in zip(names, got, plain):
        dim = -1 if name == "d" else -2
        _close(g.index_select(dim, cols), p.index_select(dim, cols),
               f"{mode} {key} {name}")
    _close(d.index_select(-1, cols), plain[0].index_select(-1, cols),
           f"{mode} {key} value-only d")


def test_host_build_splits_tied_segments_as_plain():
    """A capsule swept against static geometry with q0 == q1: its two
    endpoint capsules (segments 2 and 3) tie exactly, and the sweeps of its
    ends (0 and 1) are points of them, so the per-segment evaluation must
    add the tied segments' tangents in amin's order and divide by their
    count: float64 d and J0, J1 within 1e-12 of the plain version."""
    scene = synthetic_scene()
    q0, _, params = _synthetic_inputs(n=4, seed=8)
    f0 = scene.tree.fk_with_axes(q0)
    got, plan = _host(scene, "swept", (f0, f0), params)
    plain = scene.swept_distances_and_jac(f0, f0, params)
    groups = [g for g in plan.groups
              if g.mode == "static" and g.key[0] == "capsule"]
    assert {g.key[1] for g in groups} == {"sphere", "capsule", "box"}
    ties = 0
    for g in groups:        # queries whose least segment value is tied
        _, _, ea, eb = fp.side_pose(scene._side(g.ta, f0[0], f0[1], params))
        Rb, pb, eab, ebb = fp.side_pose(scene._side(g.tb, f0[0], f0[1],
                                                    params))
        ra, rb = g.ta["params"][..., 0], g.tb["params"][..., 0]
        segs = ((ea, ea), (eb, eb), (ea, eb), (ea, eb))
        if g.key[1] == "sphere":
            ds = [geom.sphere_capsule(pb, rb, a, b, ra) for a, b in segs]
        elif g.key[1] == "capsule":
            ds = [geom.capsule_capsule(a, b, ra, eab, ebb, rb)
                  for a, b in segs]
        else:
            ds = [geom.capsule_box(a, b, ra, Rb, pb, g.tb["params"])
                  for a, b in segs]
        ds = torch.stack(ds, -1)
        ties += int(((ds == ds.amin(-1, keepdim=True)).sum(-1) > 1).sum())
    assert ties >= 4 * len(groups) // 2
    cols = torch.as_tensor(np.concatenate([g.idx for g in groups]))
    for name, g, p_ in zip(("d", "J0", "J1"), got, plain):
        dim = -1 if name == "d" else -2
        np.testing.assert_allclose(
            g.index_select(dim, cols).numpy(),
            p_.index_select(dim, cols).numpy(), rtol=0, atol=1e-12,
            err_msg=f"tied segments {name}")
    assert float(got[1].index_select(-2, cols).abs().max()) > 0.0


def test_host_build_reads_strided_batches_and_lane_params():
    """LVS-style sub-segment views [B, G, n_sub] of one FK call (not
    contiguous), a per-lane ball center broadcast over gaps and
    sub-segments, against the plain version."""
    scene = synthetic_scene()
    q0, q1, params = _synthetic_inputs(n=4)
    fr = torch.linspace(0.0, 1.0, 3, dtype=torch.float64)
    qs = q0[:, None, None, :] + fr[:, None] * (q1 - q0)[:, None, None, :]
    qs = qs.expand(4, 3, 3, 8)                       # [B, G, n_sub + 1]
    R, p, z, o = scene.tree.fk_with_axes(qs)
    f0 = tuple(t[:, :, :-1] for t in (R, p, z, o))
    f1 = tuple(t[:, :, 1:] for t in (R, p, z, o))
    assert not f0[0].is_contiguous()
    got, plan = _host(scene, "swept", (f0, f1), params)
    plain = scene.swept_distances_and_jac(f0, f1, params)
    cols = torch.as_tensor(np.concatenate(
        [g.idx for g in plan.groups if (g.mode, g.key) in fp.KEYS]))
    for k, (g, p_) in enumerate(zip(got, plain)):
        dim = -1 if k == 0 else -2
        _close(g.index_select(dim, cols), p_.index_select(dim, cols),
               "strided swept")
    fk = tuple(t[:, 0] for t in (R, p, z, o))
    got, _ = _host(scene, "pairs", (fk,), params)
    plain = scene.distances_and_jac(fk, params)
    cols = torch.as_tensor(np.concatenate(
        [g.idx for g in fp.plan_of(scene, "pairs", R).groups
         if (g.mode, g.key) in fp.KEYS]))
    for k, (g, p_) in enumerate(zip(got, plain)):
        dim = -1 if k == 0 else -2
        _close(g.index_select(dim, cols), p_.index_select(dim, cols),
               "strided discrete")


def test_query_dispatches_by_device(monkeypatch):
    scene = synthetic_scene()
    q0, q1, params = _synthetic_inputs(n=3)
    tree = scene.tree

    def refuse(*args, **kw):
        raise AssertionError("the kernel route ran on CPU tensors")

    profiling.reset()
    monkeypatch.setattr(fp, "query_cuda", refuse)
    f0, f1 = tree.fk_with_axes(q0), tree.fk_with_axes(q1)
    plan = fp.plan_of(scene, "swept", f0[0])
    outs = scene._outputs("swept", f0[0], 2)
    got = fp.query(scene, "swept", (f0, f1), params, outs)
    ref = fp.query_plain(scene, plan, (f0, f1), params, outs)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert _count("collision.primitive.launches") == 0
    monkeypatch.undo()
    # meta tensors (a problem's row-count check) get the outputs' shapes
    meta = tuple(t.to("meta") for t in f0)
    d, J0, J1 = scene.swept_distances_and_jac(meta, meta, params)
    P = scene.n_pairs
    assert d.device.type == "meta" and tuple(d.shape) == (3, P)
    assert tuple(J0.shape) == tuple(J1.shape) == (3, P, 8)
    # the kernel route refuses CPU tensors, and its host build CUDA ones
    with pytest.raises(ValueError, match="cuda"):
        fp.query_cuda(plan, (f0, f1), params, outs)
    with pytest.raises(ValueError):
        fp.query_host(plan, (f0, f1[:2]), params, outs)


def test_bound_counts():
    """The bound's operation and byte counts: Jacobians cost more than
    values, a capsule's four swept segments more than a sphere's one, and
    the bytes count each input once and the outputs."""
    for mode, key in fp.KEYS:
        assert fp.primitive_flops(mode, key, True, 8) > \
            fp.primitive_flops(mode, key, False, 8) > 0
    assert fp.primitive_flops("static", ("capsule", "box"), True, 8) > \
        fp.primitive_flops("static", ("sphere", "box"), True, 8)
    # a capsule swept against a static box, Jacobians, 8 joints: 3 poses,
    # four segments at 6 slots each (597 plain + 239 x (1 + 2 x 6)), two
    # endpoints' twists of 2 points and 8 columns
    assert fp.primitive_flops("static", ("capsule", "box"), True, 8) == \
        3 * 99 + 4 * (597 + 239 * 13) + 2 * (21 * 2 + 22 * 8) == 15549
    scene = pr2ish_scene()
    q = torch.zeros(5, 8, dtype=torch.float64)
    fk = scene.tree.fk_with_axes(q)
    plan = fp.plan_of(scene, "pairs", fk[0])
    outs = scene._outputs("pairs", fk[0], 1)
    tables = sum(t.numel() * t.element_size()
                 for t in (plan.ftab, plan.itab, plan.coef, plan.rev))
    centers = 2 * 91 * 3 * 8                # broadcast over the lanes
    fk_bytes = sum(t.numel() * 8 for t in fk)
    out_bytes = 5 * 91 * 9 * 8
    assert fp.primitive_bytes(plan, (fk,), outs) == \
        fk_bytes + tables + centers + out_bytes
