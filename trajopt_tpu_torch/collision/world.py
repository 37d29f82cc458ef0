"""Collision scene: link-attached and static primitives, pair lists, and
batched discrete and swept (cast) signed-distance queries with joint-space
Jacobians.

Counterpart of ``trajopt_tpu/collision/world.py``, primitive subset
(sphere, capsule, box).  The candidate pair list is static, built on the
host in numpy; the narrowphase runs one batched kernel call per
(kind, kind) group over any leading batch shape.  Both queries take link
poses from ``tree.fk`` / ``tree.fk_with_axes`` rather than configurations,
so a caller batches them over lanes, steps and sub-segments at once.

Per-pair gradients: the JAX package takes ``jax.value_and_grad`` of a
scalar kernel per pair under ``vmap``.  Here each group's kernel runs on
the whole batch at once and ``torch.autograd.grad`` of the SUM of its
outputs returns every pair's own gradient (each output depends only on its
own pair's poses), which is the same subgradient without a per-pair
function transform.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np
import torch

from trajopt_tpu_torch.collision import geometry as geom
from trajopt_tpu_torch.kinematics.chain import KinematicTree
from trajopt_tpu_torch.kinematics.transforms import matvec

SPHERE, CAPSULE, BOX = "sphere", "capsule", "box"
_RANK = {SPHERE: 0, CAPSULE: 1, BOX: 2}


@dataclasses.dataclass(frozen=True)
class CollGeom:
    """One collision primitive.  link=None -> static world geometry."""

    name: str
    kind: str
    params: tuple[float, ...]       # sphere/capsule: (r,); box: (hx,hy,hz)
    link: Optional[str] = None
    R_local: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    p_local: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    # capsule endpoints in the local frame (after R_local/p_local)
    ea: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    eb: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))


def _pose_geom(Rl, pl, R_loc, p_loc, ea_loc, eb_loc):
    """World pose + capsule endpoints of geoms given their parent link
    poses (differentiable w.r.t. Rl/pl)."""
    R = Rl @ R_loc
    p = matvec(Rl, p_loc) + pl
    return R, p, matvec(R, ea_loc) + p, matvec(R, eb_loc) + p


def _scalar_kernel(key):
    """Discrete narrowphase kernel for a group key; pose_* = (R, p, ea, eb)
    world data, pr_* = padded params [..., 3]."""
    def kern(pose_a, pra, pose_b, prb):
        Ra, pa, eaa, eba = pose_a
        Rb, pb, eab, ebb = pose_b
        ra, rb = pra[..., 0], prb[..., 0]
        if key == (SPHERE, SPHERE):
            return geom.sphere_sphere(pa, ra, pb, rb)
        if key == (SPHERE, CAPSULE):
            return geom.sphere_capsule(pa, ra, eab, ebb, rb)
        if key == (SPHERE, BOX):
            return geom.sphere_box(pa, ra, Rb, pb, prb)
        if key == (CAPSULE, CAPSULE):
            return geom.capsule_capsule(eaa, eba, ra, eab, ebb, rb)
        if key == (CAPSULE, BOX):
            return geom.capsule_box(eaa, eba, ra, Rb, pb, prb)
        if key == (BOX, BOX):
            return geom.box_box_axis_aligned(Ra, pa, pra, Rb, pb, prb)
        if key == (BOX, "obb"):
            return geom.box_box(Ra, pa, pra, Rb, pb, prb)
        raise ValueError(f"unsupported group {key}")
    return kern


def _swept_scalar_kernel(key):
    """Swept kernel: geom `a` sweeps pose_a0 -> pose_a1 against static `b`.
    Swept spheres are exact (capsules); capsules take the two swept edge
    segments plus the endpoint poses; box-box is the Minkowski-sum segment
    distance; boxes against spheres/capsules take the endpoint min."""
    ka, kb = key

    def kern(pose_a0, pose_a1, pra, pose_b, prb):
        Ra0, pa0, eaa0, eba0 = pose_a0
        Ra1, pa1, eaa1, eba1 = pose_a1
        Rb, pb, eab, ebb = pose_b
        ra, rb = pra[..., 0], prb[..., 0]
        if ka == SPHERE:
            if kb == SPHERE:
                return geom.sphere_capsule(pb, rb, pa0, pa1, ra)
            if kb == CAPSULE:
                return geom.capsule_capsule(pa0, pa1, ra, eab, ebb, rb)
            if kb == BOX:
                return geom.capsule_box(pa0, pa1, ra, Rb, pb, prb)
        if ka == CAPSULE:
            segs = ((eaa0, eaa1), (eba0, eba1), (eaa0, eba0), (eaa1, eba1))
            if kb == SPHERE:
                ds = [geom.sphere_capsule(pb, rb, s, e, ra) for s, e in segs]
            elif kb == CAPSULE:
                ds = [geom.capsule_capsule(s, e, ra, eab, ebb, rb)
                      for s, e in segs]
            else:
                ds = [geom.capsule_box(s, e, ra, Rb, pb, prb)
                      for s, e in segs]
            return torch.amin(torch.stack(ds, -1), -1)
        if ka == BOX and kb == BOX:
            ha_in_b = matvec(geom.abs_(Rb.transpose(-1, -2) @ Ra0), pra)
            return geom.segment_box(pa0, pa1, Rb, pb, prb + ha_in_b)
        if ka == BOX:  # kb in (SPHERE, CAPSULE): endpoint min, swapped
            disc = _scalar_kernel((kb, ka))
            return torch.minimum(disc(pose_b, prb, pose_a0, pra),
                                 disc(pose_b, prb, pose_a1, pra))
        raise ValueError(f"unsupported swept group {key}")
    return kern


def _grads(out, leaves):
    """Per-element gradients of ``out`` w.r.t. each leaf (zeros where a
    leaf does not reach the output)."""
    gs = torch.autograd.grad(out.sum(), leaves, allow_unused=True)
    return [torch.zeros_like(l) if g is None else g
            for g, l in zip(gs, leaves)]


def _leaf(t):
    return t.detach().requires_grad_(True)


@dataclasses.dataclass
class CollisionScene:
    """Static candidate-pair scene over a kinematic tree."""

    tree: KinematicTree
    geoms: list[CollGeom] = dataclasses.field(default_factory=list)
    disabled_pairs: set[tuple[str, str]] = dataclasses.field(default_factory=set)
    # link-level allowed-collision matrix entries (SRDF <disable_collisions>)
    disabled_link_pairs: set[frozenset] = dataclasses.field(default_factory=set)
    check_self_collision: bool = True
    # Explicit candidate pairs as (name_a, name_b), moving geom first: set
    # by interop.scene_from_numpy to carry another scene's pair list over
    # verbatim; None -> derived by pairs() from adjacency and the ACM.
    pair_names: Optional[list[tuple[str, str]]] = None

    def add_geom(self, g: CollGeom) -> "CollisionScene":
        if g.kind not in _RANK:
            raise ValueError(f"unsupported geometry kind {g.kind!r}")
        self.geoms.append(g)
        self._swept_cache = None
        self._groups_cache = None
        self._tensor_cache = None
        return self

    def add_world_box(self, name, half_extents, center=(0, 0, 0), R=None):
        return self.add_geom(CollGeom(name, BOX, tuple(half_extents), link=None,
                                      R_local=np.eye(3) if R is None else np.asarray(R),
                                      p_local=np.asarray(center, float)))

    def add_world_sphere(self, name, radius, center=(0, 0, 0)):
        return self.add_geom(CollGeom(name, SPHERE, (float(radius),), link=None,
                                      p_local=np.asarray(center, float)))

    def add_link_sphere(self, link, radius, center=(0, 0, 0), name=None):
        return self.add_geom(CollGeom(name or f"{link}_sphere", SPHERE,
                                      (float(radius),), link=link,
                                      p_local=np.asarray(center, float)))

    def add_link_capsule(self, link, radius, ea, eb, name=None):
        return self.add_geom(CollGeom(name or f"{link}_capsule", CAPSULE,
                                      (float(radius),), link=link,
                                      ea=np.asarray(ea, float),
                                      eb=np.asarray(eb, float)))

    def add_link_box(self, link, half_extents, center=(0, 0, 0), name=None):
        return self.add_geom(CollGeom(name or f"{link}_box", BOX,
                                      tuple(half_extents), link=link,
                                      p_local=np.asarray(center, float)))

    # -------------------------------------------------------------- pairs

    def _adjacent(self, la: str, lb: str) -> bool:
        for k in range(len(self.tree.joints)):
            pl = self.tree.link_names[self.tree.parent_link[k]]
            cl = self.tree.link_names[self.tree.child_link[k]]
            if {pl, cl} == {la, lb}:
                return True
        return False

    def _is_active(self, g: CollGeom) -> bool:
        """Whether the geom moves with q (rides a link an active joint
        drives)."""
        if g.link is None:
            return False
        return bool(np.any(self.tree.ancestor[self.tree.link_id(g.link)]))

    def _moves_mask(self, g: CollGeom) -> np.ndarray:
        if g.link is None:
            return np.zeros(self.tree.n_dof, bool)
        return np.asarray(self.tree.ancestor[self.tree.link_id(g.link)], bool)

    def pairs(self) -> list[tuple[CollGeom, CollGeom]]:
        """All candidate pairs, moving geom first: moving-vs-world and
        non-adjacent moving-vs-moving pairs whose relative pose depends on
        q, minus the ACM."""
        if self.pair_names is not None:
            by_name = {g.name: g for g in self.geoms}
            return [(by_name[a], by_name[b]) for a, b in self.pair_names]
        out = []
        for ga, gb in itertools.combinations(self.geoms, 2):
            if not np.any(self._moves_mask(ga) ^ self._moves_mask(gb)):
                continue
            if ga.link is not None and gb.link is not None:
                if not self.check_self_collision:
                    continue
                if ga.link == gb.link or self._adjacent(ga.link, gb.link):
                    continue
                if frozenset((ga.link, gb.link)) in self.disabled_link_pairs:
                    continue
            if (ga.name, gb.name) in self.disabled_pairs or \
               (gb.name, ga.name) in self.disabled_pairs:
                continue
            if not self._is_active(ga):
                ga, gb = gb, ga
            out.append((ga, gb))
        return out

    @property
    def n_pairs(self) -> int:
        return len(self.pairs())

    def _orientation_constant(self, g: CollGeom) -> bool:
        """True when the geom's world orientation cannot change with q."""
        if g.link is None:
            return True
        lid = self.tree.link_id(g.link)
        is_rev = self.tree._active_types() == 0
        return not bool(np.any(self.tree.ancestor[lid] & is_rev))

    def _static_world_R(self, g: CollGeom) -> np.ndarray:
        if g.link is None:
            return np.asarray(g.R_local, float)
        if getattr(self, "_fk0_cache", None) is None:
            R0, _ = self.tree.fk(torch.zeros(self.tree.n_dof,
                                             dtype=torch.float64))
            self._fk0_cache = R0.numpy()
        return (self._fk0_cache[self.tree.link_id(g.link)]
                @ np.asarray(g.R_local, float))

    def _boxbox_aligned(self, ga: CollGeom, gb: CollGeom) -> bool:
        """Whether the per-axis gap formula is exact for this box pair
        (host-side numpy decision)."""
        if not (self._orientation_constant(ga)
                and self._orientation_constant(gb)):
            return False
        Rr = self._static_world_R(ga).T @ self._static_world_R(gb)
        a = np.abs(Rr)
        return bool(np.all(np.minimum(a, np.abs(a - 1.0)) < 1e-9))

    def _geom_arrays(self, geoms):
        """Stacked per-geom numpy arrays for one narrowphase group."""
        return {
            "link": np.array([self.tree.link_id(g.link) if g.link else -1
                              for g in geoms]),
            "is_static": np.array([g.link is None for g in geoms]),
            "R": np.stack([g.R_local for g in geoms]).astype(float),
            "p": np.stack([g.p_local for g in geoms]).astype(float),
            "ea": np.stack([g.ea for g in geoms]).astype(float),
            "eb": np.stack([g.eb for g in geoms]).astype(float),
            "params": np.stack([np.pad(np.asarray(g.params, float),
                                       (0, 3 - len(g.params)))
                                for g in geoms]),
        }

    def _swept_groups(self):
        """Static per-type grouping for the swept narrowphase:
        (moving_groups, static_groups), each a list of (key, idxs, a, b)
        with numpy arrays.  moving: both geoms ride robot links (endpoint
        min of the discrete kernels); static: geom `a` sweeps against
        configuration-static `b` (closed-form swept kernels)."""
        if getattr(self, "_swept_cache", None) is not None:
            return self._swept_cache
        moving: dict = {}
        static: dict = {}
        for idx, (ga, gb) in enumerate(self.pairs()):
            if self._is_active(gb):
                if _RANK[ga.kind] > _RANK[gb.kind]:
                    ga, gb = gb, ga
                key = (ga.kind, gb.kind)
                if key == (BOX, BOX) and not self._boxbox_aligned(ga, gb):
                    key = (BOX, "obb")
                moving.setdefault(key, []).append((idx, ga, gb))
            else:
                static.setdefault((ga.kind, gb.kind), []).append(
                    (idx, ga, gb))

        def pack(groups):
            return [(key, np.array([i for i, _, _ in items]),
                     self._geom_arrays([ga for _, ga, _ in items]),
                     self._geom_arrays([gb for _, _, gb in items]))
                    for key, items in groups.items()]

        mv, st = pack(moving), pack(static)
        order = np.concatenate([g[1] for g in mv + st])
        self._swept_cache = (mv, st, np.argsort(order))
        return self._swept_cache

    def _pair_groups(self):
        """Static per-type grouping for the discrete narrowphase: a list of
        (key, idxs, a, b) with the lower-ranked kind on side ``a`` (sphere <
        capsule < box) and box pairs that are not mutually axis-aligned
        under (BOX, "obb"), plus the inverse permutation back to pair
        order."""
        if getattr(self, "_groups_cache", None) is not None:
            return self._groups_cache
        groups: dict = {}
        for idx, (ga, gb) in enumerate(self.pairs()):
            if _RANK[ga.kind] > _RANK[gb.kind]:
                ga, gb = gb, ga
            key = (ga.kind, gb.kind)
            if key == (BOX, BOX) and not self._boxbox_aligned(ga, gb):
                key = (BOX, "obb")
            groups.setdefault(key, []).append((idx, ga, gb))
        out = [(key, np.array([i for i, _, _ in items]),
                self._geom_arrays([ga for _, ga, _ in items]),
                self._geom_arrays([gb for _, _, gb in items]))
               for key, items in groups.items()]
        order = np.concatenate([g[1] for g in out])
        self._groups_cache = (out, np.argsort(order))
        return self._groups_cache

    def _tensors(self, arrs, like: torch.Tensor):
        """Group arrays as tensors on ``like``'s device/dtype (cached)."""
        if getattr(self, "_tensor_cache", None) is None:
            self._tensor_cache = {}
        key = (id(arrs), like.device, like.dtype)
        if key not in self._tensor_cache:
            dev, dt = like.device, like.dtype
            t = {k: torch.as_tensor(v, dtype=dt, device=dev)
                 for k, v in arrs.items() if k not in ("link", "is_static")}
            t["link"] = torch.as_tensor(np.maximum(arrs["link"], 0),
                                        device=dev)
            t["is_static"] = torch.as_tensor(arrs["is_static"], device=dev)
            t["mask"] = torch.as_tensor(
                self.tree.ancestor[np.maximum(arrs["link"], 0)]
                * (~arrs["is_static"])[:, None], dtype=dt, device=dev)
            self._tensor_cache[key] = (arrs, t)
        return self._tensor_cache[key][1]

    def _link_poses(self, t, R, p):
        """Parent link poses [..., Pg, 3, 3] / [..., Pg, 3] of a group side;
        identity for static geoms."""
        static = t["is_static"]
        Rl = torch.where(static[:, None, None],
                         torch.eye(3, dtype=R.dtype, device=R.device),
                         R[..., t["link"], :, :])
        pl = torch.where(static[:, None], torch.zeros((), dtype=p.dtype,
                                                      device=p.device),
                         p[..., t["link"], :])
        return Rl, pl

    def _posed(self, t, R, p):
        """World pose + capsule endpoints for a group side."""
        Rl, pl = self._link_poses(t, R, p)
        return _pose_geom(Rl, pl, t["R"], t["p"], t["ea"], t["eb"])

    def _compose_pose_grads(self, gR, gp, Rl, pl, t, z, zxo, is_rev):
        """[..., Pg, n_dof] joint-space gradient of one side's link pose
        gradients: revolute dd/dq_j = z_j.(p_l x gp + sum_c R_c x gR_c)
        - (z_j x o_j).gp; prismatic z_j.gp; static rows masked to zero."""
        m = geom.cross(pl, gp) + geom.cross(
            Rl.transpose(-1, -2), gR.transpose(-1, -2)).sum(-2)
        zt = z[..., None, :, :]                       # [..., 1, n_dof, 3]
        term_rev = (m[..., None, :] * zt).sum(-1) \
            - (gp[..., None, :] * zxo[..., None, :, :]).sum(-1)
        term_pri = (gp[..., None, :] * zt).sum(-1)
        return t["mask"] * torch.where(is_rev, term_rev, term_pri)

    def _group_distance(self, key, ta, tb, pose_a, pose_b):
        return _scalar_kernel(key)(pose_a, ta["params"], pose_b,
                                   tb["params"])

    def _swept_group_distance(self, key, ta, tb, pose_a0, pose_a1, pose_b):
        return _swept_scalar_kernel(key)(pose_a0, pose_a1, ta["params"],
                                         pose_b, tb["params"])

    def _assemble(self, parts, inv_perm):
        return torch.cat(parts, -1)[..., inv_perm]

    def distances(self, fk) -> torch.Tensor:
        """[..., n_pairs] signed distances at link poses ``fk = (R, p)``
        from ``tree.fk`` (the JAX function takes one configuration q)."""
        R, p = fk[0], fk[1]
        groups, inv_perm = self._pair_groups()
        parts = []
        for key, _, a, b in groups:
            ta, tb = self._tensors(a, R), self._tensors(b, R)
            parts.append(self._group_distance(key, ta, tb,
                                              self._posed(ta, R, p),
                                              self._posed(tb, R, p)))
        return self._assemble(parts, torch.as_tensor(inv_perm,
                                                     device=R.device))

    def distances_and_jac(self, fk):
        """(ds [..., P], J [..., P, n_dof]) at link poses and joint axes
        ``fk = (R, p, z, o)`` from ``tree.fk_with_axes``: each pair's
        gradient w.r.t. its two link poses, composed through the
        geometric-Jacobian relations."""
        R, p, z, o = fk
        zxo = geom.cross(z, o)
        is_rev = torch.as_tensor(self.tree._active_types() == 0,
                                 device=R.device)
        groups, inv_perm = self._pair_groups()
        ds, Js = [], []
        with torch.enable_grad():
            for key, _, a, b in groups:
                ta, tb = self._tensors(a, R), self._tensors(b, R)
                leaves = [_leaf(v) for v in (*self._link_poses(ta, R, p),
                                             *self._link_poses(tb, R, p))]
                Ra, pa, Rb, pb = leaves
                d = self._group_distance(
                    key, ta, tb,
                    _pose_geom(Ra, pa, ta["R"], ta["p"], ta["ea"], ta["eb"]),
                    _pose_geom(Rb, pb, tb["R"], tb["p"], tb["ea"], tb["eb"]))
                g = _grads(d, leaves)
                Ra, pa, Rb, pb = (v.detach() for v in leaves)
                ds.append(d.detach())
                Js.append(self._compose_pose_grads(g[0], g[1], Ra, pa, ta, z,
                                                   zxo, is_rev)
                          + self._compose_pose_grads(g[2], g[3], Rb, pb, tb,
                                                     z, zxo, is_rev))
        ip = torch.as_tensor(inv_perm, device=R.device)
        return self._assemble(ds, ip), torch.cat(Js, -2)[..., ip, :]

    def swept_distances(self, fk0, fk1) -> torch.Tensor:
        """[..., n_pairs] signed distances of geometry swept between two
        endpoint pose sets ``fk0 = (R0, p0)`` and ``fk1 = (R1, p1)`` (link
        poses from ``tree.fk``; the JAX function takes q0/q1 and optional
        precomputed poses, the port always takes the poses so adjacent LVS
        sub-segments share their endpoint FK)."""
        R0, p0 = fk0[0], fk0[1]
        R1, p1 = fk1[0], fk1[1]
        moving, static, inv_perm = self._swept_groups()
        parts = []
        for key, _, a, b in moving:
            ta, tb = self._tensors(a, R0), self._tensors(b, R0)
            d0 = self._group_distance(key, ta, tb, self._posed(ta, R0, p0),
                                      self._posed(tb, R0, p0))
            d1 = self._group_distance(key, ta, tb, self._posed(ta, R1, p1),
                                      self._posed(tb, R1, p1))
            parts.append(torch.minimum(d0, d1))
        for key, _, a, b in static:
            ta, tb = self._tensors(a, R0), self._tensors(b, R0)
            parts.append(self._swept_group_distance(
                key, ta, tb, self._posed(ta, R0, p0),
                self._posed(ta, R1, p1), self._posed(tb, R0, p0)))
        return self._assemble(parts, torch.as_tensor(inv_perm,
                                                     device=R0.device))

    def swept_distances_and_jac(self, fk0, fk1):
        """(ds [..., P], J0 [..., P, n_dof], J1 [..., P, n_dof]) of the
        swept check between endpoint poses ``fk0 = (R0, p0, z0, o0)`` and
        ``fk1`` (from ``tree.fk_with_axes``): per-pair pose gradients
        composed through the geometric-Jacobian relations at each
        endpoint."""
        R0, p0, z0, o0 = fk0
        R1, p1, z1, o1 = fk1
        zxo0 = geom.cross(z0, o0)
        zxo1 = geom.cross(z1, o1)
        is_rev = torch.as_tensor(self.tree._active_types() == 0,
                                 device=R0.device)
        moving, static, inv_perm = self._swept_groups()

        def c0(gR, gp, Rl, pl, t):
            return self._compose_pose_grads(gR, gp, Rl, pl, t, z0, zxo0,
                                            is_rev)

        def c1(gR, gp, Rl, pl, t):
            return self._compose_pose_grads(gR, gp, Rl, pl, t, z1, zxo1,
                                            is_rev)

        ds, J0s, J1s = [], [], []
        with torch.enable_grad():
            for key, _, a, b in moving:
                ta, tb = self._tensors(a, R0), self._tensors(b, R0)
                leaves = [_leaf(v) for v in (*self._link_poses(ta, R0, p0),
                                             *self._link_poses(tb, R0, p0),
                                             *self._link_poses(ta, R1, p1),
                                             *self._link_poses(tb, R1, p1))]
                Ra0, pa0, Rb0, pb0, Ra1, pa1, Rb1, pb1 = leaves
                loc_a = (ta["R"], ta["p"], ta["ea"], ta["eb"])
                loc_b = (tb["R"], tb["p"], tb["ea"], tb["eb"])
                d0 = self._group_distance(key, ta, tb,
                                          _pose_geom(Ra0, pa0, *loc_a),
                                          _pose_geom(Rb0, pb0, *loc_b))
                d1 = self._group_distance(key, ta, tb,
                                          _pose_geom(Ra1, pa1, *loc_a),
                                          _pose_geom(Rb1, pb1, *loc_b))
                d = torch.minimum(d0, d1)
                g = _grads(d, leaves)
                Ra0, pa0, Rb0, pb0, Ra1, pa1, Rb1, pb1 = (
                    v.detach() for v in leaves)
                ds.append(d.detach())
                J0s.append(c0(g[0], g[1], Ra0, pa0, ta)
                           + c0(g[2], g[3], Rb0, pb0, tb))
                J1s.append(c1(g[4], g[5], Ra1, pa1, ta)
                           + c1(g[6], g[7], Rb1, pb1, tb))
            for key, _, a, b in static:
                ta, tb = self._tensors(a, R0), self._tensors(b, R0)
                leaves = [_leaf(v) for v in (*self._link_poses(ta, R0, p0),
                                             *self._link_poses(ta, R1, p1))]
                Ra0, pa0, Ra1, pa1 = leaves
                loc_a = (ta["R"], ta["p"], ta["ea"], ta["eb"])
                d = self._swept_group_distance(
                    key, ta, tb, _pose_geom(Ra0, pa0, *loc_a),
                    _pose_geom(Ra1, pa1, *loc_a), self._posed(tb, R0, p0))
                g = _grads(d, leaves)
                Ra0, pa0, Ra1, pa1 = (v.detach() for v in leaves)
                ds.append(d.detach())
                J0s.append(c0(g[0], g[1], Ra0, pa0, ta))
                J1s.append(c1(g[2], g[3], Ra1, pa1, ta))
        ip = torch.as_tensor(inv_perm, device=R0.device)
        return (self._assemble(ds, ip), torch.cat(J0s, -2)[..., ip, :],
                torch.cat(J1s, -2)[..., ip, :])
