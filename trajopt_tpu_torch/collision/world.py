"""Collision scene: link-attached and static geometry, pair lists, and
batched discrete and swept (cast) signed-distance queries with joint-space
Jacobians.

Counterpart of ``trajopt_tpu/collision/world.py``: spheres, capsules and
boxes with closed-form kernels (``geometry.py``), convex hulls with the GJK
+ SAT narrowphase (``convex.py``, its search a CUDA kernel on the card:
``fused_convex.py``; it also serves every pair under
``unify_narrowphase``), and SDF-grid worlds (``sdf_grid.py``).  The
candidate pair list is static, built on the host in numpy; the
narrowphase runs one batched call per (kind, kind) group over any leading
batch shape, and one per SDF pair.  The queries take link poses from
``tree.fk`` / ``tree.fk_with_axes`` rather than configurations, so a caller
batches them over lanes, steps and sub-segments at once, and an optional
``params`` dict supplies the centers of world geometry registered with
``center_param`` (randomized scenes): ``params[key]`` is ``[*lead, 3]``,
its leading axes the first axes of the batch (one center per lane, say).

Per-pair gradients: the JAX package takes ``jax.value_and_grad`` of a
scalar kernel per pair under ``vmap``.  Here each group's kernel runs on
the whole batch at once and ``torch.autograd.grad`` of the SUM of its
outputs returns every pair's own gradient (each output depends only on its
own pair's poses), which is the same subgradient without a per-pair
function transform.  The primitive groups (spheres, capsules, boxes) go
to ``fused_primitive.query``: on the card one hand-written kernel launch
computes all of a query's primitive distances and Jacobians, in forward
mode, straight into the outputs' pair order; on the CPU that module's
plain version runs the autograd code.  Each query allocates its outputs in
pair order and copies the other groups' results into their columns (in
place on the card, out of place on the CPU; see ``fused_primitive.put``).

Convex groups split their work over lanes when one call would hold more
than ``CONVEX_CHUNK_ELEMS`` SAT projection entries (queries x vertices x
axes), the plain search's largest temporaries: every query's arithmetic is
independent of the others', so the split call returns the unsplit call's
bits.  The split is decided from shapes alone, on the card too (where the
kernel holds no projections), so a captured region never changes it.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Optional

import numpy as np
import torch

from trajopt_tpu_torch.collision import fused_primitive as fp
from trajopt_tpu_torch.collision import geometry as geom
from trajopt_tpu_torch.collision import sdf_grid as sg
from trajopt_tpu_torch.collision.convex import (_rotate, convex_convex,
                                                edge_cross_axes, hull_of)
from trajopt_tpu_torch.kinematics import urdf as urdf_mod
from trajopt_tpu_torch.kinematics.chain import KinematicTree
from trajopt_tpu_torch.kinematics.transforms import matvec, rpy_matrix
from trajopt_tpu_torch.utils import forget_on_device, on_device

SPHERE, CAPSULE, BOX, SDF = "sphere", "capsule", "box", "sdf"
# Convex polytope (mesh hull) geometry: vertex set + face normals + edge
# directions, narrowphase collision/convex.py (GJK + SAT).
CONVEX = "convex"
_RANK = {SPHERE: 0, CAPSULE: 1, BOX: 2, CONVEX: 3, SDF: 4}
_CONVEX_KEY = (CONVEX, CONVEX)
# SAT projection entries (queries x vertices x axes) one convex group call
# may hold before it is split over lanes (2**28: 1 GiB in float32).
CONVEX_CHUNK_ELEMS = 1 << 28


@dataclasses.dataclass(frozen=True)
class CollGeom:
    """One collision geometry.  link=None -> static world geometry."""

    name: str
    kind: str
    params: tuple[float, ...]       # sphere/capsule: (r,); box: (hx,hy,hz)
    link: Optional[str] = None
    R_local: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    p_local: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    # capsule endpoints in the local frame (after R_local/p_local)
    ea: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    eb: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    # SDF-grid world geometry (kind == "sdf"; static only)
    grid: object = None
    # params key supplying this static geom's world center at solve time
    p_param: Optional[str] = None
    # Convex polytope data (kind == "convex") in the LINK frame: hull
    # vertices [V,3], deduplicated outward face normals [F,3], deduplicated
    # unit edge directions [E,3]; params = (radius,) of the sphere-swept form.
    verts: Optional[np.ndarray] = None
    normals: Optional[np.ndarray] = None
    edges: Optional[np.ndarray] = None


def _canon_vertex_form(g: CollGeom):
    """(verts [V,3], normals [F,3], edge directions [E,3], radius) of ANY
    geom as a sphere-swept vertex set in its link frame -- the form the
    convex narrowphase consumes: hull = own vertices/normals/edges + r,
    sphere = 1 vertex + r, capsule = 2 vertices + its axis edge + r, box =
    8 corners + its 3 face normals (which double as its edge
    directions)."""
    R = np.asarray(g.R_local, float)
    p = np.asarray(g.p_local, float)
    no_rows = np.zeros((0, 3))
    if g.kind == CONVEX:
        return np.asarray(g.verts, float), \
            (np.asarray(g.normals, float) if g.normals is not None
             else no_rows), \
            (np.asarray(g.edges, float) if g.edges is not None
             else no_rows), float(g.params[0]) if g.params else 0.0
    if g.kind == SPHERE:
        return p[None, :], no_rows, no_rows, float(g.params[0])
    if g.kind == CAPSULE:
        ea = R @ np.asarray(g.ea, float) + p
        eb = R @ np.asarray(g.eb, float) + p
        ax = eb - ea
        n = np.linalg.norm(ax)
        edges = (ax / n)[None, :] if n > 1e-12 else no_rows
        return np.stack([ea, eb]), no_rows, edges, float(g.params[0])
    if g.kind == BOX:
        h = np.asarray(g.params, float)
        corners = np.array([[sx, sy, sz] for sx in (-1, 1)
                            for sy in (-1, 1) for sz in (-1, 1)], float) * h
        return corners @ R.T + p, R.T.copy(), R.T.copy(), 0.0
    raise ValueError(f"no vertex form for kind {g.kind}")


def _endpoints(g: CollGeom, R, p):
    """World capsule endpoints of ``g`` at its world pose (R, p)."""
    kw = dict(dtype=p.dtype, device=p.device)
    return (matvec(R, torch.as_tensor(g.ea, **kw)) + p,
            matvec(R, torch.as_tensor(g.eb, **kw)) + p)


def _half(g: CollGeom, like):
    return torch.as_tensor(g.params, dtype=like.dtype, device=like.device)


def pair_distance(ga: CollGeom, gb: CollGeom, Ra, pa, Rb, pb):
    """Signed distance between two posed primitives (sphere, capsule,
    box) at world poses ``Ra [..., 3, 3]``, ``pa [..., 3]``, ``Rb``, ``pb``,
    batched over the leading axes (the JAX function takes one pose each and
    a dtype; here the dtype is the poses')."""
    rank = {SPHERE: 0, CAPSULE: 1, BOX: 2}
    ka, kb = ga.kind, gb.kind
    if rank[ka] > rank[kb]:
        # canonical order: sphere < capsule < box (distance is symmetric)
        return pair_distance(gb, ga, Rb, pb, Ra, pa)
    if ka == SPHERE and kb == SPHERE:
        return geom.sphere_sphere(pa, ga.params[0], pb, gb.params[0])
    if ka == SPHERE and kb == CAPSULE:
        a, b = _endpoints(gb, Rb, pb)
        return geom.sphere_capsule(pa, ga.params[0], a, b, gb.params[0])
    if ka == SPHERE and kb == BOX:
        return geom.sphere_box(pa, ga.params[0], Rb, pb, _half(gb, pb))
    if ka == CAPSULE and kb == CAPSULE:
        a0, b0 = _endpoints(ga, Ra, pa)
        a1, b1 = _endpoints(gb, Rb, pb)
        return geom.capsule_capsule(a0, b0, ga.params[0], a1, b1,
                                    gb.params[0])
    if ka == CAPSULE and kb == BOX:
        a, b = _endpoints(ga, Ra, pa)
        return geom.capsule_box(a, b, ga.params[0], Rb, pb, _half(gb, pb))
    if ka == BOX and kb == BOX:
        return geom.box_box(Ra, pa, _half(ga, pa), Rb, pb, _half(gb, pb))
    raise ValueError(f"unsupported pair {ka}/{kb}")


def _swept_pair_distance(ga: CollGeom, gb: CollGeom, Ra0, pa0, Ra1, pa1,
                         Rb, pb):
    """Signed distance of primitive ``ga`` swept from pose 0 to pose 1
    against a primitive ``gb`` static in this gap: exact for swept spheres
    (a capsule) and translating boxes against boxes (the Minkowski-sum
    segment distance), the two swept edge capsules plus the endpoint poses
    for capsules, the endpoint min otherwise."""
    if ga.kind == SPHERE:
        a, b = pa0, pa1
        if gb.kind == SPHERE:
            return geom.sphere_capsule(pb, gb.params[0], a, b, ga.params[0])
        if gb.kind == CAPSULE:
            a1, b1 = _endpoints(gb, Rb, pb)
            return geom.capsule_capsule(a, b, ga.params[0], a1, b1,
                                        gb.params[0])
        if gb.kind == BOX:
            return geom.capsule_box(a, b, ga.params[0], Rb, pb,
                                    _half(gb, pb))
    if ga.kind == BOX and gb.kind == BOX:
        ha_in_b = matvec(geom.abs_(Rb.transpose(-1, -2) @ Ra0),
                         _half(ga, pb))
        return geom.segment_box(pa0, pa1, Rb, pb, _half(gb, pb) + ha_in_b)
    if ga.kind == CAPSULE:
        a0, b0 = _endpoints(ga, Ra0, pa0)
        a1, b1 = _endpoints(ga, Ra1, pa1)
        r = ga.params[0]
        if gb.kind == BOX:
            hb = _half(gb, pb)
            d_edges = torch.minimum(geom.capsule_box(a0, a1, r, Rb, pb, hb),
                                    geom.capsule_box(b0, b1, r, Rb, pb, hb))
        elif gb.kind == SPHERE:
            d_edges = torch.minimum(
                geom.sphere_capsule(pb, gb.params[0], a0, a1, r),
                geom.sphere_capsule(pb, gb.params[0], b0, b1, r))
        else:
            ba, bb = _endpoints(gb, Rb, pb)
            d_edges = torch.minimum(
                geom.capsule_capsule(a0, a1, r, ba, bb, gb.params[0]),
                geom.capsule_capsule(b0, b1, r, ba, bb, gb.params[0]))
        d0 = pair_distance(ga, gb, Ra0, pa0, Rb, pb)
        d1 = pair_distance(ga, gb, Ra1, pa1, Rb, pb)
        return torch.minimum(d_edges, torch.minimum(d0, d1))
    d0 = pair_distance(ga, gb, Ra0, pa0, Rb, pb)
    d1 = pair_distance(ga, gb, Ra1, pa1, Rb, pb)
    return torch.minimum(d0, d1)


def _sdf_distance(ga: CollGeom, gb: CollGeom, pose):
    """Signed distance of posed geoms ``pose = (R, p, ea, eb)`` (world) to
    the SDF world ``gb``; a box takes its bounding sphere."""
    _, p, ea, eb = pose
    if ga.kind == SPHERE:
        return sg.sphere_sdf_distance(gb.grid, p, ga.params[0])
    if ga.kind == CAPSULE:
        return sg.capsule_sdf_distance(gb.grid, ea, eb, ga.params[0])
    if ga.kind == BOX:
        return sg.sphere_sdf_distance(gb.grid, p,
                                      float(np.linalg.norm(ga.params)))
    raise ValueError(f"unsupported sdf pair with {ga.kind}")


def _swept_sdf_distance(ga: CollGeom, gb: CollGeom, pose0, pose1):
    """Swept SDF distance: a sphere sweeps a capsule exactly; other kinds
    take the endpoint min."""
    if ga.kind == SPHERE:
        return sg.capsule_sdf_distance(gb.grid, pose0[1], pose1[1],
                                       ga.params[0])
    return torch.minimum(_sdf_distance(ga, gb, pose0),
                         _sdf_distance(ga, gb, pose1))


def _cat_runs(outs):
    """Concatenate per-lane-slice results (tuples of tensors) on axis 0."""
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(o, 0) for o in zip(*outs))


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
    # Route EVERY pair (but SDF ones) through the sphere-swept vertex-set
    # kernel (collision/convex.py) instead of the per-(kind, kind)
    # closed-form groups.  GJK is exact for every primitive pairing;
    # penetration depth comes from SAT (exact for spheres and face
    # contacts, conservative at edge contacts).
    unify_narrowphase: bool = False
    # Edge directions per hull eligible for SAT edge-cross axes (ranked by
    # parallel-class length in hull_of).  The cross block is quadratic in
    # this cap and the SAT projections are [batch..., V, K]; separation
    # never depends on it (GJK certificate + witness axis).  Primitive
    # forms have <= 3 directions and are unaffected.
    max_cross_edges: int = 6

    def add_geom(self, g: CollGeom) -> "CollisionScene":
        if g.kind not in _RANK:
            raise ValueError(f"unsupported geometry kind {g.kind!r}")
        self.geoms.append(g)
        self._swept_cache = None
        self._groups_cache = None
        self._tensor_cache = None
        forget_on_device(self)
        return self

    def add_world_box(self, name, half_extents, center=(0, 0, 0), R=None,
                      center_param=None):
        return self.add_geom(CollGeom(name, BOX, tuple(half_extents), link=None,
                                      R_local=np.eye(3) if R is None else np.asarray(R),
                                      p_local=np.asarray(center, float),
                                      p_param=center_param))

    def add_world_sdf(self, name, grid):
        """Arbitrary static geometry baked into an SDF voxel grid (the
        reference's octomap worlds)."""
        return self.add_geom(CollGeom(name, SDF, (), link=None, grid=grid))

    def add_world_sphere(self, name, radius, center=(0, 0, 0),
                         center_param=None):
        return self.add_geom(CollGeom(name, SPHERE, (float(radius),), link=None,
                                      p_local=np.asarray(center, float),
                                      p_param=center_param))

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

    def add_link_convex(self, link, vertices, name=None, radius=0.0):
        """Convex hull collision geometry from a vertex cloud in the LINK
        frame (narrowphase: collision/convex.py)."""
        hv, normals, edges = hull_of(np.asarray(vertices, float))
        return self.add_geom(CollGeom(name or f"{link}_convex", CONVEX,
                                      (float(radius),), link=link,
                                      verts=hv, normals=normals,
                                      edges=edges))

    def add_world_convex(self, name, vertices, radius=0.0):
        hv, normals, edges = hull_of(np.asarray(vertices, float))
        return self.add_geom(CollGeom(name, CONVEX, (float(radius),),
                                      link=None, verts=hv, normals=normals,
                                      edges=edges))

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
            "p_params": tuple(g.p_param for g in geoms),
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

    def _convex_arrays(self, geoms):
        """Stacked canonical sphere-swept vertex sets for one convex group
        (every member converted by _canon_vertex_form; vertices padded
        edge-mode -- repeated hull vertices are harmless -- and normals and
        edges zero-padded under their validity masks, the edges capped at
        ``max_cross_edges``)."""
        for g in geoms:
            if g.p_param is not None:
                raise ValueError(
                    f"{g.name}: p_param is unsupported on convex-group "
                    f"geometry")
        forms = [_canon_vertex_form(g) for g in geoms]
        Vmax = max(f[0].shape[0] for f in forms)
        Fmax = max(max((f[1].shape[0] for f in forms), default=0), 1)
        Emax = max(max((f[2].shape[0] for f in forms), default=0), 1)
        Emax = min(Emax, max(int(self.max_cross_edges), 1))
        return {
            "link": np.array([self.tree.link_id(g.link) if g.link else -1
                              for g in geoms]),
            "is_static": np.array([g.link is None for g in geoms]),
            "verts": np.stack([np.pad(f[0], ((0, Vmax - f[0].shape[0]),
                                             (0, 0)), mode="edge")
                               for f in forms]),
            "normals": np.stack([np.pad(f[1], ((0, Fmax - f[1].shape[0]),
                                               (0, 0))) for f in forms]),
            "nvalid": np.stack([np.arange(Fmax) < f[1].shape[0]
                                for f in forms]),
            "edges": np.stack([np.pad(f[2][:Emax],
                                      ((0, Emax - min(f[2].shape[0], Emax)),
                                       (0, 0))) for f in forms]),
            "evalid": np.stack([np.arange(Emax) < f[2].shape[0]
                                for f in forms]),
            "radius": np.array([f[3] for f in forms]),
        }

    def _pack(self, groups):
        return [(key, np.array([i for i, _, _ in items]),
                 (self._convex_arrays if key == _CONVEX_KEY
                  else self._geom_arrays)([ga for _, ga, _ in items]),
                 (self._convex_arrays if key == _CONVEX_KEY
                  else self._geom_arrays)([gb for _, _, gb in items]))
                for key, items in groups.items()]

    def _sdf_entries(self, sdf):
        """(idx, ga, gb, ga's one-geom arrays) per SDF pair."""
        return [(idx, ga, gb, self._geom_arrays([ga])) for idx, ga, gb in sdf]

    def _pair_groups(self):
        """Static per-type grouping for the discrete narrowphase: (groups,
        sdf_pairs, inverse permutation back to pair order).  groups is a
        list of (key, idxs, a, b) with the lower-ranked kind on side ``a``
        (sphere < capsule < box < convex), box pairs that are not mutually
        axis-aligned under (BOX, "obb"), and every pair involving a hull --
        or every pair, under ``unify_narrowphase`` -- in one (CONVEX,
        CONVEX) group; sdf_pairs lists (idx, ga, gb, a) per SDF pair."""
        if getattr(self, "_groups_cache", None) is not None:
            return self._groups_cache
        groups: dict = {}
        sdf = []
        for idx, (ga, gb) in enumerate(self.pairs()):
            if _RANK[ga.kind] > _RANK[gb.kind]:
                ga, gb = gb, ga
            if gb.kind == SDF:
                sdf.append((idx, ga, gb))
                continue
            if gb.kind == CONVEX or self.unify_narrowphase:
                key = _CONVEX_KEY
            else:
                key = (ga.kind, gb.kind)
                if key == (BOX, BOX) and not self._boxbox_aligned(ga, gb):
                    key = (BOX, "obb")
            groups.setdefault(key, []).append((idx, ga, gb))
        out = self._pack(groups)
        order = np.array([i for g in out for i in g[1]]
                         + [i for i, _, _ in sdf], np.int64)
        self._groups_cache = (out, self._sdf_entries(sdf), np.argsort(order))
        return self._groups_cache

    def _swept_groups(self):
        """Static per-type grouping for the swept narrowphase: (moving,
        static, sdf_pairs, inverse permutation).  moving: both geoms ride
        robot links (endpoint min of the discrete kernels); static: geom
        `a` sweeps against configuration-static `b` (closed-form swept
        kernels; convex pairs take the hull of the moving side's endpoint
        vertex union, exact for translation); sdf_pairs as in
        :meth:`_pair_groups`."""
        if getattr(self, "_swept_cache", None) is not None:
            return self._swept_cache
        moving: dict = {}
        static: dict = {}
        sdf = []
        for idx, (ga, gb) in enumerate(self.pairs()):
            if gb.kind == SDF:
                sdf.append((idx, ga, gb))
            elif self._is_active(gb):
                if _RANK[ga.kind] > _RANK[gb.kind]:
                    ga, gb = gb, ga
                key = (ga.kind, gb.kind)
                if CONVEX in key or self.unify_narrowphase:
                    key = _CONVEX_KEY
                elif key == (BOX, BOX) and not self._boxbox_aligned(ga, gb):
                    key = (BOX, "obb")
                moving.setdefault(key, []).append((idx, ga, gb))
            else:
                key = (_CONVEX_KEY if CONVEX in (ga.kind, gb.kind)
                       or self.unify_narrowphase else (ga.kind, gb.kind))
                static.setdefault(key, []).append((idx, ga, gb))
        mv, st = self._pack(moving), self._pack(static)
        order = np.array([i for g in mv + st for i in g[1]]
                         + [i for i, _, _ in sdf], np.int64)
        self._swept_cache = (mv, st, self._sdf_entries(sdf),
                             np.argsort(order))
        return self._swept_cache

    def _tensors(self, arrs, like: torch.Tensor):
        """Group arrays as tensors on ``like``'s device (floats in its
        dtype, masks as bool; cached), with the joint mask of each geom."""
        if getattr(self, "_tensor_cache", None) is None:
            self._tensor_cache = {}
        key = (id(arrs), like.device, like.dtype)
        if key not in self._tensor_cache:
            dev, dt = like.device, like.dtype
            t = {}
            for k, v in arrs.items():
                if k == "link":
                    t[k] = torch.as_tensor(np.maximum(v, 0), device=dev)
                elif not isinstance(v, np.ndarray):
                    t[k] = v
                elif v.dtype == bool:
                    t[k] = torch.as_tensor(v, device=dev)
                else:
                    t[k] = torch.as_tensor(v, dtype=dt, device=dev)
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

    def _side(self, t, R, p, params=None):
        """(Rl, pl, local constants) of a group side at link poses (R, p):
        the local constants are (R_loc, p_loc, ea, eb), with the centers of
        ``center_param`` geoms read from ``params``; None for convex
        groups."""
        Rl, pl = self._link_poses(t, R, p)
        if "verts" in t:
            return Rl, pl, None
        p_loc = t["p"]
        keys = t["p_params"]
        if params is not None and any(k is not None for k in keys):
            batch = R.shape[:-3]
            p_loc = p_loc.expand(*batch, *p_loc.shape).clone()
            for gi, k in enumerate(keys):
                if k is not None:
                    p_loc[..., gi, :] = fp.lead(torch.as_tensor(
                        params[k], dtype=R.dtype, device=R.device),
                        len(batch))
        return Rl, pl, (t["R"], p_loc, t["ea"], t["eb"])

    def _posed(self, t, R, p, params=None):
        """World pose + capsule endpoints for a group side."""
        return fp.side_pose(self._side(t, R, p, params))

    @staticmethod
    def _convex_world(t, Rl, pl):
        """World vertices [..., P, V, 3], face normals and edge directions
        of a convex group side at link poses (Rl, pl)."""
        Rv = Rl[..., None, :, :]
        return (_rotate(Rv, t["verts"]) + pl[..., None, :],
                _rotate(Rv, t["normals"]), _rotate(Rv, t["edges"]))

    def _convex_discrete(self, ta, tb, sa, sb):
        """Discrete distances of the convex group from each side's (Rl,
        pl)."""
        va, na, ea = self._convex_world(ta, sa[0], sa[1])
        vb, nb, eb = self._convex_world(tb, sb[0], sb[1])
        cx, cxv = edge_cross_axes(ea, ta["evalid"], eb, tb["evalid"])
        return convex_convex(
            va, ta["radius"], vb, tb["radius"],
            torch.cat([na, nb, cx], -2),
            torch.cat([ta["nvalid"], tb["nvalid"], cxv], -1))

    def _convex_swept(self, ta, tb, sa0, sa1, sb):
        """Swept distances of the convex moving-vs-static group: side a
        sweeps from sa0 to sa1 against side b (both (Rl, pl, locals)),
        through GJK over the union of a's endpoint vertex sets with the
        swept-prism axes: a's endpoint faces, b's faces, the side faces
        cross(edge, displacement) and the crosses of the union edge set
        (edges at both poses + the displacement) with b's edges."""
        va0, na0, ea0 = self._convex_world(ta, sa0[0], sa0[1])
        va1, na1, ea1 = self._convex_world(ta, sa1[0], sa1[1])
        vb, nb, eb = self._convex_world(tb, sb[0], sb[1])
        disp = (sa1[1] - sa0[1])[..., None, :]
        eu = torch.cat([ea0, ea1, disp], -2)
        euv = torch.cat([ta["evalid"], ta["evalid"],
                         torch.ones_like(ta["evalid"][:, :1])], -1)
        cx, cxv = edge_cross_axes(eu, euv, eb, tb["evalid"])
        axes = torch.cat([na0, na1, nb, geom.cross(eu, disp), cx], -2)
        valid = torch.cat([ta["nvalid"], ta["nvalid"], tb["nvalid"], euv,
                           cxv], -1)
        return convex_convex(torch.cat([va0, va1], -2), ta["radius"], vb,
                             tb["radius"], axes, valid)

    def _lane_slices(self, key, ta, tb, R, swept: bool = False):
        """Slices of the leading (lane) axis a group call runs over: the
        whole batch, or for a convex group as many lanes a call as keep its
        SAT projections within ``CONVEX_CHUNK_ELEMS`` entries."""
        if key != _CONVEX_KEY or R.dim() < 4:
            return [slice(None)]
        Va, Fa, Ea = (ta[k].shape[1] for k in ("verts", "normals", "edges"))
        Vb, Fb, Eb = (tb[k].shape[1] for k in ("verts", "normals", "edges"))
        if swept:
            Va, Fa, Ea = 2 * Va, 2 * Fa + 2 * Ea + 1, 2 * Ea + 1
        per_lane = (int(np.prod(R.shape[1:-3])) * ta["verts"].shape[0]
                    * (Va + Vb) * (Fa + Fb + Ea * Eb + 2))
        n = max(1, CONVEX_CHUNK_ELEMS // max(per_lane, 1))
        L = R.shape[0]
        return [slice(s, min(s + n, L)) for s in range(0, L, n)]

    def _index(self, kind: str, idx, device) -> torch.Tensor:
        """Pair indices ``idx`` of a group of the ``kind`` query
        (``"pairs"``: :meth:`_pair_groups`, ``"swept"``:
        :meth:`_swept_groups`) as a tensor on ``device``."""
        idx = np.atleast_1d(idx)
        return on_device(self, (kind, tuple(idx.tolist())), lambda: idx,
                         device)

    def _outputs(self, kind: str, like, jac: int):
        """Uninitialised outputs of a ``kind`` query in pair order: d
        [..., P] and ``jac`` Jacobians [..., P, n_dof]."""
        groups = self._pair_groups if kind == "pairs" else self._swept_groups
        batch, P = like.shape[:-3], len(groups()[-1])
        d = like.new_empty(*batch, P)
        return (d, *(like.new_empty(*batch, P, self.tree.n_dof)
                     for _ in range(jac)))

    def distances(self, fk, params=None) -> torch.Tensor:
        """[..., n_pairs] signed distances at link poses ``fk = (R, p)``
        from ``tree.fk`` (the JAX function takes one configuration q)."""
        R, p = fk[0], fk[1]
        groups, sdf, _ = self._pair_groups()
        outs = self._outputs("pairs", R, 0)
        outs = fp.query(self, "pairs", ((R, p),), params, outs)
        for key, idx, a, b in groups:
            if key != _CONVEX_KEY:
                continue
            ta, tb = self._tensors(a, R), self._tensors(b, R)

            def run(sl, ta=ta, tb=tb):
                Rs, ps = R[sl], p[sl]
                return (self._convex_discrete(
                    ta, tb, self._side(ta, Rs, ps, params),
                    self._side(tb, Rs, ps, params)),)
            with torch.profiler.record_function("collision.convex"):
                outs = fp.put(outs, self._index("pairs", idx, R.device),
                          _cat_runs([run(sl) for sl in
                                     self._lane_slices(key, ta, tb, R)]))
        for idx, ga, gb, a in sdf:
            outs = fp.put(outs, self._index("pairs", idx, R.device), (
                _sdf_distance(ga, gb, self._posed(self._tensors(a, R), R, p,
                                                  params)),))
        return outs[0]

    def distances_and_jac(self, fk, params=None):
        """(ds [..., P], J [..., P, n_dof]) at link poses and joint axes
        ``fk = (R, p, z, o)`` from ``tree.fk_with_axes``: each pair's
        gradient w.r.t. its two link poses, composed through the
        geometric-Jacobian relations."""
        R, p, z, o = fk
        groups, sdf, _ = self._pair_groups()
        outs = self._outputs("pairs", R, 1)
        outs = fp.query(self, "pairs", ((R, p, z, o),), params, outs)
        zxo = geom.cross(z, o)
        is_rev = self.tree.revolute(R.device)
        with torch.enable_grad():
            for key, idx, a, b in groups:
                if key != _CONVEX_KEY:
                    continue
                ta, tb = self._tensors(a, R), self._tensors(b, R)

                def run(sl, ta=ta, tb=tb):
                    Rs, ps = R[sl], p[sl]
                    sa = self._side(ta, Rs, ps, params)
                    sb = self._side(tb, Rs, ps, params)
                    leaves = [fp.leaf(v) for v in (*sa[:2], *sb[:2])]
                    d = self._convex_discrete(ta, tb, leaves[:2], leaves[2:])
                    g = fp.grads(d, leaves)
                    ax = (z[sl], zxo[sl], is_rev)
                    return d.detach(), (
                        fp.compose_pose_grads(g[0], g[1], *sa[:2],
                                              ta["mask"], *ax)
                        + fp.compose_pose_grads(g[2], g[3], *sb[:2],
                                                tb["mask"], *ax))
                with torch.profiler.record_function("collision.convex"):
                    outs = fp.put(outs, self._index("pairs", idx, R.device),
                              _cat_runs([run(sl) for sl in
                                         self._lane_slices(key, ta, tb, R)]))
            for idx, ga, gb, a in sdf:
                ta = self._tensors(a, R)
                Rl, pl, locs = self._side(ta, R, p, params)
                leaves = [fp.leaf(Rl), fp.leaf(pl)]
                d = _sdf_distance(ga, gb, fp.pose_geom(*leaves, *locs))
                g = fp.grads(d, leaves)
                outs = fp.put(outs, self._index("pairs", idx, R.device), (
                    d.detach(), fp.compose_pose_grads(
                        g[0], g[1], Rl, pl, ta["mask"], z, zxo, is_rev)))
        return outs

    def swept_distances(self, fk0, fk1, params=None) -> torch.Tensor:
        """[..., n_pairs] signed distances of geometry swept between two
        endpoint pose sets ``fk0 = (R0, p0)`` and ``fk1 = (R1, p1)`` (link
        poses from ``tree.fk``; the JAX function takes q0/q1 and optional
        precomputed poses, the port always takes the poses so adjacent LVS
        sub-segments share their endpoint FK)."""
        R0, p0 = fk0[0], fk0[1]
        R1, p1 = fk1[0], fk1[1]
        moving, static, sdf, _ = self._swept_groups()
        outs = self._outputs("swept", R0, 0)
        outs = fp.query(self, "swept", ((R0, p0), (R1, p1)), params, outs)
        for key, idx, a, b in moving:
            if key != _CONVEX_KEY:
                continue
            ta, tb = self._tensors(a, R0), self._tensors(b, R0)

            def run(sl, ta=ta, tb=tb):
                d = [self._convex_discrete(
                    ta, tb, self._side(ta, Rs[sl], ps[sl], params),
                    self._side(tb, Rs[sl], ps[sl], params))
                     for Rs, ps in ((R0, p0), (R1, p1))]
                return (torch.minimum(*d),)
            with torch.profiler.record_function("collision.convex"):
                outs = fp.put(outs, self._index("swept", idx, R0.device),
                          _cat_runs([run(sl) for sl in
                                     self._lane_slices(key, ta, tb, R0)]))
        for key, idx, a, b in static:
            if key != _CONVEX_KEY:
                continue
            ta, tb = self._tensors(a, R0), self._tensors(b, R0)

            def run(sl, ta=ta, tb=tb):
                return (self._convex_swept(
                    ta, tb, self._side(ta, R0[sl], p0[sl], params),
                    self._side(ta, R1[sl], p1[sl], params),
                    self._side(tb, R0[sl], p0[sl], params)),)
            with torch.profiler.record_function("collision.convex"):
                outs = fp.put(outs, self._index("swept", idx, R0.device),
                          _cat_runs([run(sl) for sl in self._lane_slices(
                              key, ta, tb, R0, swept=True)]))
        for idx, ga, gb, a in sdf:
            ta = self._tensors(a, R0)
            outs = fp.put(outs, self._index("swept", idx, R0.device), (
                _swept_sdf_distance(ga, gb,
                                    self._posed(ta, R0, p0, params),
                                    self._posed(ta, R1, p1, params)
                                    ),))
        return outs[0]

    def swept_distances_and_jac(self, fk0, fk1, params=None):
        """(ds [..., P], J0 [..., P, n_dof], J1 [..., P, n_dof]) of the
        swept check between endpoint poses ``fk0 = (R0, p0, z0, o0)`` and
        ``fk1`` (from ``tree.fk_with_axes``): per-pair pose gradients
        composed through the geometric-Jacobian relations at each
        endpoint."""
        R0, p0, z0, o0 = fk0
        R1, p1, z1, o1 = fk1
        moving, static, sdf, _ = self._swept_groups()
        outs = self._outputs("swept", R0, 2)
        outs = fp.query(self, "swept", (fk0, fk1), params, outs)
        zxo0 = geom.cross(z0, o0)
        zxo1 = geom.cross(z1, o1)
        is_rev = self.tree.revolute(R0.device)

        def c0(gR, gp, Rl, pl, t, sl=slice(None)):
            return fp.compose_pose_grads(gR, gp, Rl, pl, t["mask"], z0[sl],
                                         zxo0[sl], is_rev)

        def c1(gR, gp, Rl, pl, t, sl=slice(None)):
            return fp.compose_pose_grads(gR, gp, Rl, pl, t["mask"], z1[sl],
                                         zxo1[sl], is_rev)

        with torch.enable_grad():
            for key, idx, a, b in moving:
                if key != _CONVEX_KEY:
                    continue
                ta, tb = self._tensors(a, R0), self._tensors(b, R0)

                def run(sl, ta=ta, tb=tb):
                    sa0 = self._side(ta, R0[sl], p0[sl], params)
                    sb0 = self._side(tb, R0[sl], p0[sl], params)
                    sa1 = self._side(ta, R1[sl], p1[sl], params)
                    sb1 = self._side(tb, R1[sl], p1[sl], params)
                    leaves = [fp.leaf(v) for v in (*sa0[:2], *sb0[:2],
                                                   *sa1[:2], *sb1[:2])]
                    d = torch.minimum(
                        self._convex_discrete(ta, tb, leaves[0:2],
                                              leaves[2:4]),
                        self._convex_discrete(ta, tb, leaves[4:6],
                                              leaves[6:8]))
                    g = fp.grads(d, leaves)
                    return (d.detach(),
                            c0(g[0], g[1], *sa0[:2], ta, sl)
                            + c0(g[2], g[3], *sb0[:2], tb, sl),
                            c1(g[4], g[5], *sa1[:2], ta, sl)
                            + c1(g[6], g[7], *sb1[:2], tb, sl))
                with torch.profiler.record_function("collision.convex"):
                    outs = fp.put(outs, self._index("swept", idx, R0.device),
                              _cat_runs([run(sl) for sl in
                                         self._lane_slices(key, ta, tb, R0)]))
            for key, idx, a, b in static:
                if key != _CONVEX_KEY:
                    continue
                ta, tb = self._tensors(a, R0), self._tensors(b, R0)

                def run(sl, ta=ta, tb=tb):
                    sa0 = self._side(ta, R0[sl], p0[sl], params)
                    sa1 = self._side(ta, R1[sl], p1[sl], params)
                    leaves = [fp.leaf(v) for v in (*sa0[:2], *sa1[:2])]
                    d = self._convex_swept(
                        ta, tb, leaves[:2], leaves[2:],
                        self._side(tb, R0[sl], p0[sl], params))
                    g = fp.grads(d, leaves)
                    return (d.detach(), c0(g[0], g[1], *sa0[:2], ta, sl),
                            c1(g[2], g[3], *sa1[:2], ta, sl))
                with torch.profiler.record_function("collision.convex"):
                    outs = fp.put(outs, self._index("swept", idx, R0.device),
                              _cat_runs([run(sl) for sl in self._lane_slices(
                                  key, ta, tb, R0, swept=True)]))
            for idx, ga, gb, a in sdf:
                ta = self._tensors(a, R0)
                Rl0, pl0, locs = self._side(ta, R0, p0, params)
                Rl1, pl1, _ = self._side(ta, R1, p1, params)
                leaves = [fp.leaf(v) for v in (Rl0, pl0, Rl1, pl1)]
                d = _swept_sdf_distance(ga, gb,
                                        fp.pose_geom(*leaves[:2], *locs),
                                        fp.pose_geom(*leaves[2:], *locs))
                g = fp.grads(d, leaves)
                outs = fp.put(outs, self._index("swept", idx, R0.device), (
                    d.detach(), c0(g[0], g[1], Rl0, pl0, ta),
                    c1(g[2], g[3], Rl1, pl1, ta)))
        return outs


def resolve_resource(filename: str, package_map: dict | None) -> str:
    """Resolve a URDF mesh resource path: ``package://<pkg>/<rel>`` via the
    caller's package map (the ResourceLocator role), ``file://`` and plain
    paths as they are."""
    if filename.startswith("package://"):
        rest = filename[len("package://"):]
        pkg, _, rel = rest.partition("/")
        if not package_map or pkg not in package_map:
            raise ValueError(
                f"cannot resolve {filename!r}: provide package_map["
                f"{pkg!r}] (ResourceLocator role)")
        return os.path.join(package_map[pkg], rel)
    if filename.startswith("file://"):
        return filename[len("file://"):]
    return filename


def scene_from_urdf(tree: KinematicTree, model: urdf_mod.UrdfModel,
                    srdf=None, *, package_map: dict | None = None,
                    mesh_mode: str = "hull",
                    mesh_max_pieces: int = 8,
                    mesh_max_concavity: float = 0.03) -> CollisionScene:
    """Import URDF collision geometry: boxes and spheres exact, cylinders
    as capsules (conservative end caps), and ``<mesh>`` geometry per
    ``mesh_mode``: ``"hull"`` (default) makes one CONVEX geom per mesh, the
    convex hull of its vertices; ``"decompose"`` fits sphere/capsule/box
    pieces (collision/decompose.py).  ``package_map`` maps ROS package
    names to directories for ``package://`` resources.  An
    :class:`~trajopt_tpu_torch.kinematics.srdf.SrdfModel` seeds the
    link-level allowed-collision matrix from its ``<disable_collisions>``
    entries."""
    from trajopt_tpu_torch.collision import decompose as dc

    if mesh_mode not in ("hull", "decompose"):
        raise ValueError(f"mesh_mode must be 'hull' or 'decompose', "
                         f"got {mesh_mode!r}")
    scene = CollisionScene(tree)
    if srdf is not None:
        scene.disabled_link_pairs |= srdf.disabled_link_pairs()
    for link in model.links:
        if link.name not in tree.link_names:
            continue
        for gi, g in enumerate(link.collisions):
            R = rpy_matrix(torch.as_tensor(np.asarray(g.origin_rpy, float))
                           ).numpy()
            p = np.asarray(g.origin_xyz, float)
            name = f"{link.name}_c{gi}"
            if g.kind == "box":
                scene.add_geom(CollGeom(name, BOX,
                                        tuple(s / 2.0 for s in g.size),
                                        link=link.name, R_local=R, p_local=p))
            elif g.kind == "sphere":
                scene.add_geom(CollGeom(name, SPHERE, (g.size[0],),
                                        link=link.name, R_local=R, p_local=p))
            elif g.kind == "cylinder":
                r, ln = g.size
                axis = R @ np.array([0.0, 0.0, ln / 2.0])
                scene.add_geom(CollGeom(name, CAPSULE, (r,), link=link.name,
                                        ea=p - axis, eb=p + axis))
            elif g.kind == "mesh":
                mesh = dc.load_mesh(resolve_resource(g.filename, package_map))
                # scale + collision-origin transform into the link frame
                verts = mesh.vertices * np.asarray(g.size, float)
                verts = verts @ R.T + p
                if mesh_mode == "hull":
                    hv, normals, edges = hull_of(verts)
                    scene.add_geom(CollGeom(name, CONVEX, (0.0,),
                                            link=link.name, verts=hv,
                                            normals=normals, edges=edges))
                    continue
                pieces = dc.decompose(dc.Mesh(verts, mesh.faces),
                                      max_concavity=mesh_max_concavity,
                                      max_pieces=mesh_max_pieces)
                for pi, pc in enumerate(pieces):
                    nm = f"{name}_m{pi}"
                    if pc.kind == "sphere":
                        scene.add_geom(CollGeom(nm, SPHERE,
                                                (float(pc.params[0]),),
                                                link=link.name,
                                                p_local=pc.center))
                    elif pc.kind == "capsule":
                        r, a, b = pc.params
                        scene.add_geom(CollGeom(nm, CAPSULE, (float(r),),
                                                link=link.name,
                                                ea=np.asarray(a, float),
                                                eb=np.asarray(b, float)))
                    else:  # box
                        (half,) = pc.params
                        scene.add_geom(CollGeom(nm, BOX,
                                                tuple(np.asarray(half, float)),
                                                link=link.name,
                                                R_local=np.asarray(pc.R),
                                                p_local=np.asarray(pc.center)))
    return scene
