"""Signed distances between spheres, capsules and boxes, from a scene's
geometry as data (``scene`` of a configuration file) and link poses.

Negative when the shapes overlap.  A capsule-box distance minimises the
box's signed distance function along the capsule's segment, a convex
function of the segment parameter.  Two values are given for it:

* the system's definition (:func:`segment_box`), a bracketed search (the
  JAX package's and the port's ``_segment_box_separation``: 17 samples, a
  bracket of one sample spacing on each side of the least, 8 golden-section
  steps, the bracket's midpoint), which is what the solver's clearances
  state and which lies above the least distance by at most the segment's
  length times :data:`BRACKET_HALF`;
* the least distance (:func:`segment_box_exact`), the golden-section search
  run to float64 resolution.

:func:`pair_distances` gives the first, and with ``least_below`` the second
too, computed exactly wherever it can lie below ``least_below``.
"""

from __future__ import annotations

import numpy as np

from port_bench.reference import arith

GOLDEN_STEPS = 80
BRACKET_SAMPLES, BRACKET_STEPS = 17, 8
GOLDEN = 0.6180339887498949
# The system's bracket ends within this share of the segment's parameter
# range on either side of the least (convexity keeps the least inside it).
BRACKET_HALF = GOLDEN ** BRACKET_STEPS / (BRACKET_SAMPLES - 1)


def world_shapes(scene: dict, poses: dict, rnd=arith.exact) -> dict:
    """{geom name: (kind, arrays)} in the world frame: a sphere (center,
    radius), a capsule (end a, end b, radius), a box (rotation, center,
    half extents).  A geom with no link is fixed in the world."""
    out = {}
    for g in scene["geoms"]:
        kind, link = g["kind"], g.get("link")
        R_loc = np.asarray(g.get("R", np.eye(3)), np.float64)
        c_loc = np.asarray(g.get("center", (0.0, 0.0, 0.0)), np.float64)
        if link is None:
            def place(v):
                return v
            R_w = R_loc
        else:
            Rl, pl = poses[link]

            def place(v, Rl=Rl, pl=pl):
                return arith.matvec(rnd, Rl, np.broadcast_to(
                    v, pl.shape)) + pl
            R_w = arith.matmul(rnd, Rl, np.broadcast_to(R_loc, Rl.shape))
        if kind == "sphere":
            out[g["name"]] = (kind, (place(c_loc), float(g["radius"])))
        elif kind == "capsule":
            ea = R_loc @ np.asarray(g["ea"], np.float64) + c_loc
            eb = R_loc @ np.asarray(g["eb"], np.float64) + c_loc
            out[g["name"]] = (kind, (place(ea), place(eb),
                                     float(g["radius"])))
        elif kind == "box":
            out[g["name"]] = (kind, (R_w, place(c_loc),
                                     np.asarray(g["half_extents"],
                                                np.float64)))
        else:
            raise ValueError(f"geom {g['name']}: kind {kind} is not "
                             f"supported")
    return out


def point_segment(rnd, p, a, b):
    """Distance from p to the segment a-b."""
    ab = b - a
    t = np.clip(arith.dot(rnd, p - a, ab) / np.maximum(
        arith.dot(rnd, ab, ab), 1e-300), 0.0, 1.0)
    return arith.norm(rnd, p - (a + arith.mul(rnd, t[..., None], ab)))


def segment_segment(rnd, p1, q1, p2, q2):
    """Distance between the segments p1-q1 and p2-q2 (Ericson, Real-Time
    Collision Detection, 5.1.9)."""
    d1, d2, r = q1 - p1, q2 - p2, p1 - p2
    a = arith.dot(rnd, d1, d1)
    e = arith.dot(rnd, d2, d2)
    f = arith.dot(rnd, d2, r)
    c = arith.dot(rnd, d1, r)
    b = arith.dot(rnd, d1, d2)
    den = arith.mul(rnd, a, e) - arith.mul(rnd, b, b)
    s = np.where(den > 1e-300,
                 np.clip((arith.mul(rnd, b, f) - arith.mul(rnd, c, e))
                         / np.where(den > 1e-300, den, 1.0), 0.0, 1.0), 0.0)
    t = (arith.mul(rnd, b, s) + f) / e
    s = np.where(t < 0.0, np.clip(-c / a, 0.0, 1.0),
                 np.where(t > 1.0, np.clip((b - c) / a, 0.0, 1.0), s))
    t = np.clip(t, 0.0, 1.0)
    c1 = p1 + arith.mul(rnd, s[..., None], d1)
    c2 = p2 + arith.mul(rnd, t[..., None], d2)
    return arith.norm(rnd, c1 - c2)


def box_sdf(rnd, p_local, half):
    """Signed distance from points in the box's frame to the box."""
    q = np.abs(p_local) - half
    outside = arith.norm(rnd, np.maximum(q, 0.0))
    inside = np.minimum(q.max(-1), 0.0)
    return outside + inside


def to_box(rnd, R, c, v):
    return arith.rmatvec(rnd, R, v - c)


def segment_box_exact(rnd, a, b, R, c, half):
    """Least signed distance from the segment a-b to the box, by
    golden-section search to float64 resolution."""
    al, bl = to_box(rnd, R, c, a), to_box(rnd, R, c, b)
    d = bl - al

    def f(t):
        return box_sdf(rnd, al + arith.mul(rnd, t[..., None], d), half)

    a_t = np.zeros(al.shape[:-1])
    b_t = np.ones(al.shape[:-1])
    x1, x2 = b_t - GOLDEN * (b_t - a_t), a_t + GOLDEN * (b_t - a_t)
    f1, f2 = f(x1), f(x2)
    for _ in range(GOLDEN_STEPS):
        left = f1 <= f2                 # the least lies in [a_t, x2]
        a_t = np.where(left, a_t, x1)
        b_t = np.where(left, x2, b_t)
        xn = np.where(left, b_t - GOLDEN * (b_t - a_t),
                      a_t + GOLDEN * (b_t - a_t))
        fn = f(xn)
        x1, f1, x2, f2 = (np.where(left, xn, x2), np.where(left, fn, f2),
                          np.where(left, x1, xn), np.where(left, f1, fn))
    return np.minimum(np.minimum(f1, f2),
                      np.minimum(f(np.zeros_like(a_t)), f(np.ones_like(a_t))))


def segment_box(rnd, a, b, R, c, half):
    """Signed distance from the segment a-b to the box as the system
    defines it: the bracketed search's value where it finds the segment
    clear of the box, else the least signed distance (<= 0)."""
    al, bl = to_box(rnd, R, c, a), to_box(rnd, R, c, b)
    d = bl - al

    def f(t):
        return box_sdf(rnd, al + arith.mul(rnd, t[..., None], d), half)

    ts = np.linspace(0.0, 1.0, BRACKET_SAMPLES)
    vals = np.stack([f(np.full(al.shape[:-1], t)) for t in ts], -1)
    ti = ts[np.argmin(vals, -1)]
    step = 1.0 / (BRACKET_SAMPLES - 1)
    lo, hi = np.clip(ti - step, 0.0, 1.0), np.clip(ti + step, 0.0, 1.0)
    for _ in range(BRACKET_STEPS):
        m1 = hi - GOLDEN * (hi - lo)
        m2 = lo + GOLDEN * (hi - lo)
        take = f(m1) < f(m2)
        lo = np.where(take, lo, m1)
        hi = np.where(take, m2, hi)
    sep = f(0.5 * (lo + hi))
    hit = ~(sep > 0.0)
    if hit.any():                       # overlaps: the least distance
        def sub(v, k):
            return v[hit] if np.ndim(v) > k else v
        sep = sep.copy()
        sep[hit] = np.minimum(segment_box_exact(
            rnd, sub(a, 1), sub(b, 1), sub(R, 2), sub(c, 1), half), 0.0)
    return sep


def distance(rnd, ka, sa, kb, sb, least_below=None):
    """Signed distance between shape ``sa`` of kind ``ka`` and ``sb`` as the
    system defines it; with ``least_below``, the pair (that distance, the
    least distance where it can lie below ``least_below``)."""
    if (ka, kb) in (("box", "sphere"), ("box", "capsule"),
                    ("capsule", "sphere")):
        ka, sa, kb, sb = kb, sb, ka, sa
    if ka == "sphere" and kb == "sphere":
        d = arith.norm(rnd, sa[0] - sb[0]) - sa[1] - sb[1]
    elif ka == "sphere" and kb == "capsule":
        d = point_segment(rnd, sa[0], sb[0], sb[1]) - sa[1] - sb[2]
    elif ka == "capsule" and kb == "capsule":
        d = segment_segment(rnd, sa[0], sa[1], sb[0], sb[1]) \
            - sa[2] - sb[2]
    elif ka == "sphere" and kb == "box":
        d = box_sdf(rnd, to_box(rnd, *sb[:2], sa[0]), sb[2]) - sa[1]
    elif ka == "capsule" and kb == "box":
        d = segment_box(rnd, sa[0], sa[1], *sb) - sa[2]
        if least_below is None:
            return d
        a, b, c = (np.broadcast_to(v, d.shape + (3,))
                   for v in (sa[0], sa[1], sb[1]))
        R = np.broadcast_to(sb[0], d.shape + (3, 3))
        slack = np.linalg.norm(b - a, axis=-1) * BRACKET_HALF + 1e-9
        near = d < least_below + slack
        least = d.copy()
        if near.any():
            least[near] = segment_box_exact(
                rnd, a[near], b[near], R[near], c[near], sb[2]) - sa[2]
        return d, least
    else:
        raise ValueError(f"no distance for {ka} and {kb}")
    return d if least_below is None else (d, d)


def pair_distances(scene: dict, poses: dict, rnd=arith.exact,
                   least_below=None):
    """[..., n_pairs] signed distances of the scene's ``pairs`` as the
    system defines them; with ``least_below``, also the least distances,
    exact wherever they lie below ``least_below`` (above it, the system's
    value, which is then above ``least_below`` too)."""
    shapes = world_shapes(scene, poses, rnd)
    cols = []
    for a, b in scene["pairs"]:
        (ka, sa), (kb, sb) = shapes[a], shapes[b]
        out = distance(rnd, ka, sa, kb, sb, least_below)
        cols.append(out if least_below is not None else (out, out))
    lead = np.broadcast_shapes(*[np.shape(c[0]) for c in cols])
    system, least = (np.stack([np.broadcast_to(c[k], lead) for c in cols],
                              -1) for k in (0, 1))
    return system if least_below is None else (system, least)
