"""Collision geometry: differentiable signed-distance kernels for convex
primitives, on batched tensors.

Counterpart of ``trajopt_tpu/collision/geometry.py``: closed-form distances
between spheres, capsules (segment + radius) and boxes; negative values are
penetration.  Every function broadcasts over leading axes (points ``[..., 3]``,
rotations ``[..., 3, 3]``, radii ``[...]``).

Gradient conventions follow JAX so the two packages differentiate to the
same subgradient at ties: ``jnp.clip`` is ``minimum(max, maximum(min, x))``
(an even split at the bounds, which ``torch.clamp`` does not give), min/max
of two values split evenly (``torch.minimum``/``maximum`` do),
reductions split among ties (``torch.amin``/``amax`` do), and ``abs`` has
slope +1 at 0 (:func:`abs_`).
"""

from __future__ import annotations

import torch

from trajopt_tpu_torch.kinematics.transforms import matvec, rmatvec
from trajopt_tpu_torch.utils import device_const

_EPS = 1e-12


def abs_(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs`` with its gradient: +1 at x = 0 (``torch.abs`` gives 0,
    which would split the two packages' subgradients wherever a
    difference is exactly zero, e.g. a degenerate swept segment)."""
    return torch.where(x >= 0, x, -x)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip`` with its gradient: minimum(hi, maximum(lo, x))."""
    lo, hi = (v.to(x) if isinstance(v, torch.Tensor)
              else device_const(v, x.device, x.dtype) for v in (lo, hi))
    return torch.minimum(hi, torch.maximum(lo, x))


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting cross product over the last axis."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def norm(v: torch.Tensor) -> torch.Tensor:
    """Exact norm over the last axis with a finite (zero) gradient at 0."""
    ss = (v * v).sum(-1)
    pos = ss > 0.0
    safe = torch.where(pos, ss, torch.ones_like(ss))
    return torch.where(pos, torch.sqrt(safe), torch.zeros_like(ss))


def sphere_sphere(c0, r0, c1, r1):
    return norm(c0 - c1) - (r0 + r1)


def point_segment_closest(p, a, b):
    """Closest point to p on segment [a, b]; returns (point, t)."""
    ab = b - a
    t = clip(dot(p - a, ab) / (dot(ab, ab) + _EPS), 0.0, 1.0)
    return a + t[..., None] * ab, t


def sphere_capsule(c, r, a, b, rc):
    q, _ = point_segment_closest(c, a, b)
    return norm(c - q) - (r + rc)


def segment_segment_closest(p1, q1, p2, q2):
    """Closest points between segments [p1,q1], [p2,q2] (Ericson 5.1.9),
    with guards so the parallel case stays differentiable."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = dot(d1, d1) + _EPS
    e = dot(d2, d2) + _EPS
    b = dot(d1, d2)
    c = dot(d1, r)
    f = dot(d2, r)
    denom = a * e - b * b
    s = torch.where(torch.abs(denom) > _EPS,
                    clip((b * f - c * e) / (denom + _EPS), 0.0, 1.0),
                    torch.zeros_like(denom))
    t = (b * s + f) / e
    t_cl = clip(t, 0.0, 1.0)
    s = clip((b * t_cl - c) / a, 0.0, 1.0)
    t = clip((b * s + f) / e, 0.0, 1.0)
    return p1 + s[..., None] * d1, p2 + t[..., None] * d2


def capsule_capsule(a0, b0, r0, a1, b1, r1):
    u, v = segment_segment_closest(a0, b0, a1, b1)
    return norm(u - v) - (r0 + r1)


def point_box_sdf(p_local, half):
    """Exact signed distance from a point to an origin-centered box in the
    box frame (standard box SDF)."""
    q = abs_(p_local) - half
    outside = norm(torch.maximum(q, q.new_zeros(())))
    inside = torch.minimum(torch.amax(q, -1), q.new_zeros(()))
    return outside + inside


def sphere_box(c, r, R_box, p_box, half):
    return point_box_sdf(rmatvec(R_box, c - p_box), half) - r


def _segment_box_separation(a_l, b_l, half, n_coarse: int = 17,
                            n_refine: int = 8):
    """min over t of point_box_sdf(a + t(b-a)): a dense 17-sample bracket
    plus golden refinement.  The search carries no gradient (the JAX
    version stops the gradient at t*); the value at t* is differentiated
    exactly (envelope theorem)."""
    d = b_l - a_l
    with torch.no_grad():
        a0, d0, h0 = a_l.detach(), d.detach(), half.detach()

        def sdf_t(t):
            return point_box_sdf(a0 + t[..., None] * d0, h0)

        ts = torch.linspace(0.0, 1.0, n_coarse, dtype=a_l.dtype,
                            device=a_l.device)
        vals = point_box_sdf(a0[..., None, :] + ts[:, None] * d0[..., None, :],
                             h0[..., None, :])
        ti = ts[torch.argmin(vals, -1)]
        step = 1.0 / (n_coarse - 1)
        lo = clip(ti - step, 0.0, 1.0)
        hi = clip(ti + step, 0.0, 1.0)
        gr = 0.6180339887498949
        for _ in range(n_refine):
            m1 = hi - gr * (hi - lo)
            m2 = lo + gr * (hi - lo)
            take = sdf_t(m1) < sdf_t(m2)
            lo = torch.where(take, lo, m1)
            hi = torch.where(take, m2, hi)
        t_star = 0.5 * (lo + hi)
    return point_box_sdf(a_l + t_star[..., None] * d, half)


_UNIT = {}


def _unit_axes(like: torch.Tensor) -> torch.Tensor:
    key = (like.dtype, like.device)
    if key not in _UNIT:
        _UNIT[key] = torch.eye(3, dtype=like.dtype, device=like.device)
    return _UNIT[key]


def _segment_box_penetration(a_l, b_l, half):
    """Exact minimum-translation penetration depth of an overlapping
    segment vs an origin-centered box (SAT over the 3 face normals and the
    3 segment-dir x box-edge axes)."""
    u = b_l - a_l
    eye = _unit_axes(a_l)
    axes = [eye[i].expand_as(u) for i in range(3)]
    for i in range(3):
        e = eye[i]
        c = cross(u, e)
        n = norm(c)
        ok = n > 1e-9
        axes.append(torch.where(
            ok[..., None],
            c / torch.where(ok, n, torch.ones_like(n))[..., None], e))
    overlaps = []
    for ax in axes:
        r_box = (half * abs_(ax)).sum(-1)
        pa = dot(ax, a_l)
        pb = dot(ax, b_l)
        c = 0.5 * (pa + pb)
        hl = 0.5 * abs_(pa - pb)
        overlaps.append(r_box + hl - abs_(c))
    return torch.amin(torch.stack(overlaps, -1), -1)


def segment_box(a, b, R_box, p_box, half, n_coarse: int = 17,
                n_refine: int = 8):
    """Signed distance between a segment and a box: exact separation
    outside, exact SAT penetration depth inside."""
    a_l = rmatvec(R_box, a - p_box)
    b_l = rmatvec(R_box, b - p_box)
    d_sep = _segment_box_separation(a_l, b_l, half, n_coarse, n_refine)
    pen = _segment_box_penetration(a_l, b_l, half)
    return torch.where(d_sep > 0.0, d_sep,
                       -torch.maximum(pen, pen.new_zeros(())))


def capsule_box(a, b, r, R_box, p_box, half):
    return segment_box(a, b, R_box, p_box, half) - r


_BOX_SIGNS = [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
              for sz in (-1.0, 1.0)]
# 12 box edges as corner-index pairs (z edges, y edges, x edges)
_BOX_EDGES = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
              (0, 4), (1, 5), (2, 6), (3, 7)]


def _box_corners(R, p, h):
    """[..., 8, 3] world corners of an oriented box."""
    signs = torch.as_tensor(_BOX_SIGNS, dtype=h.dtype, device=h.device)
    local = signs * h[..., None, :]                         # [..., 8, 3]
    return p[..., None, :] + (local[..., :, None, :]
                              * R[..., None, :, :]).sum(-1)


def box_box(R0, p0, h0, R1, p1, h1):
    """Exact signed distance between two oriented boxes (OBB-OBB):
    min over the 16 vertex-face and 144 edge-edge closed forms when
    separated, exact SAT depth over the 15 candidate axes when
    overlapping."""
    c0 = _box_corners(R0, p0, h0)
    c1 = _box_corners(R1, p1, h1)
    d_v0 = point_box_sdf(rmatvec(R1[..., None, :, :], c0 - p1[..., None, :]),
                         h1[..., None, :])
    d_v1 = point_box_sdf(rmatvec(R0[..., None, :, :], c1 - p0[..., None, :]),
                         h0[..., None, :])
    ia = [e[0] for e in _BOX_EDGES]
    ib = [e[1] for e in _BOX_EDGES]
    e0a, e0b = c0[..., ia, :], c0[..., ib, :]                # [..., 12, 3]
    e1a, e1b = c1[..., ia, :], c1[..., ib, :]
    u, v = segment_segment_closest(
        e0a[..., :, None, :], e0b[..., :, None, :],
        e1a[..., None, :, :], e1b[..., None, :, :])
    d_ee = norm(u - v)                                       # [..., 12, 12]
    d_sep = torch.minimum(
        torch.minimum(torch.amin(d_v0, -1), torch.amin(d_v1, -1)),
        torch.amin(d_ee, (-2, -1)))

    R0T = R0.transpose(-1, -2)
    R1T = R1.transpose(-1, -2)
    cr = cross(R0T[..., :, None, :], R1T[..., None, :, :])
    cr = cr.reshape(*cr.shape[:-3], 9, 3)
    nrm = norm(cr)[..., None]
    ok = nrm > 1e-9
    cr = torch.where(ok, cr / torch.where(ok, nrm, torch.ones_like(nrm)),
                     R0T[..., 0:1, :])
    axes = torch.cat([R0T, R1T, cr], -2)                     # [..., 15, 3]
    r0 = (abs_(axes @ R0) * h0[..., None, :]).sum(-1)
    r1 = (abs_(axes @ R1) * h1[..., None, :]).sum(-1)
    sep = abs_((axes * (p1 - p0)[..., None, :]).sum(-1))
    overlap = r0 + r1 - sep
    separated = torch.any(overlap < 0.0, -1)
    pen = torch.maximum(torch.amin(overlap, -1), overlap.new_zeros(()))
    return torch.where(separated, d_sep, -pen)


def box_box_axis_aligned(R0, p0, h0, R1, p1, h1):
    """Signed distance between two boxes via the per-axis gap formula in
    box-0's frame (exact for mutually axis-aligned boxes, the rotated
    AABB of box 1 otherwise)."""
    R_rel = R0.transpose(-1, -2) @ R1
    p_rel = rmatvec(R0, p1 - p0)
    h1_aab = matvec(abs_(R_rel), h1)
    gap = abs_(p_rel) - (h0 + h1_aab)
    outside = norm(torch.maximum(gap, gap.new_zeros(())))
    inside = torch.minimum(torch.amax(gap, -1), gap.new_zeros(()))
    return outside + inside
