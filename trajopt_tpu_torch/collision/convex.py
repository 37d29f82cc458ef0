"""Convex-polytope (mesh hull) narrowphase on sphere-swept vertex sets.

Counterpart of ``trajopt_tpu/collision/convex.py``.  Every shape is a padded
vertex set plus a sweep radius: a hull is its vertices with radius 0, a
sphere 1 vertex + r, a capsule 2 vertices + r, a box its 8 corners.  One
function, :func:`convex_convex`, covers every pairing, batched over any
leading shape:

* separated: GJK on the Minkowski-difference support problem, a fixed
  number of support steps (``GJK_ITERS``) on a 4-slot simplex, keeping the
  BEST iterate (not the last) and merging duplicate slots before one is
  evicted.  The distance is the envelope form ``|wa@Va - wb@Vb|`` with the
  weights computed under ``torch.no_grad``, so pose gradients are the
  witness-point gradients, with no backward pass through the iterations.
* penetrating: the separating-axis (SAT) depth over the caller's axes (both
  hulls' face normals and edge-direction cross products), the centroid axis
  and the GJK witness axis.  The winning axis and vertices are found under
  ``no_grad`` and the winning gap is recomputed from the three gathered
  vectors, so gradients flow only through that expression.

Separation is decided by GJK's certificate (a best-iterate distance above
``eps``) or by a SAT separating axis, never by SAT alone.  ``eps`` depends
on the dtype: ``1e-4 * scale`` in float32, ``1e-11 * scale`` otherwise.

The discrete search -- GJK's best simplex (:func:`_gjk_slots`), the
witness vector and the SAT winner (:func:`_sat_select`) -- is one function,
``fused_convex.select``: a hand-written CUDA kernel on CUDA tensors, its
plain version (built from this module's functions) on CPU tensors.  Only
the epilogue (:func:`_epilogue`: the witness distance, the winning gap and
the certificate, from the selected indices) carries gradients.

The ``no_grad`` regions sit exactly where the JAX function has
``jax.lax.stop_gradient`` (the GJK loop, the SAT projections, the witness
axis and ``scale``): autograd through the GJK iterations would give other
Jacobians, not only slower ones.

Rounding.  Ties decide the subgradient: edge-mode padding repeats hull
vertices, and the support ``argmin`` must see bit-identical values for
repeated rows so that it returns the first of them (as ``argmin`` does in
both packages); a face normal that wins the SAT leaves the face's vertices
tied up to rounding.  So every product that the JAX function writes as a
matrix product (``@``, ``einsum``) is a chain of fused multiply-adds in
index order here (:func:`_dot3`, :func:`_wsum`, ``torch.addcmul``), as XLA
computes a dot on the CPU, and everything else is plain elementwise
arithmetic: the same rounding as the JAX function run op by op, and every
query independent of how many share a call (a call split over lanes gives
the unsplit call's bits).  No matrix-product kernel is used.
"""

from __future__ import annotations

import numpy as np
import torch

from trajopt_tpu_torch.utils import on_device

# GJK support steps: finite convergence on polytopes (~10 at reference hull
# sizes; 16 passed every accuracy battery of the JAX package's tests).
GJK_ITERS = 16

# The 15 non-empty subsets of a 4-point simplex, as masks [15, 4].
_SUBSETS = np.array([[int(b) for b in f"{m:04b}"] for m in range(1, 16)],
                    np.float64)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting dot product over the last axis (of length 3), as a
    fused multiply-add chain in coordinate order."""
    return torch.addcmul(torch.addcmul(a[..., 0] * b[..., 0], a[..., 1],
                                       b[..., 1]), a[..., 2], b[..., 2])


def _sq3(a: torch.Tensor) -> torch.Tensor:
    """``sum(a * a, -1)`` over a last axis of length 3, plain (a product
    then a sum in the JAX function, not a dot)."""
    return (a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]) \
        + a[..., 2] * a[..., 2]


def _wsum(w: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``w @ rows`` for ``w [..., k]``, ``rows [..., k, 3]`` as a fused
    multiply-add chain over k in order."""
    acc = w[..., 0, None] * rows[..., 0, :]
    for i in range(1, w.shape[-1]):
        acc = torch.addcmul(acc, w[..., i, None], rows[..., i, :])
    return acc


def _rotate(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R @ v`` for ``R [..., 3, 3]``, ``v [..., 3]`` (broadcasting), each
    row a :func:`_dot3`: the rounding of the JAX package's ``einsum`` /
    ``v @ R.T`` of posed vertices, normals and edges."""
    return torch.stack([_dot3(R[..., i, :], v) for i in range(3)], -1)


def _gather_rows(V: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``V[..., idx, :]`` per batch element: V [..., n, 3], idx [..., k]."""
    return V.gather(-2, idx[..., None].expand(*idx.shape, V.shape[-1]))


def _chol4_solve(G: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form Cholesky solve of SPD 4x4 systems ``G [..., 4, 4]``,
    ``b [..., 4]``, pure arithmetic.  Degenerate pivots are floored; their
    garbage solutions are filtered by the caller's feasibility check."""
    tiny = 1e-30

    def g(i, j):
        return G[..., i, j]

    l11 = torch.sqrt(torch.clamp_min(g(0, 0), tiny))
    l21 = g(1, 0) / l11
    l31 = g(2, 0) / l11
    l41 = g(3, 0) / l11
    l22 = torch.sqrt(torch.clamp_min(g(1, 1) - l21 * l21, tiny))
    l32 = (g(2, 1) - l31 * l21) / l22
    l42 = (g(3, 1) - l41 * l21) / l22
    l33 = torch.sqrt(torch.clamp_min(g(2, 2) - l31 * l31 - l32 * l32, tiny))
    l43 = (g(3, 2) - l41 * l31 - l42 * l32) / l33
    l44 = torch.sqrt(torch.clamp_min(
        g(3, 3) - l41 * l41 - l42 * l42 - l43 * l43, tiny))
    y1 = b[..., 0] / l11
    y2 = (b[..., 1] - l21 * y1) / l22
    y3 = (b[..., 2] - l31 * y1 - l32 * y2) / l33
    y4 = (b[..., 3] - l41 * y1 - l42 * y2 - l43 * y3) / l44
    x4 = y4 / l44
    x3 = (y3 - l43 * x4) / l33
    x2 = (y2 - l32 * x3 - l42 * x4) / l22
    x1 = (y1 - l21 * x2 - l31 * x3 - l41 * x4) / l11
    return torch.stack([x1, x2, x3, x4], -1)


def _closest_on_simplex(W: torch.Tensor) -> torch.Tensor:
    """Barycentric weights [..., 4] of the closest point to the origin on
    the convex hull of the 4 points ``W [..., 4, 3]``, by enumerating all 15
    vertex subsets: each subset's affine minimizer is lam = G^-1 1 / (1'
    G^-1 1) with G the subset's Gram matrix; the projection is the feasible
    (lam >= 0) subset minimizer of least norm.  Branch-free."""
    sub = on_device(_SUBSETS, "subsets", lambda: _SUBSETS, W.device,
                    W.dtype)
    G = _dot3(W[..., :, None, :], W[..., None, :, :])      # [..., 4, 4]
    # Padded per-subset systems: identity rows/cols off the subset, and a
    # tiny ridge that keeps degenerate subsets solvable (their lam goes
    # infeasible or non-minimal and drops out).
    m2 = sub[:, :, None] * sub[:, None, :]                 # [15, 4, 4]
    eye = torch.eye(4, dtype=W.dtype, device=W.device)
    Gs = G[..., None, :, :] * m2 + eye * (1.0 - m2)
    Gs = Gs + 1e-12 * eye
    lam = _chol4_solve(Gs, sub.expand(*Gs.shape[:-1])) * sub
    denom = (((lam[..., 0] + lam[..., 1]) + lam[..., 2])
             + lam[..., 3])[..., None]
    nonzero = denom.abs() > 1e-30
    lam = lam / torch.where(nonzero, denom, torch.ones_like(denom))
    pts = _wsum(lam, W[..., None, :, :])                      # [..., 15, 3]
    n2 = _sq3(pts)
    feasible = (lam >= -1e-9).all(-1) & nonzero[..., 0] \
        & torch.isfinite(lam).all(-1)
    n2 = torch.where(feasible, n2, torch.full_like(n2, float("inf")))
    best = torch.argmin(n2, -1)
    lam = lam.gather(-2, best[..., None, None].expand(*best.shape, 1, 4))
    return torch.clamp(lam[..., 0, :], 0.0, 1.0)


def _merge_duplicates(idA, idB, lam):
    """Consolidate each duplicate slot's weight (the same Minkowski vertex
    twice) into its first copy, so that a zero-weight slot exists whenever
    the optimum has <= 3 support points and ``argmin`` evicts no needed
    support point (which would send GJK into a 2-cycle)."""
    lam = list(lam.unbind(-1))
    zero = torch.zeros((), dtype=lam[0].dtype, device=lam[0].device)
    for i in range(4):
        for j in range(i + 1, 4):
            dup = (idA[..., i] == idA[..., j]) & (idB[..., i] == idB[..., j])
            lam[i] = lam[i] + torch.where(dup, lam[j], zero)
            lam[j] = torch.where(dup, zero, lam[j])
    return torch.stack(lam, -1)


def _slot_weights(idx: torch.Tensor, lam: torch.Tensor, n: int):
    """[..., n] vertex weights: each slot's weight added at its vertex, in
    slot order (``zeros(n).at[idx].add(lam)``, without atomics)."""
    ids = torch.arange(n, device=idx.device)
    zero = torch.zeros((), dtype=lam.dtype, device=lam.device)
    w = torch.zeros((*idx.shape[:-1], n), dtype=lam.dtype, device=lam.device)
    for s in range(4):
        w = w + torch.where(ids == idx[..., s, None], lam[..., s, None], zero)
    return w


@torch.no_grad()
def _gjk_start(A: torch.Tensor, B: torch.Tensor):
    """GJK's first state (idA, idB, lam): every slot at the first vertex
    pair, all weight on slot 0."""
    idA = torch.zeros((*A.shape[:-2], 4), dtype=torch.long, device=A.device)
    lam = torch.zeros((*A.shape[:-2], 4), dtype=A.dtype, device=A.device)
    lam[..., 0] = 1.0
    return idA, torch.zeros_like(idA), lam


def _gjk_step(A, B, idA, idB, lam, slots):
    """One support step of :func:`_gjk_slots` from the slots ``idA``,
    ``idB`` and weights ``lam``: the new slots and weights, and the squared
    norm of their iterate.  ``slots`` is ``arange(4)``."""
    z = _wsum(lam, _gather_rows(A, idA) - _gather_rows(B, idB))
    sa = torch.argmin(_dot3(A, z[..., None, :]), -1)
    sb = torch.argmax(_dot3(B, z[..., None, :]), -1)
    # replace the least-contributing slot with the new support point
    slot = torch.argmin(_merge_duplicates(idA, idB, lam), -1)
    put = slots == slot[..., None]
    idA = torch.where(put, sa[..., None], idA)
    idB = torch.where(put, sb[..., None], idB)
    W = _gather_rows(A, idA) - _gather_rows(B, idB)
    lam = _closest_on_simplex(W)
    z2 = _wsum(lam, W)
    return idA, idB, lam, _dot3(z2, z2)


def _gjk_slots(A: torch.Tensor, B: torch.Tensor, iters: int = GJK_ITERS):
    """GJK's best simplex: (idA [..., 4], idB [..., 4], lam [..., 4]), the
    Minkowski vertices' indices in ``A [..., nA, 3]`` and ``B [..., nB, 3]``
    (detached, one batch shape) and their barycentric weights, for min |x
    - y|, x in conv(A), y in conv(B): a 4-slot simplex on the Minkowski
    difference, support steps and the subset-enumeration distance
    subproblem."""
    A, B = A.detach(), B.detach()
    idA, idB, lam = _gjk_start(A, B)
    slots = torch.arange(4, device=A.device)
    z0 = _wsum(lam, _gather_rows(A, idA) - _gather_rows(B, idB))
    bd2, bidA, bidB, blam = _dot3(z0, z0), idA, idB, lam
    for _ in range(iters):
        idA, idB, lam, d2 = _gjk_step(A, B, idA, idB, lam, slots)
        # Track the BEST iterate, not the last: once the simplex encloses
        # the origin the support direction degenerates and the next slot
        # replacement can break the enclosing simplex.
        take = d2 < bd2
        bd2 = torch.where(take, d2, bd2)
        bidA = torch.where(take[..., None], idA, bidA)
        bidB = torch.where(take[..., None], idB, bidB)
        blam = torch.where(take[..., None], lam, blam)
    return bidA, bidB, blam


def _gjk_weights(A: torch.Tensor, B: torch.Tensor, iters: int = GJK_ITERS):
    """GJK witness weights (wa [..., nA], wb [..., nB]) of
    :func:`_gjk_slots` (the JAX function's return value)."""
    idA, idB, lam = _gjk_slots(A, B, iters)
    return (_slot_weights(idA, lam, A.shape[-2]),
            _slot_weights(idB, lam, B.shape[-2]))


def _sort4(idx: torch.Tensor) -> torch.Tensor:
    """``torch.sort(idx, -1).values`` of ``idx [..., 4]`` by a sorting
    network of five compare-exchanges (elementwise minimum and maximum),
    which the card runs as a few elementwise kernels instead of a radix
    sort."""
    a, b, c, d = idx.unbind(-1)
    a, b = torch.minimum(a, b), torch.maximum(a, b)
    c, d = torch.minimum(c, d), torch.maximum(c, d)
    a, c = torch.minimum(a, c), torch.maximum(a, c)
    b, d = torch.minimum(b, d), torch.maximum(b, d)
    b, c = torch.minimum(b, c), torch.maximum(b, c)
    return torch.stack([a, b, c, d], -1)


def _witness(V: torch.Tensor, idx: torch.Tensor, lam: torch.Tensor):
    """``w @ V`` with ``w = zeros(n).at[idx].add(lam)``, differentiable in
    ``V``: the fused multiply-add chain over the weighted vertices in
    ascending index order (a zero weight adds nothing exactly), as XLA
    computes the dense product."""
    with torch.no_grad():
        order = _sort4(idx)
        w = _slot_weights(idx, lam, V.shape[-2]).gather(-1, order)
        repeat = torch.cat([torch.zeros_like(order[..., :1], dtype=torch.bool),
                            order[..., 1:] == order[..., :-1]], -1)
        w = torch.where(repeat, torch.zeros((), dtype=w.dtype,
                                            device=w.device), w)
    return _wsum(w, _gather_rows(V, order))


@torch.no_grad()
def _sat_select(Va, Vb, axes, valid):
    """The selection half of :func:`_sat_depth`: (k, flip, ia, ib), each
    ``[..., 1]``: the winning axis (the first of the largest gaps), whether
    a lies above b along it, and the extreme vertices of a and b whose gap
    it is."""
    ax = axes.detach()
    pa = _dot3(Va.detach()[..., :, None, :], ax[..., None, :, :])
    pb = _dot3(Vb.detach()[..., :, None, :], ax[..., None, :, :])
    nrm_s = torch.sqrt(_sq3(ax) + 1e-24)
    gap_ba = (pb.amin(-2) - pa.amax(-2)) / nrm_s           # [..., K]
    gap_ab = (pa.amin(-2) - pb.amax(-2)) / nrm_s
    gap = torch.maximum(gap_ba, gap_ab)
    gap = torch.where(valid & (nrm_s > 1e-9), gap,
                      torch.full_like(gap, -float("inf")))
    k = torch.argmax(gap, -1)[..., None]
    flip = gap_ab.gather(-1, k) > gap_ba.gather(-1, k)      # a above b won
    kk = k[..., None, :]
    pa_k = pa.gather(-1, kk.expand(*pa.shape[:-1], 1))[..., 0]
    pb_k = pb.gather(-1, kk.expand(*pb.shape[:-1], 1))[..., 0]
    ia = torch.where(flip, pa_k.argmin(-1, keepdim=True),
                     pa_k.argmax(-1, keepdim=True))
    ib = torch.where(flip, pb_k.argmax(-1, keepdim=True),
                     pb_k.argmin(-1, keepdim=True))
    return k, flip, ia, ib


def _sat_gap(Va, Vb, u, flip, ia, ib):
    """The winning gap recomputed from the axis ``u [..., 3]`` and the
    vertices ``Va[ia]``, ``Vb[ib]`` alone (``flip``, ``ia``, ``ib``
    ``[..., 1]`` from :func:`_sat_select`): the only differentiable part
    of the SAT depth."""
    nrm = torch.sqrt(_dot3(u, u) + 1e-24)
    s = torch.where(flip[..., 0], -1.0, 1.0).to(u.dtype)
    diff = _gather_rows(Vb, ib)[..., 0, :] - _gather_rows(Va, ia)[..., 0, :]
    return s * _dot3(u, diff) / nrm


def _sat_depth(Va, Vb, axes, valid):
    """Best separating gap over candidate axes: max_k of max(min_b - max_a,
    min_a - max_b) along axis k (positive: a certified separation; negative:
    the penetration estimate).  ``valid`` masks padded axis rows.  The
    winning axis and vertices are chosen under ``no_grad``
    (:func:`_sat_select`); the gap is then recomputed from ``axes[k*]``,
    ``Va[ia*]`` and ``Vb[ib*]`` alone (:func:`_sat_gap`)."""
    k, flip, ia, ib = _sat_select(Va, Vb, axes, valid)
    return _sat_gap(Va, Vb, _gather_rows(axes, k)[..., 0, :], flip, ia, ib)


def edge_cross_axes(ea, ea_valid, eb, eb_valid):
    """SAT candidate axes from two edge-direction sets ``ea [..., Ea, 3]``,
    ``eb [..., Eb, 3]``: every cross(ea_i, eb_j), flattened to
    ``[..., Ea * Eb, 3]``, with the outer validity mask.  Near-parallel
    pairs give near-zero axes, which :func:`_sat_depth` masks by norm."""
    from trajopt_tpu_torch.collision.geometry import cross

    c = cross(ea[..., :, None, :], eb[..., None, :, :])
    v = ea_valid[..., :, None] & eb_valid[..., None, :]
    return (c.reshape(*c.shape[:-3], -1, 3),
            v.reshape(*v.shape[:-2], -1))


def convex_convex(Va, ra, Vb, rb, axes, axes_valid, iters: int = GJK_ITERS):
    """Signed distance between sphere-swept posed vertex sets, batched.

    ``Va [..., A, 3]``, ``Vb [..., B, 3]``: world-frame vertices; ``ra``,
    ``rb``: sweep radii (broadcasting to the batch); ``axes [..., K, 3]``:
    world-frame candidate separating axes (both hulls' face normals and
    edge-direction cross products, :func:`edge_cross_axes`) and
    ``axes_valid [..., K]`` masking padded rows; ``iters``: GJK support
    steps.

    The discrete search (GJK's best simplex and the SAT winner) is
    ``fused_convex.select``: the hand-written kernel on CUDA tensors, its
    plain version on CPU tensors.  Everything that carries a gradient
    (:func:`_epilogue`) is PyTorch."""
    # fused_convex builds its plain version from this module's functions
    from trajopt_tpu_torch.collision import fused_convex

    batch = torch.broadcast_shapes(Va.shape[:-2], Vb.shape[:-2],
                                   axes.shape[:-2])
    Va = Va.expand(*batch, *Va.shape[-2:])
    Vb = Vb.expand(*batch, *Vb.shape[-2:])
    axes = axes.expand(*batch, *axes.shape[-2:])
    axes_valid = axes_valid.expand(*batch, axes_valid.shape[-1])
    # Two extra candidate axes: the centroid difference (closes the
    # no-normal hole of spheres and capsules) and the GJK witness direction
    # (its gap IS the distance at a separated optimum, so SAT certifies
    # separation where no face normal or edge cross does).  The centroid
    # axis is computed here once, so the search and the gap see its bits.
    cax = Va.mean(-2) - Vb.mean(-2)
    sel = fused_convex.select(Va, Vb, axes, axes_valid, cax.detach(),
                              iters)
    return _epilogue(Va, ra, Vb, rb, axes, cax, sel)


def _all_axes(axes, cax, z):
    """The SAT candidates ``[..., K + 2, 3]``: the caller's axes, the
    centroid axis and the witness vector."""
    return torch.cat([axes, cax[..., None, :], z[..., None, :]], -2)


def _epilogue(Va, ra, Vb, rb, axes, cax, sel):
    """The differentiable part of :func:`convex_convex` from the search's
    result ``sel`` (``fused_convex.Selection``): the witness distance, the
    winning SAT gap, the certificate and the radii."""
    z = _witness(Va, sel.idA, sel.lam) - _witness(Vb, sel.idB, sel.lam)
    # safe norm: at penetration GJK converges to z = 0, where the norm's
    # gradient is 0/0; the epsilon keeps it bounded (|g| <= 1)
    d_gjk = torch.sqrt(_dot3(z, z) + 1e-24)
    u = _gather_rows(_all_axes(axes, cax, sel.z), sel.k)[..., 0, :]
    d_sat = _sat_gap(Va, Vb, u, sel.flip, sel.ia, sel.ib)
    # The certificate threshold scales with the scene: at true penetration
    # the best GJK iterate sits on the origin up to round-off of the 4x4
    # simplex solve.
    with torch.no_grad():
        scale = 1.0 + Va.abs().amax((-2, -1)) + Vb.abs().amax((-2, -1))
    eps = (1e-4 if z.dtype == torch.float32 else 1e-11) * scale
    separated = (d_gjk > eps) | (d_sat >= 0.0)
    return torch.where(separated, d_gjk, d_sat) - ra - rb


def hull_of(vertices: np.ndarray, max_vertices: int | None = None,
            max_edges: int = 24):
    """(hull vertices [V,3], deduplicated outward face normals [F,3],
    deduplicated edge directions [E,3]) of a point cloud (host-side numpy
    and scipy).

    Edge directions (unit, deduplicated up to sign, at most ``max_edges``
    ranked by total parallel-class edge length) feed the SAT edge-cross
    candidate axes.  ``max_vertices`` optionally decimates by greedy
    farthest-point selection (a slight under-approximation)."""
    from trajopt_tpu_torch.collision.decompose import _hull_points

    pts = np.asarray(vertices, float)
    normals = np.zeros((0, 3))
    edges = np.zeros((0, 3))
    hv = pts
    try:
        from scipy.spatial import ConvexHull

        # exact hull first (QJ joggles the input by ~1e-3 and biases the
        # face normals); QJ only for degenerate inputs
        try:
            hull = ConvexHull(pts)
        except Exception:
            hull = ConvexHull(pts, qhull_options="QJ")
        hv = pts[hull.vertices]
        eq = hull.equations[:, :3]
        eq = eq / np.maximum(np.linalg.norm(eq, axis=1, keepdims=True),
                             1e-30)
        uniq: list = []
        for n in eq:
            if not any(abs(float(n @ u)) > 0.99999 for u in uniq):
                uniq.append(n)
        normals = np.asarray(uniq)
        edges = _edge_directions(pts, hull.simplices, max_edges)
    except Exception:
        hv = _hull_points(pts)
    if max_vertices is not None and hv.shape[0] > max_vertices:
        sel = [int(np.argmax(np.linalg.norm(hv - hv.mean(0), axis=1)))]
        d = np.linalg.norm(hv - hv[sel[0]], axis=1)
        for _ in range(max_vertices - 1):
            i = int(np.argmax(d))
            sel.append(i)
            d = np.minimum(d, np.linalg.norm(hv - hv[i], axis=1))
        hv = hv[np.asarray(sel)]
    return hv, normals, edges


def _edge_directions(pts: np.ndarray, simplices: np.ndarray,
                     max_edges: int) -> np.ndarray:
    """Unique unit edge directions of a hull triangulation, deduplicated up
    to sign and ranked by the total length of each parallel class."""
    pairs = set()
    for tri in simplices:
        t = [int(i) for i in tri]
        for i, j in ((0, 1), (1, 2), (0, 2)):
            pairs.add((min(t[i], t[j]), max(t[i], t[j])))
    dirs: list = []       # representative unit directions
    weight: list = []     # accumulated parallel-class edge length
    for i, j in pairs:
        v = pts[j] - pts[i]
        n = float(np.linalg.norm(v))
        if n < 1e-12:
            continue
        u = v / n
        for k, d in enumerate(dirs):
            if abs(float(u @ d)) > 0.99999:
                weight[k] += n
                break
        else:
            dirs.append(u)
            weight.append(n)
    if not dirs:
        return np.zeros((0, 3))
    order = np.argsort(weight)[::-1][:max_edges]
    return np.asarray(dirs)[order]
