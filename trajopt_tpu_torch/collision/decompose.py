"""Approximate convex decomposition of triangle meshes (VHACD analog), and
mesh loading.

The port's own copy of ``trajopt_tpu/collision/decompose.py`` (host-side
numpy and scipy; the port imports nothing of the JAX package): STL and OBJ
loading (and a binary STL writer, :func:`save_stl`), ``box_mesh`` /
``concat_meshes``, the minimum-volume primitive fits
(sphere, capsule, PCA-oriented box), the recursive plane-splitting
decomposition driven by a hull-concavity measure, and
:func:`add_decomposition`, which registers the fitted pieces on the port's
``CollisionScene``.  Everything here runs once per model on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np

try:
    from scipy.spatial import ConvexHull
    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Triangle mesh: vertices [V, 3] float, faces [F, 3] int."""

    vertices: np.ndarray
    faces: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "vertices",
                           np.asarray(self.vertices, np.float64))
        object.__setattr__(self, "faces", np.asarray(self.faces, np.int64))


def load_stl(path: str) -> Mesh:
    """STL loader (binary and ASCII), deduplicating shared vertices.

    Covers the reference fixtures' collision meshes (pr2.urdf /
    arm_around_table.urdf reference only .stl collision geometry;
    tesseract loads them through its resource locator)."""
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        if head == b"solid":
            # could still be binary with a "solid" header; sniff for
            # "facet" in the first KB
            blob = f.read(1024)
            f.seek(0)
            if b"facet" in blob:
                return _load_stl_ascii(f.read().decode("ascii", "ignore"))
        data = f.read()
    n_tri = int(np.frombuffer(data[80:84], "<u4")[0])
    rec = np.frombuffer(data[84:84 + n_tri * 50],
                        dtype=np.dtype([("n", "<f4", 3), ("v", "<f4", (3, 3)),
                                        ("attr", "<u2")]))
    tri_verts = rec["v"].reshape(-1, 3).astype(np.float64)
    verts, inv = np.unique(tri_verts.round(9), axis=0, return_inverse=True)
    return Mesh(verts, inv.reshape(-1, 3))


def _load_stl_ascii(text: str) -> Mesh:
    vals = []
    for line in text.splitlines():
        parts = line.split()
        if parts[:1] == ["vertex"]:
            vals.append([float(x) for x in parts[1:4]])
    tri_verts = np.asarray(vals, np.float64)
    verts, inv = np.unique(tri_verts.round(9), axis=0, return_inverse=True)
    return Mesh(verts, inv.reshape(-1, 3))


def save_stl(path: str, mesh: Mesh) -> None:
    """Write a binary STL (zero normals, as :func:`load_stl` ignores
    them)."""
    tris = mesh.vertices[mesh.faces].astype("<f4")            # [F, 3, 3]
    rec = np.zeros(tris.shape[0], np.dtype([("n", "<f4", 3),
                                            ("v", "<f4", (3, 3)),
                                            ("attr", "<u2")]))
    rec["v"] = tris
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(np.asarray([tris.shape[0]], "<u4").tobytes())
        f.write(rec.tobytes())


def load_mesh(path: str) -> Mesh:
    """Load a triangle mesh by extension (.stl binary/ascii, .obj)."""
    lower = path.lower()
    if lower.endswith(".stl") or lower.endswith(".stla"):
        return load_stl(path)
    if lower.endswith(".obj"):
        return load_obj(path)
    raise ValueError(f"unsupported mesh format: {path}")


def load_obj(path: str) -> Mesh:
    """Minimal Wavefront OBJ loader (v / f records, triangulates fans)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return Mesh(np.asarray(verts), np.asarray(faces))


def box_mesh(half_extents, center=(0, 0, 0)) -> Mesh:
    """Axis-aligned box surface as 12 triangles (test/demo helper)."""
    h = np.asarray(half_extents, np.float64)
    c = np.asarray(center, np.float64)
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], np.float64) * h + c
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = []
    for a, b, cc, d in quads:
        faces += [[a, b, cc], [a, cc, d]]
    return Mesh(corners, np.asarray(faces))


def concat_meshes(*meshes: Mesh) -> Mesh:
    verts, faces, off = [], [], 0
    for m in meshes:
        verts.append(m.vertices)
        faces.append(m.faces + off)
        off += m.vertices.shape[0]
    return Mesh(np.concatenate(verts), np.concatenate(faces))


# ----------------------------------------------------------------- fitting


@dataclasses.dataclass(frozen=True)
class Piece:
    """One fitted convex piece."""

    kind: str                 # "sphere" | "capsule" | "box"
    params: tuple             # sphere: (r,); capsule: (r, a, b); box: (half,)
    center: np.ndarray
    R: np.ndarray             # box orientation (identity otherwise)
    volume: float
    hull_vertices: np.ndarray  # the piece's convex hull vertex coordinates


def _point_segment_dist(p, a, b):
    ab = b - a
    t = np.clip(((p - a) @ ab) / max(float(ab @ ab), 1e-30), 0.0, 1.0)
    return np.linalg.norm(p - (a + t[..., None] * ab), axis=-1)


def _fit_sphere(pts):
    c = 0.5 * (pts.min(0) + pts.max(0))
    r = float(np.linalg.norm(pts - c, axis=1).max())
    vol = 4.0 / 3.0 * np.pi * r**3
    return ("sphere", (r,), c, np.eye(3), vol)


def _pca_frame(pts):
    c = pts.mean(0)
    x = pts - c
    _, _, Vt = np.linalg.svd(x, full_matrices=False)
    R = Vt.T
    if np.linalg.det(R) < 0:
        R[:, -1] *= -1
    return c, R


def _candidate_axes(pts):
    """Capsule/box axis candidates: PCA, coordinate axes, point diameter.

    PCA alone tilts under asymmetric sampling (a 0.2-radius cylinder came
    out r=0.228); cheap extra candidates make axis-aligned and
    diameter-aligned shapes tight."""
    c, R = _pca_frame(pts)
    axes = [R[:, 0], np.array([1.0, 0, 0]), np.array([0, 1.0, 0]),
            np.array([0, 0, 1.0])]
    t = (pts - c) @ R[:, 0]
    diam = pts[int(np.argmax(t))] - pts[int(np.argmin(t))]
    nrm = np.linalg.norm(diam)
    if nrm > 1e-12:
        axes.append(diam / nrm)
    return c, R, axes


def _capsule_along(pts, c, u):
    # recenter the axis line on the perpendicular bounding-box midpoint
    # (the mean is not the enclosing-circle center)
    perp = (pts - c) - np.outer((pts - c) @ u, u)
    c = c + 0.5 * (perp.min(0) + perp.max(0))
    t = (pts - c) @ u
    a = c + u * float(t.min())
    b = c + u * float(t.max())
    r = float(_point_segment_dist(pts, a, b).max()) + 1e-12
    # pull endpoints in by r where possible (tighter hemispheres), keeping
    # every point enclosed
    L = float(np.linalg.norm(b - a))
    shrink = min(r, 0.5 * L)
    a2, b2 = a + u * shrink, b - u * shrink
    r2 = float(_point_segment_dist(pts, a2, b2).max()) + 1e-12
    if r2 <= r * 1.05:
        a, b, r = a2, b2, r2
    L = float(np.linalg.norm(b - a))
    vol = np.pi * r * r * (4.0 / 3.0 * r + L)
    return ("capsule", (r, a, b), 0.5 * (a + b), np.eye(3), vol)


def _fit_capsule(pts):
    c, _, axes = _candidate_axes(pts)
    return min((_capsule_along(pts, c, u) for u in axes),
               key=lambda t: t[-1])


def _frame_from_axis(u):
    w = np.array([0.0, 0.0, 1.0]) if abs(u[2]) < 0.9 else np.array([1.0, 0, 0])
    v = np.cross(u, w)
    v /= np.linalg.norm(v)
    return np.stack([u, v, np.cross(u, v)], axis=1)


def _box_in_frame(pts, c, R):
    local = (pts - c) @ R
    lo, hi = local.min(0), local.max(0)
    half = 0.5 * (hi - lo) + 1e-12
    center = c + R @ (0.5 * (hi + lo))
    vol = float(8.0 * np.prod(half))
    return ("box", (half,), center, R, vol)


def _fit_box(pts):
    c, R, axes = _candidate_axes(pts)
    frames = [R, np.eye(3)] + [_frame_from_axis(u) for u in axes]
    return min((_box_in_frame(pts, c, F) for F in frames),
               key=lambda t: t[-1])


def fit_primitive(pts: np.ndarray) -> Piece:
    """Minimum-volume enclosing primitive among sphere/capsule/PCA box."""
    cands = [_fit_sphere(pts), _fit_capsule(pts), _fit_box(pts)]
    kind, params, center, R, vol = min(cands, key=lambda t: t[-1])
    hull_v = _hull_points(pts)
    return Piece(kind=kind, params=params, center=center, R=R, volume=vol,
                 hull_vertices=hull_v)


# ----------------------------------------------------- decomposition core


def _hull_points(pts):
    if _HAVE_SCIPY and pts.shape[0] >= 4:
        try:
            return pts[ConvexHull(pts, qhull_options="QJ").vertices]
        except Exception:
            return pts
    return pts


def _hull_concavity(samples):
    """Max depth of surface samples inside their own convex hull."""
    if not _HAVE_SCIPY or samples.shape[0] < 5:
        return 0.0, 0.0
    try:
        hull = ConvexHull(samples, qhull_options="QJ")
    except Exception:
        return 0.0, 0.0
    eq = hull.equations  # [nf, 4]: n·x + d <= 0 inside
    depth = -(samples @ eq[:, :3].T + eq[:, 3][None, :]).max(axis=1)
    return float(depth.max(initial=0.0)), float(hull.volume)


def _piece_samples(mesh: Mesh, face_idx):
    f = mesh.faces[face_idx]
    v = mesh.vertices
    centroids = v[f].mean(axis=1)
    edge_mids = 0.5 * (v[f] + v[f[:, [1, 2, 0]]]).reshape(-1, 3)
    verts = v[np.unique(f)]
    return np.concatenate([verts, centroids, edge_mids])


def decompose(mesh: Mesh, max_concavity: float = 0.02,
              max_pieces: int = 32, max_depth: int = 8) -> list[Piece]:
    """VHACD-style recursive decomposition into fitted convex pieces.

    max_concavity is absolute (same units as the mesh).  Splitting plane:
    axis-aligned through the centroid of the deepest concave sample,
    choosing the axis that minimizes the children's combined hull volume
    (VHACD's volume-based concavity proxy).
    """
    if not _HAVE_SCIPY:
        # graceful degradation: one enclosing primitive
        return [fit_primitive(mesh.vertices)]

    out: list[Piece] = []
    work = [(np.arange(mesh.faces.shape[0]), 0)]
    centroids_all = mesh.vertices[mesh.faces].mean(axis=1)

    while work:
        face_idx, depth = work.pop()
        samples = _piece_samples(mesh, face_idx)
        conc, _ = _hull_concavity(samples)
        done = (conc <= max_concavity or depth >= max_depth
                or face_idx.size <= 2
                or len(out) + len(work) + 1 >= max_pieces)
        if done:
            out.append(fit_primitive(samples))
            continue

        cents = centroids_all[face_idx]
        # deepest sample drives the split location
        best = None
        for axis in range(3):
            pivot = np.median(cents[:, axis])
            left = face_idx[cents[:, axis] <= pivot]
            right = face_idx[cents[:, axis] > pivot]
            if left.size == 0 or right.size == 0:
                continue
            vol = 0.0
            for side in (left, right):
                _, v = _hull_concavity(_piece_samples(mesh, side))
                vol += v
            if best is None or vol < best[0]:
                best = (vol, left, right)
        if best is None:
            out.append(fit_primitive(samples))
            continue
        _, left, right = best
        work.append((left, depth + 1))
        work.append((right, depth + 1))
    return out


# ------------------------------------------------------- scene integration


def add_decomposition(scene, mesh: Mesh, *, link: str | None = None,
                      name: str = "mesh", max_concavity: float = 0.02,
                      max_pieces: int = 32) -> list[Piece]:
    """Decompose and register the pieces as collision geometry.

    link=None adds static world geometry; otherwise geometry attached to
    the named robot link (piece poses are in the link's local frame, like
    VHACD output consumed by the reference's environment)."""
    pieces = decompose(mesh, max_concavity=max_concavity,
                       max_pieces=max_pieces)
    for i, pc in enumerate(pieces):
        nm = f"{name}_{i}"
        if pc.kind == "sphere":
            if link is None:
                scene.add_world_sphere(nm, pc.params[0], center=pc.center)
            else:
                scene.add_link_sphere(link, pc.params[0], center=pc.center,
                                      name=nm)
        elif pc.kind == "capsule":
            r, a, b = pc.params
            if link is None:
                from trajopt_tpu_torch.collision.world import CAPSULE, CollGeom
                scene.add_geom(CollGeom(nm, CAPSULE, (float(r),), link=None,
                                        ea=a, eb=b))
            else:
                scene.add_link_capsule(link, r, a, b, name=nm)
        else:  # box
            (half,) = pc.params
            if link is None:
                scene.add_world_box(nm, half, center=pc.center, R=pc.R)
            else:
                from trajopt_tpu_torch.collision.world import BOX, CollGeom
                scene.add_geom(CollGeom(nm, BOX, tuple(half), link=link,
                                        R_local=pc.R, p_local=pc.center))
    return pieces


def contains(piece: Piece, p: np.ndarray, tol: float = 1e-6) -> bool:
    """Point-inside test for a fitted piece (used by coverage checks)."""
    if piece.kind == "sphere":
        return float(np.linalg.norm(p - piece.center)) <= piece.params[0] + tol
    if piece.kind == "capsule":
        r, a, b = piece.params
        return float(_point_segment_dist(p[None], a, b)[0]) <= r + tol
    (half,) = piece.params
    local = piece.R.T @ (p - piece.center)
    return bool(np.all(np.abs(local) <= half + tol))
