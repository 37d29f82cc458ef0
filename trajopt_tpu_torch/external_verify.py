"""Independent re-verification of solved trajectories, on the card.

Counterpart of ``benchmarks/external_verify.py``.  The solver's own swept
check (``models/benchmarks.py::swept_verify``) runs the same FK and the
same narrowphase as the solve (on the card, the hand kernels of
``csrc/primitive_narrowphase.cu`` and ``csrc/convex_narrowphase.cu``), so
a blind spot there would pass both the solve and the check.  This module
shares with them only the robot's URDF spec (``tree.joints``, the joint
order and the joint type constants), the ``CollGeom`` fields and the list
of pairs to check (``scene.pairs()``: the scene's adjacency, allowed
collision and SRDF filter, held against the JAX package's by the tests):

* FK: a numpy float64 matrix chain over the URDF joints
  (:func:`numpy_fk`); nothing of ``kinematics/chain.py``.
* Geometry: its own sphere-swept vertex form of each geom
  (:func:`vertex_form`): a sphere is its centre, a capsule its two
  endpoints, a box its 8 corners, a hull its vertices, each plus its
  radius.
* Sweep: every gap sampled densely (sub-steps <= 0.025 rad in joint space,
  half the swept check's 0.05, the same count for the whole batch).
* Narrowphase: support-function separation certificates over a fixed set
  of 134 directions (:func:`direction_set`): any direction u with
  ``min_b u.b - max_a u.a - ra - rb > 0`` proves the pair apart by at
  least that much.  They run as plain float64 torch ops, on the card
  unless ``device="cpu"`` is passed, chunked over configurations.  Each
  configuration no direction certifies goes to an exact minimum distance
  between the two hulls (scipy SLSQP over their convex weights, float64,
  on the host, read back as the support gap along the direction between
  its two points, a lower bound however far SLSQP got; where the hulls
  touch or overlap, minus the penetration depth, SLSQP over the
  direction), at most :data:`EXACT_CAP` a pair.
* Agreement: :meth:`Verdict.agreement` gives the JAX script's JSON fields
  against the solver's swept check; the certificates are loose by up to
  centimetres, so :meth:`Verdict.refine` makes the values below the swept
  check tight (a local direction search on the card, then the exact
  solver) to hold the two within a slack.

What it proves: a certified lower bound of every lane's clearance at every
sample.  What it does not: anything between two samples (the solver's
swept check covers the continuous sweep).  SDF pairs have no vertex form
and raise ``NotImplementedError``.

Run on the card (the flagship solved on hard-mix goals, then certified):

    python -m trajopt_tpu_torch.external_verify [n_lanes]   # default 100

``BENCH_LVS`` sets the solve's LVS sub-steps (default 2).  The lines go to
standard error, one JSON object with the JAX script's fields to standard
output.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from trajopt_tpu_torch import resolve_device
from trajopt_tpu_torch.kinematics import urdf as urdf_mod

# Joint-space length of a sub-step, half the swept check's 0.05.
SUB_LEN = 0.025
# Uncertified configurations sent to the exact solver, per pair.
EXACT_CAP = 200
# Largest float64 temporary of one chunk of certificates.
CHUNK_BYTES = 2 << 30
# Hull distances (m) at or below which the exact solver's answer (0 at
# any overlap) is replaced by the signed gap: SLSQP resolves the squared
# distance to about 1e-14, the distance to about 1e-7.
TOUCH = 1e-6
# The local direction search of :func:`local_gaps`: rounds, directions a
# side of its grid, and the grid's first half-width (rad; about the
# spacing of :func:`direction_set`).  It leaves SLSQP 43-155 of the
# 5000-8600 values a full-width path refines; with SLSQP for all of them,
# chip_smoke.py's phase 14 took 50-56 s instead of 4.5-4.7 s on an H100
# (PERF.md).
LOCAL_ROUNDS, LOCAL_GRID, LOCAL_SPAN = 8, 9, 0.3


# ------------------------------------------------------------ numpy FK

def _rpy(rpy) -> np.ndarray:
    r, p, y = float(rpy[0]), float(rpy[1]), float(rpy[2])

    def rx(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    return rz(y) @ ry(p) @ rx(r)


def _axis_angle(axis, th: np.ndarray) -> np.ndarray:
    """Rodrigues, batched over th [N]."""
    k = np.asarray(axis, float)
    k = k / np.linalg.norm(k)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    c = np.cos(th)[:, None, None]
    s = np.sin(th)[:, None, None]
    return c * np.eye(3) + s * K + (1 - c) * np.outer(k, k)


def numpy_fk(tree, Q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """World link poses at configurations Q [N, n_dof] -> (R [N, L, 3, 3],
    p [N, L, 3]): a plain float64 matrix chain over the URDF joints."""
    N = Q.shape[0]
    L = len(tree.link_names)
    R = np.zeros((N, L, 3, 3))
    p = np.zeros((N, L, 3))
    R[:, 0] = np.eye(3)
    for k, j in enumerate(tree.joints):
        par, chd = tree.parent_link[k], tree.child_link[k]
        Rp, pp = R[:, par], p[:, par]
        Rj = Rp @ _rpy(j.origin_rpy)
        pj = Rp @ np.asarray(j.origin_xyz, float) + pp
        qi = tree.q_index[k]
        if qi >= 0 and j.jtype == urdf_mod.REVOLUTE:
            Rj = Rj @ _axis_angle(j.axis, Q[:, qi])
        elif qi >= 0 and j.jtype == urdf_mod.PRISMATIC:
            d = np.asarray(j.axis, float)
            pj = pj + np.einsum("nij,j->ni", Rj, d) * Q[:, qi][:, None]
        R[:, chd] = Rj
        p[:, chd] = pj
    return R, p


# ---------------------------------------------------------- geometry

def vertex_form(g) -> tuple[np.ndarray, float]:
    """(vertices [V, 3] in the geom's link frame (the world frame for a
    static geom), radius) of a ``CollGeom``, from its fields alone."""
    R = np.asarray(g.R_local, float)
    p = np.asarray(g.p_local, float)
    if g.kind == "sphere":
        return p[None, :], float(g.params[0])
    if g.kind == "capsule":
        return np.stack([R @ np.asarray(g.ea, float) + p,
                         R @ np.asarray(g.eb, float) + p]), float(g.params[0])
    if g.kind == "box":
        signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                          for sz in (-1, 1)], float)
        return (signs * np.asarray(g.params, float)) @ R.T + p, 0.0
    if g.kind == "convex":
        return np.asarray(g.verts, float), \
            float(g.params[0]) if g.params else 0.0
    raise NotImplementedError(
        f"{g.name}: no vertex form for a {g.kind!r} geom")


def direction_set() -> np.ndarray:
    """[134, 3] fixed near-uniform unit directions: 128 on a Fibonacci
    sphere and the 6 axis directions."""
    i = np.arange(128)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    z = 1.0 - 2.0 * (i + 0.5) / len(i)
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    dirs = np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)
    return np.concatenate([dirs, np.eye(3), -np.eye(3)])


def exact_hull_distance(Va: np.ndarray, Vb: np.ndarray) -> float:
    """Minimum distance between conv(Va) and conv(Vb) (0.0 where they
    overlap) as a certified lower bound: scipy SLSQP on the two sets of
    convex weights, float64, then the support gap ``min_j u.b_j - max_i
    u.a_i`` along the unit direction u between its two points.  Any u's
    gap is a lower bound of the distance, and u's is the distance where
    SLSQP converged; SLSQP's own value, the length between its points, is
    an upper bound only."""
    from scipy.optimize import minimize

    na, nb = len(Va), len(Vb)

    def f(w):
        d = w[:na] @ Va - w[na:] @ Vb
        return d @ d

    def jac(w):
        d = w[:na] @ Va - w[na:] @ Vb
        return np.concatenate([2 * Va @ d, -2 * Vb @ d])

    w0 = np.concatenate([np.full(na, 1.0 / na), np.full(nb, 1.0 / nb)])
    cons = [{"type": "eq", "fun": lambda w: np.sum(w[:na]) - 1.0,
             "jac": lambda w: np.concatenate([np.ones(na), np.zeros(nb)])},
            {"type": "eq", "fun": lambda w: np.sum(w[na:]) - 1.0,
             "jac": lambda w: np.concatenate([np.zeros(na), np.ones(nb)])}]
    res = minimize(f, w0, jac=jac, bounds=[(0.0, 1.0)] * (na + nb),
                   constraints=cons, method="SLSQP",
                   options={"maxiter": 200, "ftol": 1e-14})
    d = res.x[na:] @ Vb - res.x[:na] @ Va
    n = np.linalg.norm(d)
    if n == 0.0:
        return 0.0
    return max(0.0, float((Vb @ d).min() - (Va @ d).max()) / n)


def signed_gap(Va: np.ndarray, Vb: np.ndarray, u0: np.ndarray) -> float:
    """The signed gap ``max over unit u of (min_j u.b_j - max_i u.a_i)``
    of conv(Va) and conv(Vb): minus the penetration depth where they
    overlap, their distance where they do not.  scipy SLSQP over (u, s,
    h), maximising s - h under s <= u.b_j, h >= u.a_i and |u| = 1, from
    the direction ``u0``, float64.  Every u's gap is a lower bound of the
    signed gap; the result is the better of the optimum's and u0's."""
    from scipy.optimize import minimize

    na, nb = len(Va), len(Vb)
    u0 = np.asarray(u0, float) / np.linalg.norm(u0)

    def gap(u):
        return float((Vb @ u).min() - (Va @ u).max())

    x0 = np.concatenate([u0, [(Vb @ u0).min(), (Va @ u0).max()]])
    lo = np.concatenate([Vb, -np.ones((nb, 1)), np.zeros((nb, 1))], 1)
    hi = np.concatenate([-Va, np.zeros((na, 1)), np.ones((na, 1))], 1)
    cons = [{"type": "ineq", "fun": lambda x: Vb @ x[:3] - x[3],
             "jac": lambda x: lo},
            {"type": "ineq", "fun": lambda x: x[4] - Va @ x[:3],
             "jac": lambda x: hi},
            {"type": "eq", "fun": lambda x: x[:3] @ x[:3] - 1.0,
             "jac": lambda x: np.concatenate([2 * x[:3], [0.0, 0.0]])}]
    res = minimize(lambda x: x[4] - x[3], x0,
                   jac=lambda x: np.array([0.0, 0.0, 0.0, -1.0, 1.0]),
                   constraints=cons, method="SLSQP",
                   options={"maxiter": 200, "ftol": 1e-14})
    u = res.x[:3] / np.linalg.norm(res.x[:3])
    return max(gap(u), gap(u0))


def exact_signed_distance(Va: np.ndarray, Vb: np.ndarray) -> float:
    """Signed distance of conv(Va) and conv(Vb), as a lower bound:
    :func:`exact_hull_distance` where it is above :data:`TOUCH`, else
    (touching or overlapping) minus the penetration depth,
    :func:`signed_gap` from the best direction of :func:`direction_set`
    (or the distance where that is larger and proves the hulls apart)."""
    d = exact_hull_distance(Va, Vb)
    if d > TOUCH:
        return d
    dirs = np.concatenate([direction_set(), -direction_set()])
    gaps = (Vb @ dirs.T).min(0) - (Va @ dirs.T).max(0)
    s = signed_gap(Va, Vb, dirs[np.argmax(gaps)])
    return max(d, s) if d > 0.0 else s


# ------------------------------------------------------------ sampling

def sample_configs(traj: np.ndarray) -> tuple[np.ndarray, int]:
    """Configurations [B * (T - 1) * (S + 1), n_dof] of ``traj [B, T,
    n_dof]`` (lane-major, then gap, then sample) with every gap cut into S
    sub-steps no longer than :data:`SUB_LEN` (S from the batch's longest
    step, at least 2), and S."""
    disp = np.linalg.norm(np.diff(traj, axis=1), axis=2).max()
    n_sub = max(2, int(np.ceil(disp / SUB_LEN)))
    fr = np.linspace(0.0, 1.0, n_sub + 1)
    q0 = traj[:, :-1][:, :, None, :]
    q1 = traj[:, 1:][:, :, None, :]
    Q = q0 + fr[None, None, :, None] * (q1 - q0)
    return Q.reshape(-1, traj.shape[-1]), n_sub


# -------------------------------------------------------- certificates

def local_gaps(Wa, Wb, device=None) -> np.ndarray:
    """[n] lower bounds of the signed gaps of conv(Wa[k]) and conv(Wb[k])
    (``Wa [n, Va, 3]``, ``Wb [n, Vb, 3]``, numpy): from the best direction
    of :func:`direction_set` (both orientations), a pattern search on the
    unit sphere, :data:`LOCAL_GRID` squared directions about the best one
    a round, their span shrunk threefold a round for :data:`LOCAL_ROUNDS`
    rounds, on ``device`` in float64.  Every direction's support gap is a
    lower bound of the signed gap, so is the best one."""
    kw = dict(dtype=torch.float64, device=resolve_device(device))
    dirs = torch.as_tensor(direction_set(), **kw)
    dirs = torch.cat([dirs, -dirs])
    t = torch.linspace(-1.0, 1.0, LOCAL_GRID, **kw)
    ga, gb = (v.flatten() for v in torch.meshgrid(t, t, indexing="ij"))
    n, vmax = len(Wa), max(Wa.shape[1], Wb.shape[1])
    chunk = max(1, (256 << 20) // (8 * vmax * max(len(dirs),
                                                 LOCAL_GRID ** 2)))
    out = []
    for s in range(0, n, chunk):
        A = torch.as_tensor(Wa[s:s + chunk], **kw)
        B = torch.as_tensor(Wb[s:s + chunk], **kw)

        def gap(U):                                   # U [m, k, 3] -> [m, k]
            return torch.einsum("nvi,nki->nvk", B, U).amin(1) \
                - torch.einsum("nvi,nki->nvk", A, U).amax(1)

        best, k = gap(dirs.expand(len(A), -1, -1)).max(1)
        u = dirs[k]
        span = LOCAL_SPAN
        for _ in range(LOCAL_ROUNDS):
            helper = torch.where((u[:, :1].abs() < 0.9),
                                 torch.tensor([1.0, 0.0, 0.0], **kw),
                                 torch.tensor([0.0, 1.0, 0.0], **kw))
            e1 = torch.linalg.cross(u, helper)
            e1 = e1 / torch.linalg.vector_norm(e1, dim=-1, keepdim=True)
            e2 = torch.linalg.cross(u, e1)
            U = u[:, None] + span * (ga[None, :, None] * e1[:, None]
                                     + gb[None, :, None] * e2[:, None])
            U = U / torch.linalg.vector_norm(U, dim=-1, keepdim=True)
            g, k = gap(U).max(1)
            better = g > best
            best = torch.where(better, g, best)
            u = torch.where(better[:, None],
                            U[torch.arange(len(U), device=U.device), k], u)
            span /= 3.0
        out.append(best)
    return torch.cat(out).cpu().numpy()


@dataclasses.dataclass
class Verdict:
    """The certified outcome for B lanes.

    ``lane_min [B]``: a lower bound of each lane's clearance at every
    sample (the exact solver's lower bound where a configuration was
    escalated);
    ``escalations``: configurations sent to the exact solver;
    ``max_exact_penetration``: the deepest penetration it found (0.0 for
    none); ``left_uncertified``: configurations neither certified nor
    escalated (beyond :data:`EXACT_CAP` a pair; their lane is not free);
    ``exact``: (lane, pair names, distance) of every escalated
    configuration; ``samples``: configurations a lane; ``pair_min [P,
    N]``: each pair's certificate or exact distance at each
    configuration; ``solved [P, N]``: where it is exact;
    ``pair_world(pi, idx)``: the world vertices of pair ``pi``'s two geoms
    at configurations ``idx`` and their radii's sum; ``device``: where
    the certificates ran."""

    lane_min: np.ndarray
    escalations: int
    max_exact_penetration: float
    left_uncertified: int
    exact: list
    samples: int
    pair_min: np.ndarray = dataclasses.field(repr=False)
    solved: np.ndarray = dataclasses.field(repr=False)
    pair_world: object = dataclasses.field(repr=False)
    device: torch.device = dataclasses.field(repr=False)

    def agreement(self, repo_mins) -> dict:
        """The JAX script's JSON fields against ``repo_mins [B]`` (the
        solver's swept check on the same lanes): lanes, lanes certified
        free, lanes with the same free / colliding verdict, escalations,
        left uncertified, the worst certified clearance, and the range of
        ``repo_mins - lane_min`` (<= 0 up to sampling slack where the
        certificates are tight: the swept check under-estimates
        clearance)."""
        repo = _numpy(repo_mins)
        diff = repo - self.lane_min
        return {"lanes": int(len(self.lane_min)),
                "external_free": int((self.lane_min > 0.0).sum()),
                "agree": int(((repo > 0) == (self.lane_min > 0)).sum()),
                "escalations": self.escalations,
                "left_uncertified": self.left_uncertified,
                "worst_clearance": float(self.lane_min.min()),
                "diff_min": float(diff.min()),
                "diff_max": float(diff.max())}

    def refine(self, bounds) -> tuple[np.ndarray, int, int, int]:
        """Per lane, a lower bound of its clearance at its samples that is
        tight wherever it is below ``bounds [B]`` (NaN: the lane is left
        as it is): each of the lane's (pair, sample) values below its
        bound and not exact yet gets the local direction search
        (:func:`local_gaps`, on the certificates' device); where that
        leaves it below the bound, the exact solver, lowest first, at most
        :data:`EXACT_CAP` a lane.  Returns (the bounds [B], local searches,
        exact solves, values left below a bound beyond the cap); ``lane_min``
        keeps the certificates' value."""
        per_config = np.repeat(np.asarray(bounds, float), self.samples)

        def below():
            return np.nonzero((self.pair_min < per_config[None])
                              & ~self.solved)

        pis, nis = below()
        for pi in np.unique(pis):
            idx = nis[pis == pi]
            Wa, Wb, r = self.pair_world(pi, idx)
            self.pair_min[pi, idx] = np.maximum(
                self.pair_min[pi, idx], local_gaps(Wa, Wb, self.device) - r)
        n_local = len(pis)
        pis, nis = below()
        lane = nis // self.samples
        order = np.lexsort((self.pair_min[pis, nis], lane))
        n_exact = left = 0
        for ln in np.unique(lane):
            sel = order[lane[order] == ln]
            for k in sel[:EXACT_CAP]:
                Wa, Wb, r = self.pair_world(pis[k], [nis[k]])
                self.pair_min[pis[k], nis[k]] = \
                    exact_signed_distance(Wa[0], Wb[0]) - r
                self.solved[pis[k], nis[k]] = True
            n_exact += min(EXACT_CAP, len(sel))
            left += max(0, len(sel) - EXACT_CAP)
        lows = self.pair_min.min(0).reshape(len(self.lane_min), -1).min(1)
        return lows, n_local, n_exact, left


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _numpy(x) -> np.ndarray:
    """A float64 numpy copy of a tensor (any device) or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().cpu().numpy()
    return np.array(x, dtype=float)


def _certificates(tree, pairs, forms, R, p, offsets, dev) -> np.ndarray:
    """[P, N] float64 certificates of ``pairs`` at link poses ``R [N, L, 3,
    3]``, ``p [N, L, 3]`` (numpy): for each pair the largest support gap
    over :func:`direction_set` less both radii, computed on ``dev`` in
    chunks of configurations.  ``offsets[id(g)]`` is None or the ``[N,
    3]`` translation of a static geom's vertices."""
    N = R.shape[0]
    kw = dict(dtype=torch.float64, device=dev)
    dirs = torch.as_tensor(direction_set(), **kw)             # [K, 3]
    K = dirs.shape[0]
    geoms = list({id(g): g for pair in pairs for g in pair}.values())
    links = sorted({tree.link_id(g.link) for g in geoms if g.link})
    slot = {lid: k for k, lid in enumerate(links)}
    vmax = max(forms[id(g)][0].shape[0] for g in geoms)
    # float64 numbers a configuration holds at once: the spans of every
    # geom, one geom's projections and world vertices, the link poses
    per_config = 8 * (2 * K * len(geoms) + vmax * (K + 3) + 12 * len(links)
                      + len(pairs))
    chunk = max(1, CHUNK_BYTES // per_config)
    cert = torch.empty((len(pairs), N), **kw)
    for s in range(0, N, chunk):
        e = min(N, s + chunk)
        Rc = torch.as_tensor(R[s:e][:, links], **kw)
        pc = torch.as_tensor(p[s:e][:, links], **kw)
        span = {}                                 # id(g) -> (lo, hi) [n, K]
        for g in geoms:
            vt = torch.as_tensor(forms[id(g)][0], **kw)
            if g.link is None:
                proj = (vt @ dirs.T)[None]                    # [1, V, K]
                if offsets.get(id(g)) is not None:
                    proj = proj + (torch.as_tensor(offsets[id(g)][s:e], **kw)
                                   @ dirs.T)[:, None, :]
            else:
                li = slot[tree.link_id(g.link)]
                W = torch.einsum("nij,vj->nvi", Rc[:, li], vt) \
                    + pc[:, li, None, :]
                proj = torch.einsum("nvi,ki->nvk", W, dirs)   # [n, V, K]
            span[id(g)] = (proj.amin(1), proj.amax(1))
        for pi, (ga, gb) in enumerate(pairs):
            lo_a, hi_a = span[id(ga)]
            lo_b, hi_b = span[id(gb)]
            gap = torch.maximum(lo_b - hi_a, lo_a - hi_b) \
                - (forms[id(ga)][1] + forms[id(gb)][1])
            cert[pi, s:e] = gap.amax(-1)
    return cert.cpu().numpy()


def pair_certificates(scene, Q, device=None) -> np.ndarray:
    """[N, P] certificates of every pair of ``scene.pairs()`` at
    configurations ``Q [N, n_dof]``, before any escalation: a lower bound
    of each pair's distance, <= 0 where no direction separates the pair
    (no ``center_param`` geoms)."""
    pairs = scene.pairs()
    forms = {id(g): vertex_form(g) for pair in pairs for g in pair}
    R, p = numpy_fk(scene.tree, np.asarray(Q, float))
    return _certificates(scene.tree, pairs, forms, R, p, {},
                         resolve_device(device)).T


def certify(scene, traj, params: dict | None = None, device=None,
            log=_log) -> Verdict:
    """Certify lanes ``traj [B, T, n_dof]`` (any device and dtype) of
    ``scene`` at every sample of every gap (see the module doc).
    ``params`` holds the centres of ``center_param`` world geoms
    (``[3]`` or one a lane, ``[B, 3]``), as the scene reads them.  The
    certificates run on ``device`` (None: the card, raising when there is
    none); FK and the exact solves on the host."""
    dev = resolve_device(device)
    tree = scene.tree
    traj = _numpy(traj)
    B = traj.shape[0]
    Q, n_sub = sample_configs(traj)
    N = Q.shape[0]
    per_lane = N // B
    log(f"# {B} lanes x {traj.shape[1] - 1} gaps x {n_sub + 1} samples = "
        f"{N} configs")
    t0 = time.time()
    R, p = numpy_fk(tree, Q)
    log(f"# numpy FK: {time.time() - t0:.1f}s")

    pairs = scene.pairs()
    forms = {id(g): vertex_form(g) for pair in pairs for g in pair}
    lane_of = np.repeat(np.arange(B), per_lane)
    offsets = {}
    for g in (g for pair in pairs for g in pair):
        if g.link is None and g.p_param is not None:
            c = _numpy(params[g.p_param])
            offsets[id(g)] = np.broadcast_to(c.reshape(-1, 3), (B, 3))[
                lane_of] - np.asarray(g.p_local, float)

    def world(g, idx):
        """World vertices [len(idx), V, 3] of ``g`` at configs ``idx``."""
        v = forms[id(g)][0]
        if g.link is None:
            w = np.repeat(v[None], len(idx), 0)
            off = offsets.get(id(g))
            return w if off is None else w + off[idx][:, None, :]
        lid = tree.link_id(g.link)
        return np.einsum("nij,vj->nvi", R[idx, lid], v) + p[idx, lid][:, None]

    def pair_world(pi, idx):
        ga, gb = pairs[pi]
        return world(ga, idx), world(gb, idx), \
            forms[id(ga)][1] + forms[id(gb)][1]

    t0 = time.time()
    pair_min = _certificates(tree, pairs, forms, R, p, offsets, dev)
    solved = np.zeros(pair_min.shape, bool)
    t_cert = time.time() - t0

    # escalate the UNcertified configurations (certificate <= 0)
    t0 = time.time()
    n_escal, max_pen, left, exact = 0, 0.0, 0, []
    for pi, (ga, gb) in enumerate(pairs):
        bad = np.nonzero(pair_min[pi] <= 0.0)[0]
        if not len(bad):
            continue
        take = bad[:EXACT_CAP]
        Wa, Wb, radius = pair_world(pi, take)
        for k, ni in enumerate(take):
            d = exact_signed_distance(Wa[k], Wb[k]) - radius
            pair_min[pi, ni] = d
            solved[pi, ni] = True
            exact.append((int(ni // per_lane), (ga.name, gb.name), d))
            max_pen = max(max_pen, -d)
        n_escal += len(take)
        if len(bad) > EXACT_CAP:
            left += len(bad) - EXACT_CAP
            log(f"# pair {pi} ({ga.name},{gb.name}): {len(bad)} uncertified "
                f"configs, escalated first {EXACT_CAP}, "
                f"{len(bad) - EXACT_CAP} left")
    log(f"# certificates: {t_cert:.1f}s on {dev}, {n_escal} exact "
        f"escalations in {time.time() - t0:.1f}s"
        + (f", max exact penetration {max_pen:.5f}" if max_pen > 0 else ""))
    lane_min = pair_min.min(axis=0).reshape(B, -1).min(axis=1)
    return Verdict(lane_min=lane_min, escalations=n_escal,
                   max_exact_penetration=max_pen, left_uncertified=left,
                   exact=exact, samples=per_lane, pair_min=pair_min,
                   solved=solved, pair_world=pair_world, device=dev)


def main(argv=None) -> int:
    """Solve ``n_lanes`` flagship lanes (30 % on borderline goals) on the
    card, certify the converged ones and hold the solver's swept check
    against them."""
    from trajopt_tpu_torch.models.benchmarks import (flagship_params,
                                                     pr2ish_table_batch,
                                                     pr2ish_table_problem,
                                                     swept_verify)
    from trajopt_tpu_torch.sqp.params import SQPStatus

    argv = sys.argv[1:] if argv is None else argv
    n_lanes = int(argv[0]) if argv else 100
    n_steps = 30
    prob, scene = pr2ish_table_problem(
        n_steps=n_steps, lvs_substeps=int(os.environ.get("BENCH_LVS", "2")))
    tree = scene.tree
    solve = prob.make_solve(flagship_params(), structured=True)
    inits, goals = pr2ish_table_batch(11, n_lanes, n_steps, hard_frac=0.3)
    t0 = time.time()
    res = solve(inits, {"goal": goals})
    status = res.status.cpu().numpy()
    _log(f"# solved {int((status == SQPStatus.CONVERGED).sum())}/{n_lanes} "
         f"lanes in {time.time() - t0:.1f}s (incl. capture)")
    conv = np.nonzero(status == SQPStatus.CONVERGED)[0]
    traj = res.x.reshape(n_lanes, n_steps, tree.n_dof)[conv]
    verdict = certify(scene, traj, device=inits.device)
    lane_min = verdict.lane_min
    B = len(lane_min)
    _log(f"# EXTERNAL verdict: {int((lane_min > 0).sum())}/{B} converged "
         f"lanes collision-free at every sampled config; worst lane "
         f"clearance {lane_min.min():+.5f}")
    out = verdict.agreement(swept_verify(scene, traj))
    _log(f"# agreement: {out['agree']}/{B} lanes same free/colliding "
         f"verdict; repo_swept - external_min in [{out['diff_min']:+.5f}, "
         f"{out['diff_max']:+.5f}] (positive max would mean the repo "
         f"verifier OVER-estimates clearance beyond sampling slack)")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
