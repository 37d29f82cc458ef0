"""Kinematic tree: batched forward kinematics and geometric Jacobian.

Counterpart of ``trajopt_tpu/kinematics/chain.py``.  FK is the scalar form
(``_fk_soa`` there): every rotation is carried as 9 tensors and every point
as 3, each of the configuration batch's shape, and exact structural zeros
(``None``) fold away while the Python loop over joints runs.  Any leading
batch shape is accepted: ``q [..., n_dof] -> R [..., L, 3, 3], p [..., L, 3]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from trajopt_tpu_torch.kinematics import urdf as urdf_mod
from trajopt_tpu_torch.utils import on_device


def _np_rpy_matrix(rpy) -> np.ndarray:
    """Pure-numpy URDF fixed-axis RPY (R = Rz @ Ry @ Rx), entries within
    1e-15 of {0, +-1} snapped exactly so structural zeros fold."""
    r, p, y = float(rpy[0]), float(rpy[1]), float(rpy[2])
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    R = np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])
    return np.where(np.abs(R) < 1e-15, 0.0,
                    np.where(np.abs(R - 1.0) < 1e-15, 1.0,
                             np.where(np.abs(R + 1.0) < 1e-15, -1.0, R)))


@dataclasses.dataclass(frozen=True)
class KinematicTree:
    """Static description of a tree; tensor work happens in fk().

    Attributes:
      link_names: all link names, index = link id; root is index 0.
      joints: topo-ordered UrdfJoint tuple.
      parent_link / child_link: per joint, parent/child link id.
      q_index: per joint, index into q (or -1 for fixed).
      active_joint_names / lower / upper: active-joint metadata.
      ancestor: [n_links, n_active] bool — active joint j moves link l.
    """

    link_names: tuple[str, ...]
    joints: tuple[urdf_mod.UrdfJoint, ...]
    parent_link: tuple[int, ...]
    child_link: tuple[int, ...]
    q_index: tuple[int, ...]
    active_joint_names: tuple[str, ...]
    lower: np.ndarray
    upper: np.ndarray
    ancestor: np.ndarray

    @property
    def n_dof(self) -> int:
        return len(self.active_joint_names)

    @property
    def n_links(self) -> int:
        return len(self.link_names)

    def link_id(self, name: str) -> int:
        return self.link_names.index(name)

    def fk(self, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """World poses of all links: q [..., n_dof] -> (R [..., L, 3, 3],
        p [..., L, 3])."""
        R, p, _, _ = self._fk_soa(q, with_axes=False)
        return R, p

    def _fk_soa(self, q: torch.Tensor, with_axes: bool):
        """Scalar-form unrolled FK (and optional joint axes/origins).
        Returns (R [..., L, 3, 3], p [..., L, 3], z [..., n_dof, 3] | None,
        o [..., n_dof, 3] | None)."""
        zero = torch.zeros_like(q[..., 0])
        one = torch.ones_like(q[..., 0])

        # None represents an exact structural zero.
        def cmul(c, a):
            c = float(c)
            if c == 0.0 or a is None:
                return None
            if c == 1.0:
                return a
            if c == -1.0:
                return -a
            return c * a

        def amul(a, b):
            return None if (a is None or b is None) else a * b

        def acc(*terms):
            out = None
            for t in terms:
                if t is None:
                    continue
                out = t if out is None else out + t
            return out

        def z_of(a):
            return zero if a is None else a

        def mat_const(A, C):
            return [[acc(*(cmul(C[k][j], A[i][k]) for k in range(3)))
                     for j in range(3)] for i in range(3)]

        def vec_const(A, v):
            return [acc(*(cmul(v[k], A[i][k]) for k in range(3)))
                    for i in range(3)]

        def matmat(A, B):
            return [[acc(*(amul(A[i][k], B[k][j]) for k in range(3)))
                     for j in range(3)] for i in range(3)]

        Rs: list = [None] * self.n_links
        ps: list = [None] * self.n_links
        Rs[0] = [[one, None, None], [None, one, None], [None, None, one]]
        ps[0] = [None, None, None]
        z_ax: list = [None] * self.n_dof
        o_ax: list = [None] * self.n_dof

        for k, j in enumerate(self.joints):
            Rp = Rs[self.parent_link[k]]
            pp = ps[self.parent_link[k]]
            R_or = _np_rpy_matrix(j.origin_rpy)
            p_or = np.asarray(j.origin_xyz, float)
            Rj = mat_const(Rp, R_or)
            pv = vec_const(Rp, p_or)
            pj = [acc(pv[i], pp[i]) for i in range(3)]
            qi = self.q_index[k]
            if qi >= 0 and j.jtype == urdf_mod.REVOLUTE:
                x, y, z = (float(v) for v in j.axis)
                th = q[..., qi]
                c = torch.cos(th)
                s = torch.sin(th)
                C = 1.0 - c
                Raa = [[acc(c, cmul(x * x, C)),
                        acc(cmul(x * y, C), cmul(-z, s)),
                        acc(cmul(x * z, C), cmul(y, s))],
                       [acc(cmul(y * x, C), cmul(z, s)),
                        acc(c, cmul(y * y, C)),
                        acc(cmul(y * z, C), cmul(-x, s))],
                       [acc(cmul(z * x, C), cmul(-y, s)),
                        acc(cmul(z * y, C), cmul(x, s)),
                        acc(c, cmul(z * z, C))]]
                Rj = matmat(Rj, Raa)
            elif qi >= 0 and j.jtype == urdf_mod.PRISMATIC:
                d = vec_const(Rj, np.asarray(j.axis, float))
                th = q[..., qi]
                pj = [acc(pj[i], amul(d[i], th)) for i in range(3)]
            Rs[self.child_link[k]] = Rj
            ps[self.child_link[k]] = pj
            if with_axes and qi >= 0:
                z_ax[qi] = vec_const(Rj, np.asarray(j.axis, float))
                o_ax[qi] = pj

        def pack_mats(mats):
            return torch.stack([torch.stack([torch.stack(
                [z_of(e) for e in row], -1) for row in M], -2)
                for M in mats], -3)

        def pack_vecs(vecs):
            if not vecs:  # n_dof == 0 degenerate tree
                return q.new_zeros(q.shape[:-1] + (0, 3))
            return torch.stack([torch.stack([z_of(e) for e in v], -1)
                                for v in vecs], -2)

        R = pack_mats(Rs)
        p = pack_vecs(ps)
        if not with_axes:
            return R, p, None, None
        return R, p, pack_vecs(z_ax), pack_vecs(o_ax)

    def fk_with_axes(self, q: torch.Tensor):
        """FK plus per-active-joint world axis z_i and origin o_i:
        (R, p, z [..., n_dof, 3], o [..., n_dof, 3])."""
        return self._fk_soa(q, with_axes=True)

    def jacobian(self, q: torch.Tensor, link: int | str,
                 ref_point: torch.Tensor | None = None) -> torch.Tensor:
        """Geometric Jacobian [..., 6, n_dof] ([linear; angular]) of a link
        (or a world point ``ref_point`` attached to that link)."""
        if isinstance(link, str):
            link = self.link_id(link)
        R, p, z, o = self.fk_with_axes(q)
        target = p[..., link, :] if ref_point is None else ref_point
        mask = on_device(self, "ancestor", lambda: self.ancestor, q.device,
                         q.dtype)[link]
        is_rev = self.revolute(q.device)
        lin_rev = torch.linalg.cross(z, target[..., None, :] - o, dim=-1)
        lin = torch.where(is_rev[:, None], lin_rev, z) * mask[:, None]
        ang = torch.where(is_rev[:, None], z, torch.zeros_like(z)) \
            * mask[:, None]
        return torch.cat([lin.transpose(-1, -2), ang.transpose(-1, -2)], -2)

    def revolute(self, device) -> torch.Tensor:
        """[n_dof] bool on ``device``: is each active joint revolute."""
        return on_device(self, "revolute", lambda: self._active_types() == 0,
                         device)

    def _active_types(self) -> np.ndarray:
        out = np.zeros(self.n_dof, np.int32)
        for k, j in enumerate(self.joints):
            qi = self.q_index[k]
            if qi >= 0:
                out[qi] = 0 if j.jtype == urdf_mod.REVOLUTE else 1
        return out


def ancestor_matrix(n_links, parent_link, child_link, q_index,
                    n_active) -> np.ndarray:
    """ancestor[l, qi]: does active joint qi move link l?"""
    ancestor = np.zeros((n_links, n_active), bool)
    parent_of_link = {child_link[k]: (parent_link[k], k)
                      for k in range(len(child_link))}
    for l in range(n_links):
        cur = l
        while cur in parent_of_link:
            p, k = parent_of_link[cur]
            if q_index[k] >= 0:
                ancestor[l, q_index[k]] = True
            cur = p
    return ancestor


def build_tree(model: urdf_mod.UrdfModel,
               active_joints: list[str] | None = None) -> KinematicTree:
    """Topologically sort the URDF joint graph into a KinematicTree.

    ``active_joints`` selects/orders the actuated joints; default = all
    non-fixed joints in URDF document order."""
    children = {j.parent: [] for j in model.joints}
    for j in model.joints:
        children.setdefault(j.parent, []).append(j)
    child_names = {j.child for j in model.joints}
    roots = [l.name for l in model.links if l.name not in child_names]
    if len(roots) != 1:
        raise ValueError(f"expected single root link, got {roots}")

    link_names = [roots[0]]
    ordered: list[urdf_mod.UrdfJoint] = []
    stack = [roots[0]]
    while stack:
        link = stack.pop()
        for j in children.get(link, []):
            ordered.append(j)
            link_names.append(j.child)
            stack.append(j.child)

    name_to_id = {n: i for i, n in enumerate(link_names)}
    parent_link = tuple(name_to_id[j.parent] for j in ordered)
    child_link = tuple(name_to_id[j.child] for j in ordered)

    if active_joints is None:
        active_joints = [j.name for j in model.joints
                         if j.jtype != urdf_mod.FIXED]
    q_of = {n: i for i, n in enumerate(active_joints)}
    q_index = tuple(
        q_of.get(j.name, -1) if j.jtype != urdf_mod.FIXED else -1
        for j in ordered)

    lower = np.array([next(j.lower for j in ordered if j.name == n)
                      for n in active_joints])
    upper = np.array([next(j.upper for j in ordered if j.name == n)
                      for n in active_joints])
    ancestor = ancestor_matrix(len(link_names), parent_link, child_link,
                               q_index, len(active_joints))
    return KinematicTree(
        link_names=tuple(link_names),
        joints=tuple(ordered),
        parent_link=parent_link,
        child_link=child_link,
        q_index=q_index,
        active_joint_names=tuple(active_joints),
        lower=lower,
        upper=upper,
        ancestor=ancestor,
    )
