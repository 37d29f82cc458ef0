"""A URDF's kinematic tree and its forward kinematics in numpy.

Joints of type revolute, continuous, prismatic and fixed; the active
joints, in document order, are the configuration's degrees of freedom.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np

from port_bench.reference import arith


def _floats(text, n=3, default=0.0):
    if text is None:
        return np.full(n, default)
    return np.array([float(v) for v in text.split()])


def rpy_matrix(rpy) -> np.ndarray:
    """URDF fixed-axis roll, pitch, yaw: Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                              np.cos(y), np.sin(y))
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


@dataclasses.dataclass
class Joint:
    name: str
    kind: str
    parent: str
    child: str
    R0: np.ndarray          # origin rotation in the parent frame
    p0: np.ndarray          # origin translation in the parent frame
    axis: np.ndarray
    lower: float
    upper: float


class Robot:
    """Links, joints and joint limits of one URDF file."""

    def __init__(self, path: str):
        root = ET.parse(path).getroot()
        self.links = [e.get("name") for e in root.findall("link")]
        self.joints = []
        for e in root.findall("joint"):
            org = e.find("origin")
            ax = e.find("axis")
            lim = e.find("limit")
            axis = _floats(None if ax is None else ax.get("xyz"))
            if ax is None:
                axis = np.array([1.0, 0.0, 0.0])
            self.joints.append(Joint(
                name=e.get("name"), kind=e.get("type"),
                parent=e.find("parent").get("link"),
                child=e.find("child").get("link"),
                R0=rpy_matrix(_floats(None if org is None
                                      else org.get("rpy"))),
                p0=_floats(None if org is None else org.get("xyz")),
                axis=axis / np.linalg.norm(axis),
                lower=float(lim.get("lower", "-inf")) if lim is not None
                else -np.inf,
                upper=float(lim.get("upper", "inf")) if lim is not None
                else np.inf))
        self.active = [j for j in self.joints if j.kind != "fixed"]
        self.lower = np.array([j.lower for j in self.active])
        self.upper = np.array([j.upper for j in self.active])
        children = {j.child for j in self.joints}
        roots = [name for name in self.links if name not in children]
        if len(roots) != 1:
            raise ValueError(f"{path}: expected one root link, got {roots}")
        self.root = roots[0]
        # joints in an order where each parent pose is known first
        by_parent = {}
        for j in self.joints:
            by_parent.setdefault(j.parent, []).append(j)
        self.order, todo = [], [self.root]
        while todo:
            link = todo.pop(0)
            for j in by_parent.get(link, []):
                self.order.append(j)
                todo.append(j.child)

    @property
    def n_dof(self) -> int:
        return len(self.active)

    def fk(self, q: np.ndarray, rnd=arith.exact) -> dict:
        """World poses {link: (R [..., 3, 3], p [..., 3])} at ``q [...,
        n_dof]``, with every product's operands through ``rnd``."""
        q = np.asarray(q, np.float64)
        lead = q.shape[:-1]
        col = {j.name: k for k, j in enumerate(self.active)}
        eye = np.broadcast_to(np.eye(3), lead + (3, 3))
        poses = {self.root: (eye, np.zeros(lead + (3,)))}
        for j in self.order:
            Rp, pp = poses[j.parent]
            R = arith.matmul(rnd, Rp, np.broadcast_to(j.R0, lead + (3, 3)))
            p = pp + arith.matvec(rnd, Rp, np.broadcast_to(j.p0, lead + (3,)))
            if j.kind in ("revolute", "continuous"):
                R = arith.matmul(rnd, R, axis_rotation(j.axis, q[..., col[j.name]],
                                                       rnd))
            elif j.kind == "prismatic":
                t = arith.mul(rnd, q[..., col[j.name], None], j.axis)
                p = p + arith.matvec(rnd, R, t)
            elif j.kind != "fixed":
                raise ValueError(f"joint {j.name}: type {j.kind} is not "
                                 f"supported")
            poses[j.child] = (R, p)
        return poses


def axis_rotation(axis: np.ndarray, theta: np.ndarray, rnd) -> np.ndarray:
    """Rodrigues' rotation by ``theta [...]`` about the unit ``axis``."""
    K = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                  [-axis[1], axis[0], 0.0]])
    K2 = K @ K
    s = np.sin(theta)[..., None, None]
    c = 1.0 - np.cos(theta)[..., None, None]
    return np.eye(3) + arith.mul(rnd, s, K) + arith.mul(rnd, c, K2)
