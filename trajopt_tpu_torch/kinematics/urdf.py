"""URDF-subset parser: links, joints (revolute/continuous/prismatic/fixed),
origins, axes, limits, and collision geometry primitives.

The port's own copy of ``trajopt_tpu/kinematics/urdf.py`` (numpy only):
the port imports nothing of the JAX package, whose ``__init__`` loads the
whole JAX stack.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

REVOLUTE = 0
PRISMATIC = 1
FIXED = 2


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One collision geometry attached to a link."""
    kind: str                 # 'box' | 'sphere' | 'cylinder' | 'mesh'
    size: tuple[float, ...]   # box: (x,y,z); sphere: (r,); cylinder: (r, l);
    #                           mesh: (sx, sy, sz) scale factors
    origin_xyz: tuple[float, float, float] = (0.0, 0.0, 0.0)
    origin_rpy: tuple[float, float, float] = (0.0, 0.0, 0.0)
    filename: Optional[str] = None   # mesh resource (possibly package://)


@dataclasses.dataclass(frozen=True)
class UrdfJoint:
    name: str
    jtype: int                # REVOLUTE | PRISMATIC | FIXED
    parent: str
    child: str
    origin_xyz: tuple[float, float, float]
    origin_rpy: tuple[float, float, float]
    axis: tuple[float, float, float]
    lower: float = -np.inf
    upper: float = np.inf


@dataclasses.dataclass(frozen=True)
class UrdfLink:
    name: str
    collisions: tuple[Geometry, ...] = ()


@dataclasses.dataclass(frozen=True)
class UrdfModel:
    name: str
    links: tuple[UrdfLink, ...]
    joints: tuple[UrdfJoint, ...]

    def link(self, name: str) -> UrdfLink:
        for l in self.links:
            if l.name == name:
                return l
        raise KeyError(name)


def _parse_vec(s: Optional[str], default=(0.0, 0.0, 0.0)):
    if s is None:
        return tuple(float(v) for v in default)
    return tuple(float(v) for v in s.split())


def _parse_geometry(collision_el) -> Optional[Geometry]:
    geo = collision_el.find("geometry")
    if geo is None:
        return None
    origin = collision_el.find("origin")
    xyz = _parse_vec(origin.get("xyz") if origin is not None else None)
    rpy = _parse_vec(origin.get("rpy") if origin is not None else None)
    box = geo.find("box")
    if box is not None:
        return Geometry("box", _parse_vec(box.get("size")), xyz, rpy)
    sph = geo.find("sphere")
    if sph is not None:
        return Geometry("sphere", (float(sph.get("radius")),), xyz, rpy)
    cyl = geo.find("cylinder")
    if cyl is not None:
        return Geometry("cylinder",
                        (float(cyl.get("radius")), float(cyl.get("length"))),
                        xyz, rpy)
    mesh = geo.find("mesh")
    if mesh is not None:
        scale = _parse_vec(mesh.get("scale"), default=(1.0, 1.0, 1.0))
        return Geometry("mesh", scale, xyz, rpy,
                        filename=mesh.get("filename"))
    return None


def _declare_missing_prefixes(text: str) -> str:
    """Inject xmlns declarations for undeclared namespace prefixes.

    Real-world URDFs (e.g. the reference's pr2.urdf) carry vendor
    attributes like ``tesseract:make_convex`` without declaring the prefix;
    strict ElementTree refuses them ("unbound prefix")."""
    import re
    declared = set(re.findall(r"xmlns:([\w.-]+)\s*=", text))
    used = set(re.findall(r"[\s<]([A-Za-z_][\w.-]*):[A-Za-z_]", text))
    missing = used - declared - {"xmlns", "xml", "http", "https"}
    if not missing:
        return text
    decls = " ".join(f'xmlns:{p}="urn:uri:{p}"' for p in sorted(missing))
    return re.sub(r"<robot(\s)", f"<robot {decls}\\1", text, count=1)


def parse_urdf(text: str) -> UrdfModel:
    try:
        root = ET.fromstring(text)
    except ET.ParseError:
        root = ET.fromstring(_declare_missing_prefixes(text))
    if root.tag != "robot":
        raise ValueError("not a URDF document")

    links = []
    for el in root.findall("link"):
        cols = tuple(g for g in (
            _parse_geometry(c) for c in el.findall("collision")) if g)
        links.append(UrdfLink(name=el.get("name"), collisions=cols))

    joints = []
    for el in root.findall("joint"):
        jt = el.get("type")
        if jt in ("revolute", "continuous"):
            jtype = REVOLUTE
        elif jt == "prismatic":
            jtype = PRISMATIC
        elif jt in ("fixed", "floating", "planar"):
            jtype = FIXED  # floating/planar unsupported as active joints
        else:
            raise ValueError(f"unsupported joint type {jt}")
        origin = el.find("origin")
        axis_el = el.find("axis")
        limit = el.find("limit")
        lower, upper = -np.inf, np.inf
        if jt == "revolute" or jt == "prismatic":
            if limit is not None:
                lower = float(limit.get("lower", -np.inf))
                upper = float(limit.get("upper", np.inf))
        joints.append(UrdfJoint(
            name=el.get("name"),
            jtype=jtype,
            parent=el.find("parent").get("link"),
            child=el.find("child").get("link"),
            origin_xyz=_parse_vec(origin.get("xyz") if origin is not None else None),
            origin_rpy=_parse_vec(origin.get("rpy") if origin is not None else None),
            axis=_parse_vec(axis_el.get("xyz") if axis_el is not None else None,
                            default=(1.0, 0.0, 0.0)),
            lower=lower,
            upper=upper,
        ))
    return UrdfModel(name=root.get("name", "robot"),
                     links=tuple(links), joints=tuple(joints))


def load_urdf(path: str) -> UrdfModel:
    with open(path) as f:
        return parse_urdf(f.read())
