"""SRDF-subset parser: kinematic groups, group states, and the
allowed-collision matrix (``<disable_collisions>``).

The port's own copy of ``trajopt_tpu/kinematics/srdf.py`` (numpy only, on the
port's ``kinematics/urdf.py``).  Covered subset:

- ``<group>`` with ``<chain base_link tip_link>``, ``<joint>``, ``<link>``
  and ``<group>`` (subgroup) members, resolved to an ordered active-joint
  list for :func:`trajopt_tpu_torch.kinematics.chain.build_tree`.
- ``<group_state>`` named joint-value snapshots.
- ``<disable_collisions link1 link2>`` -> link-level allowed-collision
  pairs consumed by
  :class:`trajopt_tpu_torch.collision.world.CollisionScene`.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np

from . import urdf as urdf_mod


@dataclasses.dataclass(frozen=True)
class SrdfGroup:
    name: str
    joints: tuple[str, ...] = ()
    links: tuple[str, ...] = ()
    chains: tuple[tuple[str, str], ...] = ()   # (base_link, tip_link)
    subgroups: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class SrdfModel:
    name: str
    groups: tuple[SrdfGroup, ...] = ()
    # group_state name -> (group name, {joint: value})
    group_states: dict = dataclasses.field(default_factory=dict)
    # frozenset({link1, link2}) -> reason string
    disabled_collisions: dict = dataclasses.field(default_factory=dict)

    def group(self, name: str) -> SrdfGroup:
        for g in self.groups:
            if g.name == name:
                return g
        raise KeyError(f"SRDF group '{name}' not found "
                       f"(have {[g.name for g in self.groups]})")

    def disabled_link_pairs(self) -> set[frozenset]:
        return set(self.disabled_collisions)


def parse_srdf(text: str) -> SrdfModel:
    root = ET.fromstring(text)
    if root.tag != "robot":
        raise ValueError(f"SRDF root element must be <robot>, got <{root.tag}>")

    groups = []
    for g in root.findall("group"):
        groups.append(SrdfGroup(
            name=g.get("name", ""),
            joints=tuple(j.get("name") for j in g.findall("joint")),
            links=tuple(l.get("name") for l in g.findall("link")),
            chains=tuple((c.get("base_link"), c.get("tip_link"))
                         for c in g.findall("chain")),
            subgroups=tuple(s.get("name") for s in g.findall("group")),
        ))

    group_states = {}
    for gs in root.findall("group_state"):
        vals = {j.get("name"): float(j.get("value", "0"))
                for j in gs.findall("joint")}
        group_states[gs.get("name")] = (gs.get("group"), vals)

    disabled = {}
    for dc in root.findall("disable_collisions"):
        l1, l2 = dc.get("link1"), dc.get("link2")
        if l1 is None or l2 is None:
            raise ValueError("<disable_collisions> requires link1 and link2")
        disabled[frozenset((l1, l2))] = dc.get("reason", "")

    return SrdfModel(name=root.get("name", ""), groups=tuple(groups),
                     group_states=group_states,
                     disabled_collisions=disabled)


def load_srdf(path: str) -> SrdfModel:
    with open(path) as f:
        return parse_srdf(f.read())


def _chain_joints(model: urdf_mod.UrdfModel, base_link: str,
                  tip_link: str) -> list[str]:
    """Non-fixed joint names along the unique base->tip path, in base->tip
    order (tesseract KinematicGroup chain semantics)."""
    parent_of = {j.child: j for j in model.joints}
    path: list[urdf_mod.UrdfJoint] = []
    cur = tip_link
    while cur != base_link:
        j = parent_of.get(cur)
        if j is None:
            raise ValueError(
                f"no chain from '{base_link}' to '{tip_link}': reached root "
                f"at '{cur}'")
        path.append(j)
        cur = j.parent
    return [j.name for j in reversed(path) if j.jtype != urdf_mod.FIXED]


def resolve_group_joints(model: urdf_mod.UrdfModel, srdf: SrdfModel,
                         group_name: str) -> list[str]:
    """Ordered active-joint list for an SRDF group: chains first (base->tip),
    then explicit joints, then joints moving explicit links, then subgroups;
    duplicates deduped keeping first occurrence."""
    g = srdf.group(group_name)
    joints: list[str] = []

    def add(names):
        for n in names:
            if n not in joints:
                joints.append(n)

    for base, tip in g.chains:
        add(_chain_joints(model, base, tip))
    non_fixed = {j.name for j in model.joints if j.jtype != urdf_mod.FIXED}
    add(n for n in g.joints if n in non_fixed)
    for link in g.links:
        for j in model.joints:
            if j.child == link and j.jtype != urdf_mod.FIXED:
                add([j.name])
    for sub in g.subgroups:
        add(resolve_group_joints(model, srdf, sub))
    if not joints:
        raise ValueError(f"SRDF group '{group_name}' resolves to no active "
                         "joints")
    return joints


def group_state_vector(model: urdf_mod.UrdfModel, srdf: SrdfModel,
                       state_name: str) -> np.ndarray:
    """Joint values of a <group_state>, ordered like the group's resolved
    active joints (missing joints default to 0)."""
    group_name, vals = srdf.group_states[state_name]
    names = resolve_group_joints(model, srdf, group_name)
    return np.array([vals.get(n, 0.0) for n in names])
