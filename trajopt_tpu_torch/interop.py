"""Carry a problem's state across from the JAX package as plain numpy.

A kinematic tree and a collision scene travel as dicts of numpy arrays
(ragged per-geom data -- hulls, SDF grids -- as lists with None gaps)
(``tree_to_numpy`` / ``scene_to_numpy`` read any object with the JAX
package's attribute layout, without importing it); ``tree_from_numpy`` /
``scene_from_numpy`` build the port's objects from them, keeping the
source scene's candidate-pair list verbatim.  ``sqp_params_from_dict``
builds ``SQPParams`` from ``dataclasses.asdict`` of the JAX parameters.
"""

from __future__ import annotations

import numpy as np

from trajopt_tpu_torch.collision.sdf_grid import SdfGrid
from trajopt_tpu_torch.collision.world import CollGeom, CollisionScene
from trajopt_tpu_torch.kinematics.chain import KinematicTree, ancestor_matrix
from trajopt_tpu_torch.kinematics.urdf import UrdfJoint
from trajopt_tpu_torch.qp.admm import ADMMConfig
from trajopt_tpu_torch.sqp.params import SQPParams


def tree_to_numpy(tree) -> dict:
    """Joint axes, origins, limits and topology of a kinematic tree."""
    js = tree.joints
    return {
        "link_names": np.asarray(tree.link_names),
        "joint_names": np.asarray([j.name for j in js]),
        "joint_types": np.asarray([j.jtype for j in js], np.int64),
        "parent_link": np.asarray(tree.parent_link, np.int64),
        "child_link": np.asarray(tree.child_link, np.int64),
        "q_index": np.asarray(tree.q_index, np.int64),
        "axis": np.asarray([j.axis for j in js], float).reshape(-1, 3),
        "origin_xyz": np.asarray([j.origin_xyz for j in js],
                                 float).reshape(-1, 3),
        "origin_rpy": np.asarray([j.origin_rpy for j in js],
                                 float).reshape(-1, 3),
        "joint_lower": np.asarray([j.lower for j in js], float),
        "joint_upper": np.asarray([j.upper for j in js], float),
        "active_joint_names": np.asarray(tree.active_joint_names),
        "lower": np.asarray(tree.lower, float),
        "upper": np.asarray(tree.upper, float),
    }


def tree_from_numpy(d: dict) -> KinematicTree:
    link_names = tuple(str(s) for s in d["link_names"])
    joints = tuple(
        UrdfJoint(name=str(d["joint_names"][k]),
                  jtype=int(d["joint_types"][k]),
                  parent=link_names[int(d["parent_link"][k])],
                  child=link_names[int(d["child_link"][k])],
                  origin_xyz=tuple(float(v) for v in d["origin_xyz"][k]),
                  origin_rpy=tuple(float(v) for v in d["origin_rpy"][k]),
                  axis=tuple(float(v) for v in d["axis"][k]),
                  lower=float(d["joint_lower"][k]),
                  upper=float(d["joint_upper"][k]))
        for k in range(len(d["joint_names"])))
    parent = tuple(int(v) for v in d["parent_link"])
    child = tuple(int(v) for v in d["child_link"])
    q_index = tuple(int(v) for v in d["q_index"])
    active = tuple(str(s) for s in d["active_joint_names"])
    return KinematicTree(
        link_names=link_names, joints=joints, parent_link=parent,
        child_link=child, q_index=q_index, active_joint_names=active,
        lower=np.asarray(d["lower"], float),
        upper=np.asarray(d["upper"], float),
        ancestor=ancestor_matrix(len(link_names), parent, child, q_index,
                                 len(active)))


def _rows(v):
    return None if v is None else np.asarray(v, float)


def scene_to_numpy(scene) -> dict:
    """Geometry (kinds, links, params, local poses, capsule endpoints;
    per geom the hull vertices, normals and edges, the SDF grid as
    (values, origin, spacing) and the center's params key, each None where
    it has none), the narrowphase options and the candidate-pair list of a
    collision scene."""
    gs = scene.geoms
    index = {g.name: i for i, g in enumerate(gs)}
    return {
        "tree": tree_to_numpy(scene.tree),
        "names": np.asarray([g.name for g in gs]),
        "kinds": np.asarray([g.kind for g in gs]),
        "links": np.asarray([g.link or "" for g in gs]),
        "n_params": np.asarray([len(g.params) for g in gs], np.int64),
        "params": np.stack([np.pad(np.asarray(g.params, float),
                                   (0, 3 - len(g.params))) for g in gs]),
        "R_local": np.stack([np.asarray(g.R_local, float) for g in gs]),
        "p_local": np.stack([np.asarray(g.p_local, float) for g in gs]),
        "ea": np.stack([np.asarray(g.ea, float) for g in gs]),
        "eb": np.stack([np.asarray(g.eb, float) for g in gs]),
        "pairs": np.asarray([(index[a.name], index[b.name])
                             for a, b in scene.pairs()],
                            np.int64).reshape(-1, 2),
        "check_self_collision": bool(scene.check_self_collision),
        "verts": [_rows(g.verts) for g in gs],
        "normals": [_rows(g.normals) for g in gs],
        "edges": [_rows(g.edges) for g in gs],
        "grids": [None if g.grid is None else
                  (np.asarray(g.grid.values, float),
                   np.asarray(g.grid.origin, float), float(g.grid.spacing))
                  for g in gs],
        "p_params": [g.p_param for g in gs],
        "unify_narrowphase": bool(getattr(scene, "unify_narrowphase",
                                          False)),
        "max_cross_edges": int(getattr(scene, "max_cross_edges", 6)),
    }


def scene_from_numpy(d: dict, tree: KinematicTree | None = None
                     ) -> CollisionScene:
    """The port's scene over ``tree`` (default: built from ``d["tree"]``),
    with ``d["pairs"]`` as its candidate pairs, moving geom first."""
    tree = tree_from_numpy(d["tree"]) if tree is None else tree
    n = len(d["names"])
    scene = CollisionScene(
        tree, check_self_collision=bool(d["check_self_collision"]),
        unify_narrowphase=bool(d.get("unify_narrowphase", False)),
        max_cross_edges=int(d.get("max_cross_edges", 6)))
    for i, name in enumerate(d["names"]):
        grid = d.get("grids", [None] * n)[i]
        scene.add_geom(CollGeom(
            name=str(name), kind=str(d["kinds"][i]),
            params=tuple(float(v)
                         for v in d["params"][i][:int(d["n_params"][i])]),
            link=str(d["links"][i]) or None,
            R_local=np.asarray(d["R_local"][i], float),
            p_local=np.asarray(d["p_local"][i], float),
            ea=np.asarray(d["ea"][i], float),
            eb=np.asarray(d["eb"][i], float),
            grid=None if grid is None else SdfGrid(*grid),
            p_param=d.get("p_params", [None] * n)[i],
            verts=d.get("verts", [None] * n)[i],
            normals=d.get("normals", [None] * n)[i],
            edges=d.get("edges", [None] * n)[i]))
    scene.pair_names = [(str(d["names"][a]), str(d["names"][b]))
                        for a, b in d["pairs"]]
    return scene


def sqp_params_from_dict(d: dict) -> SQPParams:
    """``SQPParams`` (with its ``ADMMConfig``) from ``dataclasses.asdict``
    of the JAX parameters; an unknown field raises TypeError."""
    d = dict(d)
    qp = d.pop("qp", None)
    if qp is not None:
        d["qp"] = ADMMConfig(**qp)
    return SQPParams(**d)
