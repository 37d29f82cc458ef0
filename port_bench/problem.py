"""The system under test, built from a configuration file: the port's
robot from the benchmark's URDF copy, its collision scene from the
configuration's geometry and pair list, its ``TrajOptProblem`` from the
configuration's terms, and the solve callable ``make_solve`` gives with
every solver setting passed explicitly.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _num(v):
    if v in ("inf", "-inf"):
        return math.inf if v == "inf" else -math.inf
    return v


def solver_params(cfg: dict):
    """``SQPParams`` with its ``ADMMConfig``, every field from ``cfg``."""
    from trajopt_tpu_torch.qp.admm import ADMMConfig
    from trajopt_tpu_torch.sqp.params import SQPParams

    qp = ADMMConfig(**{k: _num(v) for k, v in cfg["admm"].items()})
    sqp = SQPParams(**{k: _num(v) for k, v in cfg["sqp"].items()}, qp=qp)
    missing = {f.name for f in dataclasses.fields(SQPParams)} - \
        set(cfg["sqp"]) - {"qp"}
    missing |= {f.name for f in dataclasses.fields(ADMMConfig)} - \
        set(cfg["admm"])
    if missing:
        raise ValueError(f"{cfg['name']}: solver settings not given: "
                         f"{sorted(missing)}")
    return sqp


def build_scene(cfg: dict, tree):
    from trajopt_tpu_torch.collision.world import CollisionScene

    sc = cfg["scene"]
    scene = CollisionScene(tree, check_self_collision=sc[
        "check_self_collision"])
    scene.unify_narrowphase = sc["unify_narrowphase"]
    for g in sc["geoms"]:
        center = g.get("center", (0.0, 0.0, 0.0))
        if g["kind"] == "sphere" and g["link"] is not None:
            scene.add_link_sphere(g["link"], g["radius"], center,
                                  name=g["name"])
        elif g["kind"] == "capsule" and g["link"] is not None:
            scene.add_link_capsule(g["link"], g["radius"], g["ea"], g["eb"],
                                   name=g["name"])
        elif g["kind"] == "box" and g["link"] is not None:
            scene.add_link_box(g["link"], g["half_extents"], center,
                               name=g["name"])
        elif g["kind"] == "box":
            scene.add_world_box(g["name"], g["half_extents"], center,
                                R=g.get("R"))
        elif g["kind"] == "sphere":
            scene.add_world_sphere(g["name"], g["radius"], center)
        else:
            raise ValueError(f"geom {g['name']}: {g['kind']} on link "
                             f"{g['link']} is not supported")
    scene.pair_names = [tuple(p) for p in sc["pairs"]]
    return scene


def build(cfg: dict, device):
    """(problem, scene, solve) for ``cfg`` on ``device``."""
    from trajopt_tpu_torch.kinematics.chain import build_tree
    from trajopt_tpu_torch.kinematics.urdf import load_urdf
    from trajopt_tpu_torch.problem.trajectory import TrajOptProblem
    from trajopt_tpu_torch.terms.collision import collision_term
    from trajopt_tpu_torch.terms.joint import joint_pos, joint_vel

    tree = build_tree(load_urdf(str(ROOT / cfg["urdf"])))
    scene = build_scene(cfg, tree)
    T, D = cfg["n_steps"], len(tree.lower)
    prob = TrajOptProblem(n_steps=T, n_dof=D, joint_lower=tree.lower,
                          joint_upper=tree.upper,
                          fixed_steps=cfg["fixed_steps"], device=device)
    for term in cfg["terms"]:
        kw = {k: v for k, v in term.items() if k not in ("type", "is_cost")}
        if "coeffs" in kw:
            kw["coeffs"] = np.asarray(kw["coeffs"], float)
        if term["type"] == "joint_vel":
            prob.add_term(joint_vel(T, D, is_cost=term["is_cost"], **kw))
        elif term["type"] == "joint_pos":
            prob.add_term(joint_pos(T, D, is_cost=term["is_cost"], **kw))
        elif term["type"] == "collision":
            prob.add_term(collision_term(scene, T, is_cost=term["is_cost"],
                                         **kw))
        else:
            raise ValueError(f"term type {term['type']} is not supported")
    solve = prob.make_solve(solver_params(cfg),
                            structured=cfg["structured"], device=device)
    return prob, scene, solve
