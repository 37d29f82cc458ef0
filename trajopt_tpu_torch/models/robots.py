"""Bundled robot models: kinematic trees + collision scenes.

Counterpart of ``trajopt_tpu/models/robots.py`` for the pr2ish and arm7
fixtures; the URDFs are the port's own copies under
``trajopt_tpu_torch/data/``.
"""

from __future__ import annotations

import functools
import os

from trajopt_tpu_torch.collision.world import CollisionScene
from trajopt_tpu_torch.kinematics.chain import KinematicTree, build_tree
from trajopt_tpu_torch.kinematics.urdf import load_urdf

DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data")


@functools.lru_cache
def arm7() -> KinematicTree:
    """7-DOF revolute arm (the benchmark's '7-DOF basic-cartesian' robot)."""
    return build_tree(load_urdf(os.path.join(DATA_DIR, "arm7.urdf")))


def arm7_scene(world_objects: bool = True) -> CollisionScene:
    """arm7 with a capsule decomposition of its links, optionally in the
    table scene (table slab + a post across the benchmark swing arc); no
    self-collision, 8 candidate pairs."""
    tree = arm7()
    s = CollisionScene(tree, check_self_collision=False)
    # Capsules along each structural segment (z-offsets match arm7.urdf).
    s.add_link_capsule("base_link", 0.10, [0, 0, 0.0], [0, 0, 0.30])
    s.add_link_capsule("link_2", 0.08, [0, 0, 0.10], [0, 0, 0.36])
    s.add_link_capsule("link_4", 0.07, [0, 0, 0.0], [0, 0, 0.36])
    s.add_link_capsule("link_6", 0.06, [0, 0, 0.0], [0, 0, 0.10])
    s.add_link_sphere("link_7", 0.05, [0, 0, 0.08])
    if world_objects:
        s.add_world_box("table", [0.35, 0.5, 0.05], [0.55, 0.0, 0.25])
        s.add_world_box("post", [0.05, 0.05, 0.30], [0.39, 0.03, 1.00])
    # The base capsule cannot reach the world objects (an ACM entry).
    s.disabled_pairs.add(("base_link_capsule", "table"))
    s.disabled_pairs.add(("base_link_capsule", "post"))
    return s


@functools.lru_cache
def pr2ish() -> KinematicTree:
    """PR2-class whole-body fixture: prismatic torso lift + 7R right arm
    (8 DOF) with a tucked fixed left arm and head."""
    return build_tree(load_urdf(os.path.join(DATA_DIR, "pr2ish.urdf")))


def pr2ish_scene(world_objects: bool = True) -> CollisionScene:
    """pr2ish capsule/sphere body decomposition with self-collision ON, in
    the arm-around-table scene (table slab + leg + side cabinet); 91
    candidate pairs."""
    tree = pr2ish()
    s = CollisionScene(tree, check_self_collision=True)
    # body
    s.add_link_box("base_link", [0.33, 0.33, 0.15], [0.0, 0.0, 0.15])
    s.add_link_capsule("torso_link", 0.16, [0.0, 0.0, -0.35],
                       [0.0, 0.0, 0.25])
    s.add_link_sphere("head_link", 0.16)
    # right arm: capsules along the structural segments + joint spheres
    s.add_link_sphere("r_shoulder_pan_link", 0.10, [0.05, 0.0, 0.0])
    s.add_link_capsule("r_upper_arm_link", 0.08, [0.08, 0.0, 0.0],
                       [0.38, 0.0, 0.0])
    s.add_link_sphere("r_elbow_flex_link", 0.07)
    s.add_link_capsule("r_forearm_link", 0.06, [0.05, 0.0, 0.0],
                       [0.30, 0.0, 0.0])
    s.add_link_sphere("r_wrist_roll_link", 0.055)
    s.add_link_capsule("r_gripper_link", 0.035, [0.02, -0.04, 0.0],
                       [0.14, -0.02, 0.0], name="r_finger_l")
    s.add_link_capsule("r_gripper_link", 0.035, [0.02, 0.04, 0.0],
                       [0.14, 0.02, 0.0], name="r_finger_r")
    # tucked left arm (rigid group riding the lift; internal pairs prune)
    s.add_link_capsule("l_upper_arm_link", 0.08, [0.08, 0.0, 0.0],
                       [0.38, 0.0, 0.0])
    s.add_link_capsule("l_forearm_link", 0.06, [0.05, 0.0, 0.0],
                       [0.30, 0.0, 0.0])
    s.add_link_sphere("l_gripper_link", 0.05, [0.08, 0.0, 0.0])
    if world_objects:
        s.add_world_box("table_top", [0.30, 0.65, 0.03], [0.80, -0.05, 0.62])
        s.add_world_box("table_leg", [0.05, 0.05, 0.30], [0.80, 0.0, 0.30])
        s.add_world_box("cabinet", [0.30, 0.03, 0.35], [0.45, -0.90, 1.00])
    # ACM: trivially-always-close neighbours (SRDF <disable_collisions>)
    for a, b in [("r_shoulder_pan_link", "r_upper_arm_link"),
                 ("r_upper_arm_link", "r_forearm_link"),
                 ("r_upper_arm_link", "r_elbow_flex_link"),
                 ("r_elbow_flex_link", "r_forearm_link"),
                 ("r_forearm_link", "r_wrist_roll_link"),
                 ("r_wrist_roll_link", "r_gripper_link"),
                 ("r_forearm_link", "r_gripper_link"),
                 ("r_shoulder_pan_link", "torso_link"),
                 ("r_upper_arm_link", "torso_link"),
                 ("l_upper_arm_link", "torso_link"),
                 ("l_forearm_link", "torso_link"),
                 ("l_gripper_link", "torso_link"),
                 ("l_forearm_link", "head_link"),
                 ("base_link", "torso_link")]:
        s.disabled_link_pairs.add(frozenset((a, b)))
    return s
