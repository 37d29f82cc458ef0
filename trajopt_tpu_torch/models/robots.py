"""Bundled robot models: kinematic trees + collision scenes.

Counterpart of ``trajopt_tpu/models/robots.py``: rrbot, boxbot,
spherebot, arm6 (with its shelf scene), arm7 and pr2ish; the URDFs are the
port's own copies under ``trajopt_tpu_torch/data/``.
"""

from __future__ import annotations

import functools
import os


from trajopt_tpu_torch.collision.world import CollisionScene
from trajopt_tpu_torch.kinematics.chain import KinematicTree, build_tree
from trajopt_tpu_torch.kinematics.urdf import load_urdf

DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data")


@functools.lru_cache
def rrbot() -> KinematicTree:
    return build_tree(load_urdf(os.path.join(DATA_DIR, "rrbot.urdf")))


@functools.lru_cache
def boxbot() -> KinematicTree:
    return build_tree(load_urdf(os.path.join(DATA_DIR, "boxbot.urdf")))


@functools.lru_cache
def spherebot() -> KinematicTree:
    # boxbot kinematics with a sphere body is the spherebot fixture's shape
    return build_tree(load_urdf(os.path.join(DATA_DIR, "boxbot.urdf")))


@functools.lru_cache
def arm6() -> KinematicTree:
    """6-DOF industrial-style arm (UR-class geometry)."""
    return build_tree(load_urdf(os.path.join(DATA_DIR, "arm6.urdf")))


def arm6_scene(shelf: bool = True) -> CollisionScene:
    """arm6 capsule decomposition, optionally with a shelf plate the wrist
    must duck under when reaching across and a wall behind it."""
    s = CollisionScene(arm6(), check_self_collision=False)
    s.add_link_capsule("upper_arm_link", 0.06, [0, -0.13, 0.05],
                       [0, -0.13, 0.40])
    s.add_link_capsule("forearm_link", 0.05, [0, 0, 0.05], [0, 0, 0.37])
    s.add_link_sphere("wrist_2_link", 0.05)
    s.add_link_sphere("tool0", 0.04)
    if shelf:
        s.add_world_box("shelf", [0.25, 0.25, 0.02], [0.45, 0.0, 0.55])
        s.add_world_box("wall", [0.02, 0.4, 0.4], [0.7, 0.0, 0.45])
    return s


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


# A planar two-link arm whose links are meshes (binary STL boxes) at the
# height of a post it must fold its elbow to pass: the mesh-hull scene of
# scene_from_urdf.  Half extents of each link's box mesh, and the post.
MESH_ARM_LINKS = {"upper": (0.25, 0.04, 0.04), "fore": (0.2, 0.035, 0.035)}
MESH_ARM_POST = ((0.08, 0.08, 0.3), (0.75, 0.0, 0.3))
MESH_ARM_URDF = """<robot name="mesh_arm">
  <link name="base">
    <collision><origin xyz="0 0 0.1"/>
      <geometry><box size="0.2 0.2 0.2"/></geometry></collision>
  </link>
  <link name="upper">
    <collision><origin xyz="0.25 0 0"/>
      <geometry><mesh filename="package://mesh_arm/upper.stl"/></geometry>
    </collision>
  </link>
  <link name="fore">
    <collision><origin xyz="0.2 0 0"/>
      <geometry><mesh filename="package://mesh_arm/fore.stl"/></geometry>
    </collision>
  </link>
  <joint name="shoulder" type="revolute">
    <parent link="base"/><child link="upper"/>
    <origin xyz="0 0 0.3"/><axis xyz="0 0 1"/>
    <limit lower="-3" upper="3"/>
  </joint>
  <joint name="elbow" type="revolute">
    <parent link="upper"/><child link="fore"/>
    <origin xyz="0.5 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-2.8" upper="2.8"/>
  </joint>
</robot>
"""
MESH_ARM_SRDF = """<robot name="mesh_arm">
  <group name="arm"><chain base_link="base" tip_link="fore"/></group>
  <group_state name="home" group="arm">
    <joint name="shoulder" value="-1.2"/><joint name="elbow" value="0.3"/>
  </group_state>
  <disable_collisions link1="base" link2="fore" reason="Never"/>
</robot>
"""


def write_mesh_arm(directory: str) -> str:
    """Write the mesh arm's two link meshes (``upper.stl``, ``fore.stl``)
    into ``directory``; returns the directory, the ``package://mesh_arm``
    root of :data:`MESH_ARM_URDF`."""
    from trajopt_tpu_torch.collision import decompose as dc

    for name, half in MESH_ARM_LINKS.items():
        dc.save_stl(os.path.join(directory, f"{name}.stl"),
                    dc.box_mesh(half))
    return directory


def mesh_arm_scene(directory: str) -> CollisionScene:
    """The mesh arm's scene from :data:`MESH_ARM_URDF` and
    :data:`MESH_ARM_SRDF` (``scene_from_urdf`` with one hull per mesh; the
    SRDF disables base/fore), with the meshes of :func:`write_mesh_arm`
    in ``directory`` and the post as a world box."""
    from trajopt_tpu_torch.collision.world import scene_from_urdf
    from trajopt_tpu_torch.kinematics.srdf import parse_srdf
    from trajopt_tpu_torch.kinematics.urdf import parse_urdf

    model = parse_urdf(MESH_ARM_URDF)
    scene = scene_from_urdf(build_tree(model), model,
                            parse_srdf(MESH_ARM_SRDF),
                            package_map={"mesh_arm": directory})
    half, center = MESH_ARM_POST
    scene.add_world_box("post", half, center)
    return scene
