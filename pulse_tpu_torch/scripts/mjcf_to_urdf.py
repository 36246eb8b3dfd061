"""MJCF -> URDF converter.

Counterpart of `scripts/mjcf_to_urdf.py` (≙ the reference's
scripts/mjcf_to_urdf.py, which goes through pybullet's UrdfEditor): the
URDF is written straight from the parsed RobotSpec, so no simulator is
needed. Each ball joint becomes the standard URDF decomposition, three
stacked revolute joints (x, y, z) threaded through two massless
intermediate links, the 3-hinge layout the reference's MJCFs use for PhysX.

    python -m pulse_tpu_torch.scripts.mjcf_to_urdf <robot.xml|robot.json> [out.urdf]

`.xml` is read by `assets/mjcf.py` `parse_mjcf`, `.json` as a RobotSpec.
Host-side only: nothing runs on a device, so it takes no `--device`.
"""

from __future__ import annotations

import sys
import xml.etree.ElementTree as ET

import numpy as np

from pulse_tpu_torch.assets import GeomType, RobotSpec, parse_mjcf


def _inertial(el, mass, com, inertia):
    inr = ET.SubElement(el, "inertial")
    ET.SubElement(inr, "origin", xyz="%g %g %g" % tuple(com), rpy="0 0 0")
    ET.SubElement(inr, "mass", value="%g" % mass)
    I = np.asarray(inertia)
    ET.SubElement(inr, "inertia", ixx="%g" % I[0, 0], iyy="%g" % I[1, 1], izz="%g" % I[2, 2],
                  ixy="%g" % I[0, 1], ixz="%g" % I[0, 2], iyz="%g" % I[1, 2])


def _quat_to_rpy(q):
    """xyzw quaternion -> URDF fixed-axis rpy."""
    x, y, z, w = q
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def _geoms(el, spec, body_idx):
    for g in range(len(spec.geom_body)):
        if int(spec.geom_body[g]) != body_idx:
            continue
        col = ET.SubElement(el, "collision")
        ET.SubElement(col, "origin", xyz="%g %g %g" % tuple(spec.geom_pos[g]),
                      rpy="%g %g %g" % _quat_to_rpy(spec.geom_quat[g]))
        geo = ET.SubElement(col, "geometry")
        t = int(spec.geom_type[g])
        s = spec.geom_size[g]
        if t == GeomType.SPHERE:
            ET.SubElement(geo, "sphere", radius="%g" % s[0])
        elif t == GeomType.CAPSULE:
            # URDF has no capsule: a cylinder of the capsule's shaft
            ET.SubElement(geo, "cylinder", radius="%g" % s[0], length="%g" % (2 * s[1]))
        else:
            ET.SubElement(geo, "box", size="%g %g %g" % tuple(2 * s))


def robot_spec_to_urdf(spec, name: str = "humanoid") -> str:
    tree = spec.skeleton
    robot = ET.Element("robot", name=name)
    names = tree.node_names
    root = ET.SubElement(robot, "link", name=names[0])
    _inertial(root, spec.body_mass[0], spec.body_com[0], spec.body_inertia[0])
    _geoms(root, spec, 0)

    for b in range(1, tree.num_joints):
        child = names[b]
        offset = np.asarray(tree.local_translation[b])
        lo = spec.dof_lower[3 * (b - 1): 3 * b]
        hi = spec.dof_upper[3 * (b - 1): 3 * b]
        prev = names[tree.parent_indices[b]]
        for ax_i, axis in enumerate(((1, 0, 0), (0, 1, 0), (0, 0, 1))):
            last = ax_i == 2
            link_name = child if last else f"{child}_dummy{ax_i}"
            link = ET.SubElement(robot, "link", name=link_name)
            if last:
                _inertial(link, spec.body_mass[b], spec.body_com[b], spec.body_inertia[b])
                _geoms(link, spec, b)
            j = ET.SubElement(robot, "joint", name=f"{child}_{'xyz'[ax_i]}", type="revolute")
            ET.SubElement(j, "parent", link=prev)
            ET.SubElement(j, "child", link=link_name)
            xyz = offset if ax_i == 0 else np.zeros(3)
            ET.SubElement(j, "origin", xyz="%g %g %g" % tuple(xyz), rpy="0 0 0")
            ET.SubElement(j, "axis", xyz="%d %d %d" % axis)
            ET.SubElement(j, "limit", lower="%g" % lo[ax_i], upper="%g" % hi[ax_i], effort="500", velocity="100")
            prev = link_name
    ET.indent(robot)
    return ET.tostring(robot, encoding="unicode")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    src = argv[0]
    out = argv[1] if len(argv) > 1 else src.rsplit(".", 1)[0] + ".urdf"
    spec = RobotSpec.load(src) if src.endswith(".json") else parse_mjcf(src)
    with open(out, "w") as f:
        f.write(robot_spec_to_urdf(spec))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
