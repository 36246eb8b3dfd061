"""Minimal MJCF importer -> RobotSpec.

Counterpart of `pulse_tpu/assets/mjcf.py`: an XML walk (xml.etree) over the
subset of MJCF that humanoid robot files use: nested <body> with pos,
<freejoint>, triplets of hinge <joint>s (read as one ball joint a body, as
the reference's dof_to_obs_smpl reads them, phc/env/tasks/humanoid.py:1436-
1446) and sphere / capsule / box <geom>s with density. Host-side numpy.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from pulse_tpu_torch.assets.robot_spec import GeomType, RobotSpec, compute_mass_properties
from pulse_tpu_torch.kinematics.skeleton import SkeletonTree

_IDENTITY = (0.0, 0.0, 0.0, 1.0)


def _floats(s: str) -> np.ndarray:
    return np.asarray([float(x) for x in s.replace(",", " ").split()])


def _wxyz_to_xyzw(q: np.ndarray) -> np.ndarray:
    return np.asarray([q[1], q[2], q[3], q[0]])


def _quat_attr(el: ET.Element) -> np.ndarray:
    """The element's `quat` (MJCF's wxyz) as xyzw, or the identity."""
    return _wxyz_to_xyzw(_floats(el.get("quat"))) if el.get("quat") else np.array(_IDENTITY)


def _capsule_from_fromto(fromto: np.ndarray, radius: float):
    """(centre, xyzw rotation of +z onto the axis, half length) of a capsule
    given by its end points."""
    a, b = fromto[:3], fromto[3:]
    mid = 0.5 * (a + b)
    d = b - a
    length = np.linalg.norm(d)
    half_len = 0.5 * length
    if length < 1e-9:
        return mid, np.array(_IDENTITY), half_len
    z = d / length
    # the shortest arc from +z onto z
    ref = np.array([0.0, 0.0, 1.0])
    c = np.cross(ref, z)
    w = 1.0 + float(np.dot(ref, z))
    if w < 1e-8:  # antiparallel: pi about x
        quat = np.array([1.0, 0.0, 0.0, 0.0])
    else:
        quat = np.array([c[0], c[1], c[2], w])
        quat = quat / np.linalg.norm(quat)
    return mid, quat, half_len


def parse_mjcf(path: str) -> RobotSpec:
    root = ET.parse(path).getroot()
    compiler = root.find("compiler")
    use_degrees = not (compiler is not None and compiler.get("angle") == "radian")
    ang = np.pi / 180.0 if use_degrees else 1.0

    # geom defaults (friction)
    default_friction = 1.0
    default_density = 1000.0
    default = root.find("default")
    if default is not None:
        dgeom = default.find("geom")
        if dgeom is not None and dgeom.get("friction"):
            default_friction = _floats(dgeom.get("friction"))[0]

    worldbody = root.find("worldbody")
    if worldbody is None:
        raise ValueError(f"{path}: no <worldbody>")

    names: list[str] = []
    parents: list[int] = []
    local_t: list[np.ndarray] = []
    jstiff: list[float] = []
    jdamp: list[float] = []
    jarm: list[float] = []
    dof_lo: list[np.ndarray] = []
    dof_hi: list[np.ndarray] = []
    g_body, g_type, g_pos, g_quat, g_size, g_dens, g_fric = ([] for _ in range(7))

    def add_geom(bidx: int, el: ET.Element):
        gtype = el.get("type", "capsule")
        density = float(el.get("density", default_density))
        friction = _floats(el.get("friction"))[0] if el.get("friction") else default_friction
        if gtype == "sphere":
            pos = _floats(el.get("pos", "0 0 0"))
            quat = np.array(_IDENTITY)
            size = np.array([_floats(el.get("size"))[0], 0.0, 0.0])
            t = GeomType.SPHERE
        elif gtype == "capsule":
            r = _floats(el.get("size"))[0]
            if el.get("fromto"):
                pos, quat, half_len = _capsule_from_fromto(_floats(el.get("fromto")), r)
            else:
                pos = _floats(el.get("pos", "0 0 0"))
                quat = _quat_attr(el)
                sizes = _floats(el.get("size"))
                half_len = sizes[1] if sizes.size > 1 else 0.0
            size = np.array([r, half_len, 0.0])
            t = GeomType.CAPSULE
        elif gtype == "box":
            pos = _floats(el.get("pos", "0 0 0"))
            quat = _quat_attr(el)
            size = _floats(el.get("size"))
            t = GeomType.BOX
        elif gtype == "plane":
            return  # the world plane is the environment's, not the robot's
        else:
            raise ValueError(f"unsupported geom type {gtype!r}")
        g_body.append(bidx)
        g_type.append(int(t))
        g_pos.append(pos)
        g_quat.append(quat)
        g_size.append(size)
        g_dens.append(density)
        g_fric.append(friction)

    def walk(el: ET.Element, parent: int):
        idx = len(names)
        names.append(el.get("name", f"body{idx}"))
        parents.append(parent)
        local_t.append(_floats(el.get("pos", "0 0 0")))

        joints = el.findall("joint")
        free = el.find("freejoint") is not None or any(j.get("type") == "free" for j in joints)
        hinges = [j for j in joints if j.get("type", "hinge") == "hinge"]
        if parent >= 0:
            if len(hinges) not in (0, 3):
                raise ValueError(f"body {names[idx]}: expected 0 or 3 hinge joints, got {len(hinges)}")
            lo, hi = np.zeros(3), np.zeros(3)
            if hinges:
                jstiff.append(float(hinges[0].get("stiffness", 0.0)))
                jdamp.append(float(hinges[0].get("damping", 0.0)))
                jarm.append(float(hinges[0].get("armature", 0.0)))
                for j in hinges:
                    rng = _floats(j.get("range", "-180 180")) * ang
                    ax = int(np.argmax(np.abs(_floats(j.get("axis", "0 0 1")))))
                    lo[ax], hi[ax] = rng[0], rng[1]
            else:  # a welded body
                jstiff.append(0.0)
                jdamp.append(0.0)
                jarm.append(0.0)
            dof_lo.append(lo)
            dof_hi.append(hi)
        elif not free:
            raise ValueError(f"root body {names[idx]} must have a freejoint")

        for geom in el.findall("geom"):
            add_geom(idx, geom)
        for child in el.findall("body"):
            walk(child, idx)

    roots = worldbody.findall("body")
    if len(roots) != 1:
        raise ValueError(f"{path}: expected exactly one root body, got {len(roots)}")
    walk(roots[0], -1)

    skeleton = SkeletonTree(tuple(names), np.asarray(parents), np.asarray(local_t))
    geom = dict(geom_body=np.asarray(g_body), geom_type=np.asarray(g_type), geom_pos=np.asarray(g_pos),
                geom_quat=np.asarray(g_quat), geom_size=np.asarray(g_size), geom_density=np.asarray(g_dens))
    mass, com, inertia = compute_mass_properties(len(names), **geom)
    return RobotSpec(
        skeleton=skeleton,
        joint_stiffness=np.asarray(jstiff),
        joint_damping=np.asarray(jdamp),
        joint_armature=np.asarray(jarm),
        dof_lower=np.concatenate(dof_lo) if dof_lo else np.zeros(0),
        dof_upper=np.concatenate(dof_hi) if dof_hi else np.zeros(0),
        geom_friction=np.asarray(g_fric),
        body_mass=mass,
        body_com=com,
        body_inertia=inertia,
        **geom,
    )
