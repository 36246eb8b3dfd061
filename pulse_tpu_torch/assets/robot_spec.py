"""Robot specification as host-side numpy arrays.

Counterpart of `pulse_tpu/assets/robot_spec.py` (loading, and the mass
properties of primitive geoms that `assets/mjcf.py` derives): every
non-root body hangs off its parent by one ball joint with exp-map
coordinates; collision geoms and mass properties are stored flattened.
"""

from __future__ import annotations

import dataclasses
import enum
import json

import numpy as np

from pulse_tpu_torch.kinematics.skeleton import SkeletonTree


class GeomType(enum.IntEnum):
    SPHERE = 0
    CAPSULE = 1
    BOX = 2


@dataclasses.dataclass(frozen=True)
class RobotSpec:
    skeleton: SkeletonTree
    joint_stiffness: np.ndarray   # [J-1] PD kp per ball joint
    joint_damping: np.ndarray     # [J-1] PD kd
    joint_armature: np.ndarray    # [J-1]
    dof_lower: np.ndarray         # [3*(J-1)] rad
    dof_upper: np.ndarray         # [3*(J-1)]
    geom_body: np.ndarray         # [NG] owning body
    geom_type: np.ndarray         # [NG] GeomType
    geom_pos: np.ndarray          # [NG, 3] body frame
    geom_quat: np.ndarray         # [NG, 4] xyzw body frame
    geom_size: np.ndarray         # [NG, 3]
    geom_density: np.ndarray      # [NG]
    geom_friction: np.ndarray     # [NG]
    body_mass: np.ndarray         # [J]
    body_com: np.ndarray          # [J, 3]
    body_inertia: np.ndarray      # [J, 3, 3] about the COM

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if f.name == "skeleton":
                continue
            dtype = np.int32 if f.name in ("geom_body", "geom_type") else np.float32
            object.__setattr__(self, f.name, np.asarray(getattr(self, f.name)).astype(dtype))

    @property
    def num_bodies(self) -> int:
        return self.skeleton.num_joints

    @property
    def num_joints(self) -> int:
        return self.num_bodies - 1

    @property
    def num_dof(self) -> int:
        return 3 * self.num_joints

    @classmethod
    def load(cls, path: str) -> "RobotSpec":
        with open(path) as fh:
            d = json.load(fh)
        skel = SkeletonTree.from_dict(d.pop("skeleton"))
        return cls(skeleton=skel, **{k: np.asarray(v) for k, v in d.items()})


# --------------------------------------------------------------------------- #
# mass properties from primitive geoms
# --------------------------------------------------------------------------- #

def _sphere_mass_inertia(r: float, density: float):
    m = density * 4.0 / 3.0 * np.pi * r**3
    i = 0.4 * m * r * r
    return m, np.diag([i, i, i])


def _box_mass_inertia(half: np.ndarray, density: float):
    a, b, c = 2 * half  # full extents
    m = density * a * b * c
    return m, np.diag([m / 12.0 * (b * b + c * c), m / 12.0 * (a * a + c * c), m / 12.0 * (a * a + b * b)])


def _capsule_mass_inertia(r: float, half_len: float, density: float):
    """Capsule with symmetry axis z, cylinder length 2*half_len."""
    L = 2.0 * half_len
    m_cyl = density * np.pi * r * r * L
    m_caps = density * 4.0 / 3.0 * np.pi * r**3  # both hemispheres
    m = m_cyl + m_caps
    izz = 0.5 * m_cyl * r * r + 0.4 * m_caps * r * r
    ixx = m_cyl * (L * L / 12.0 + r * r / 4.0) + m_caps * (0.4 * r * r + half_len * half_len + 3.0 / 8.0 * L * r)
    return m, np.diag([ixx, ixx, izz])


def _quat_to_mat_np(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _geom_mass_inertia(t: int, s: np.ndarray, d: float):
    if t == GeomType.SPHERE:
        return _sphere_mass_inertia(s[0], d)
    if t == GeomType.CAPSULE:
        return _capsule_mass_inertia(s[0], s[1], d)
    return _box_mass_inertia(s, d)


def compute_mass_properties(num_bodies: int, geom_body: np.ndarray, geom_type: np.ndarray, geom_pos: np.ndarray,
                            geom_quat: np.ndarray, geom_size: np.ndarray, geom_density: np.ndarray):
    """Per-geom primitive inertias aggregated into per-body (mass [J], COM
    [J, 3], inertia [J, 3, 3] about the COM in the body frame), as Isaac
    Gym computes them from geom densities."""
    mass = np.zeros(num_bodies)
    first_moment = np.zeros((num_bodies, 3))
    for g in range(len(geom_body)):
        m, _ = _geom_mass_inertia(int(geom_type[g]), geom_size[g], float(geom_density[g]))
        b = int(geom_body[g])
        mass[b] += m
        first_moment[b] += m * geom_pos[g]

    com = np.where(mass[:, None] > 0, first_moment / np.maximum(mass[:, None], 1e-12), 0.0)

    inertia = np.zeros((num_bodies, 3, 3))
    for g in range(len(geom_body)):
        m, inertia_g = _geom_mass_inertia(int(geom_type[g]), geom_size[g], float(geom_density[g]))
        b = int(geom_body[g])
        R = _quat_to_mat_np(geom_quat[g])
        r = geom_pos[g] - com[b]  # offset of the geom's COM from the body's
        # the parallel axis theorem to the body COM
        inertia[b] += R @ inertia_g @ R.T + m * (np.dot(r, r) * np.eye(3) - np.outer(r, r))
    return mass, com, inertia
