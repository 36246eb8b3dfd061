"""Robot specification as host-side numpy arrays.

Counterpart of `pulse_tpu/assets/robot_spec.py` (loading only): every
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

    @classmethod
    def load(cls, path: str) -> "RobotSpec":
        with open(path) as fh:
            d = json.load(fh)
        skel = SkeletonTree.from_dict(d.pop("skeleton"))
        return cls(skeleton=skel, **{k: np.asarray(v) for k, v in d.items()})
