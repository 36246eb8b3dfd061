"""Static physics model: device constants derived from a RobotSpec.

Counterpart of `pulse_tpu/physics/model.py` for flat ground without self
collision (no terrain, no `cap_*` capsule leaves). A model is shared by all
envs, or batched for per-env body shapes (`physics/shape_variation.py`):
then every array leaf except `cp_body` carries a leading env axis [B, ...],
while the topology (`parents`, `levels`, `level_index`, `cp_body`) stays
shared, as the JAX package's batched Model keeps it static.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pulse_tpu_torch._device import resolve_device
from pulse_tpu_torch.assets.robot_spec import GeomType, RobotSpec
from pulse_tpu_torch.physics import spatial


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """dt 1/60 with 2 substeps and control_freq_inv 2: 4 inner steps of
    1/120 s per 30 Hz control step."""

    dt: float = 1.0 / 60.0
    substeps: int = 2
    control_freq_inv: int = 2
    gravity: float = -9.81
    contact_stiffness: float = 3.0e4
    contact_damping: float = 1.2e3
    friction_regularization: float = 0.08
    max_contact_force: float = 2000.0
    max_angular_velocity: float = 64.0
    max_linear_velocity: float = 50.0
    limit_stiffness: float = 400.0
    limit_damping: float = 10.0
    self_collision: bool = False
    kp_scale: float = 1.0
    kd_scale: float = 1.0
    torque_limit: float = 1.0e4

    @property
    def h(self) -> float:
        return self.dt / self.substeps

    @property
    def steps_per_control(self) -> int:
        return self.substeps * self.control_freq_inv

    @property
    def control_dt(self) -> float:
        return self.dt * self.control_freq_inv


@dataclasses.dataclass
class Model:
    """Tensors live on `device`; `parents`/`levels` are static python.
    Shapes below are the shared model's; a batched model prefixes [B]."""

    parents: tuple
    num_bodies: int
    config: PhysicsConfig
    levels: tuple                      # ((body_ids), (parent_ids)) per depth, root first
    device: torch.device
    local_translation: torch.Tensor    # [J, 3]
    body_mass: torch.Tensor            # [J]
    body_com: torch.Tensor             # [J, 3]
    spatial_inertia: torch.Tensor      # [J, 6, 6] about the body origin
    total_mass: torch.Tensor           # [] sum of body_mass
    joint_kp: torch.Tensor             # [J-1]
    joint_kd: torch.Tensor             # [J-1]
    joint_armature: torch.Tensor       # [J-1]
    dof_lower: torch.Tensor            # [D]
    dof_upper: torch.Tensor            # [D]
    pd_action_offset: torch.Tensor     # [D]
    pd_action_scale: torch.Tensor      # [D]
    cp_body: torch.Tensor              # [P] long, shared
    cp_offset: torch.Tensor            # [P, 3]
    cp_radius: torch.Tensor            # [P]
    cp_friction: torch.Tensor          # [P]
    level_index: list                  # (body ids, parent ids) per non-root level, device tensors

    @property
    def num_joints(self) -> int:
        return self.num_bodies - 1

    @property
    def num_dof(self) -> int:
        return 3 * self.num_joints

    @property
    def batched(self) -> bool:
        """Per-env shapes: the array leaves carry a leading env axis."""
        return self.body_mass.dim() == 2

    def env_axis(self, x: torch.Tensor) -> torch.Tensor:
        """A leaf of this model with a leading env axis: [B, ...] as stored
        when batched, [1, ...] when shared."""
        return x if self.batched else x[None]


# the array leaves a batched model carries per env
BATCHED_LEAVES = (
    "local_translation", "body_mass", "body_com", "spatial_inertia", "total_mass", "joint_kp", "joint_kd",
    "joint_armature", "dof_lower", "dof_upper", "pd_action_offset", "pd_action_scale", "cp_offset", "cp_radius",
    "cp_friction",
)


def batched_model_from_numpy(base: Model, leaves: dict) -> Model:
    """The batched model whose leaves are `leaves`, numpy arrays [B, ...]
    keyed by field name (e.g. a JAX batched Model converted leaf by leaf),
    over the topology of the shared `base`. A `cp_body` leaf, where given,
    must repeat base's in every env."""
    if "cp_body" in leaves:
        cp = np.asarray(leaves["cp_body"]).reshape(-1, base.cp_body.shape[0])
        if not (cp == base.cp_body.cpu().numpy()[None]).all():
            raise ValueError("per-env contact-point bodies differ from the base model's")
    return dataclasses.replace(base, **{
        k: torch.as_tensor(np.array(leaves[k], np.float32), device=base.device) for k in BATCHED_LEAVES
    })


def _contact_points(spec: RobotSpec):
    """Plane-collision proxy points per geom: sphere centre, capsule ends,
    box corners."""
    bodies, offsets, radii, fric = [], [], [], []
    for g in range(len(spec.geom_body)):
        b = int(spec.geom_body[g])
        t = int(spec.geom_type[g])
        pos = spec.geom_pos[g]
        quat = spec.geom_quat[g]
        size = spec.geom_size[g]
        mu = float(spec.geom_friction[g])

        def rot(v):
            w = quat[3]
            uv = np.cross(quat[:3], v)
            uuv = np.cross(quat[:3], uv)
            return v + 2.0 * (w * uv + uuv)

        if t == GeomType.SPHERE:
            pts, r = [pos], [size[0]]
        elif t == GeomType.CAPSULE:
            axis = rot(np.asarray([0.0, 0.0, 1.0]))
            pts, r = [pos + size[1] * axis, pos - size[1] * axis], [size[0], size[0]]
        else:
            pts, r = [], []
            for sx in (-1, 1):
                for sy in (-1, 1):
                    for sz in (-1, 1):
                        pts.append(pos + rot(np.asarray([sx, sy, sz]) * size))
                        r.append(0.0)
        for p_, r_ in zip(pts, r):
            bodies.append(b)
            offsets.append(p_)
            radii.append(r_)
            fric.append(mu)
    return (
        np.asarray(bodies, np.int32),
        np.asarray(offsets, np.float32),
        np.asarray(radii, np.float32),
        np.asarray(fric, np.float32),
    )


def build_pd_action_offset_scale(
    dof_lower: np.ndarray, dof_upper: np.ndarray, joint_names: list[str]
) -> tuple[np.ndarray, np.ndarray]:
    """Action -> PD target affine map: per ball joint a symmetric range of
    1.2*max(|lo|,|hi|) clipped to pi; knees widened to scale 5."""
    D = len(dof_lower)
    lo, hi = dof_lower.copy(), dof_upper.copy()
    for j in range(D // 3):
        s = slice(3 * j, 3 * j + 3)
        m = max(np.abs(lo[s]).max(), np.abs(hi[s]).max())
        scale = min(1.2 * m, np.pi)
        lo[s], hi[s] = -scale, scale
    offset = 0.5 * (hi + lo)
    scale = 0.5 * (hi - lo)
    for j, nm in enumerate(joint_names):
        if nm in ("L_Knee", "R_Knee"):
            scale[3 * j + 1] = 5.0
    return offset.astype(np.float32), scale.astype(np.float32)


def build_model(spec: RobotSpec, config: PhysicsConfig | None = None, device=None) -> Model:
    device = resolve_device(device)
    config = config or PhysicsConfig()
    if config.self_collision:
        raise NotImplementedError("self collision is not ported yet")
    tree = spec.skeleton
    I_spatial = spatial.spatial_inertia(
        torch.as_tensor(spec.body_mass), torch.as_tensor(spec.body_com), torch.as_tensor(spec.body_inertia)
    )
    cp_body, cp_offset, cp_radius, cp_fric = _contact_points(spec)
    pd_offset, pd_scale = build_pd_action_offset_scale(
        spec.dof_lower, spec.dof_upper, list(tree.node_names[1:])
    )
    levels = tuple(
        (tuple(int(b) for b in lvl), tuple(int(tree.parent_indices[b]) for b in lvl))
        for lvl in tree.levels
    )

    def up(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)

    return Model(
        parents=tuple(int(p) for p in tree.parent_indices),
        num_bodies=spec.num_bodies,
        config=config,
        levels=levels,
        device=device,
        local_translation=up(tree.local_translation),
        body_mass=up(spec.body_mass),
        body_com=up(spec.body_com),
        spatial_inertia=I_spatial.to(device),
        total_mass=up(spec.body_mass.sum()),
        joint_kp=up(spec.joint_stiffness * config.kp_scale),
        joint_kd=up(spec.joint_damping * config.kd_scale),
        joint_armature=up(spec.joint_armature),
        dof_lower=up(spec.dof_lower),
        dof_upper=up(spec.dof_upper),
        pd_action_offset=up(pd_offset),
        pd_action_scale=up(pd_scale),
        cp_body=up(cp_body, torch.long),
        cp_offset=up(cp_offset),
        cp_radius=up(cp_radius),
        cp_friction=up(cp_fric),
        level_index=[(up(b, torch.long), up(p, torch.long)) for b, p in levels[1:]],
    )
