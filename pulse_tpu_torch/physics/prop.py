"""A free rigid prop (a box) with two-way humanoid contact, batched over
envs.

Counterpart of `pulse_tpu/physics/prop.py`: the prop is one free rigid
body per env with the same compliant contact as the humanoid's, its 8
corners against the ground plane and the humanoid's contact-point spheres
against its signed distance field, the forces equal and opposite on both.
`prop_step` advances it one substep and returns the reaction forces that
`step.physics_step_with_prop` applies to the humanoid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pulse_tpu_torch.ops import quat as q
from pulse_tpu_torch.physics.model import Model


@dataclasses.dataclass(frozen=True)
class PropSpec:
    half_extents: tuple = (0.25, 0.25, 0.9)
    density: float = 100.0
    friction: float = 0.6

    @property
    def mass(self) -> float:
        hx, hy, hz = self.half_extents
        return self.density * 8.0 * hx * hy * hz

    @property
    def inertia_diag(self) -> np.ndarray:
        hx, hy, hz = self.half_extents
        m = self.mass
        return np.asarray([m / 3.0 * (hy * hy + hz * hz), m / 3.0 * (hx * hx + hz * hz),
                           m / 3.0 * (hx * hx + hy * hy)], np.float32)

    @property
    def corners(self) -> np.ndarray:
        hx, hy, hz = self.half_extents
        return np.asarray([[sx * hx, sy * hy, sz * hz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                          np.float32)


@dataclasses.dataclass
class PropState:
    """[B, ...]: world COM position, rotation (xyzw), world linear and
    angular velocity."""

    pos: torch.Tensor
    rot: torch.Tensor
    lin_vel: torch.Tensor
    ang_vel: torch.Tensor

    def replace(self, **kw) -> "PropState":
        return dataclasses.replace(self, **kw)


def make_prop_state(pos: torch.Tensor, rot: torch.Tensor | None = None) -> PropState:
    """Props at rest at `pos` [B, 3], upright unless `rot` [B, 4] is given."""
    if rot is None:
        rot = torch.zeros(pos.shape[0], 4, device=pos.device)
        rot[:, 3] = 1.0
    return PropState(pos=pos, rot=rot, lin_vel=torch.zeros_like(pos), ang_vel=torch.zeros_like(pos))


def _box_sdf_push(rel: torch.Tensor, half: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Signed distance and outward normal of points rel [..., 3] in the box
    frame: negative inside, where the normal is the nearest face's."""
    d = rel.abs() - half
    outside = torch.clamp(d, min=0.0)
    dist_out = torch.linalg.vector_norm(outside, dim=-1)
    sdf = dist_out + torch.clamp(d.amax(dim=-1), max=0.0)
    inside_normal = torch.nn.functional.one_hot(d.argmax(dim=-1), 3).to(rel.dtype) * torch.sign(rel)
    out_norm = outside * torch.sign(rel) / torch.clamp(dist_out[..., None], min=1e-9)
    return sdf, torch.where((sdf > 0)[..., None], out_norm, inside_normal)


def prop_step(model: Model, spec: PropSpec, prop: PropState, body_pos: torch.Tensor, body_rot: torch.Tensor,
              body_vel: torch.Tensor, body_ang_vel: torch.Tensor, h: float):
    """One substep of [B] props against the humanoids' world bodies
    ([B, J, ...]). Returns (the new props, the reaction spatial forces on
    the humanoid's bodies [B, J, 6] (world torque about the body origin,
    force), the sum of |force| the humanoid takes from its prop [B, 3])."""
    cfg = model.config
    m = spec.mass
    I_diag = body_pos.new_tensor(spec.inertia_diag)
    pos, rot = prop.pos[:, None], prop.rot[:, None]
    lin, ang = prop.lin_vel[:, None], prop.ang_vel[:, None]
    ks, kd = cfg.contact_stiffness, cfg.contact_damping

    # ---- corners vs ground ------------------------------------------------ #
    corners_w = pos + q.quat_rotate(rot, body_pos.new_tensor(spec.corners))
    depth = -corners_w[..., 2]
    vp = lin + q.cross(ang, corners_w - pos)
    fn = torch.where(depth > 0, torch.clamp(ks * depth - kd * vp[..., 2], min=0.0), torch.zeros_like(depth))
    vt = torch.cat([vp[..., :2], torch.zeros_like(vp[..., 2:])], dim=-1)
    vt_norm = torch.sqrt(torch.sum(vt * vt, dim=-1) + 1e-12)
    scale = torch.clamp(vt_norm / cfg.friction_regularization, max=1.0)
    ft = -(spec.friction * fn * scale / vt_norm)[..., None] * vt
    f_ground = torch.cat([ft[..., :2], ft[..., 2:] + fn[..., None]], dim=-1)
    force = m * body_pos.new_tensor([0.0, 0.0, cfg.gravity]) + f_ground.sum(dim=1)
    torque = q.cross(corners_w - pos, f_ground).sum(dim=1)

    # ---- humanoid contact-point spheres vs the box ------------------------ #
    b = model.cp_body
    p_w = body_pos[:, b] + q.quat_rotate(body_rot[:, b], model.cp_offset)
    sdf, n_local = _box_sdf_push(q.quat_rotate_inverse(rot, p_w - pos), body_pos.new_tensor(spec.half_extents))
    pen = model.cp_radius - sdf
    n_w = q.quat_rotate(rot, n_local)
    arm_h = p_w - body_pos[:, b]
    v_h = body_vel[:, b] + q.cross(body_ang_vel[:, b], arm_h)
    v_rel_n = torch.sum((v_h - (lin + q.cross(ang, p_w - pos))) * n_w, dim=-1)
    fmag = torch.where(pen > 0, torch.clamp(ks * pen - kd * v_rel_n, min=0.0), torch.zeros_like(pen))
    f_on_h = fmag[..., None] * n_w
    force = force - f_on_h.sum(dim=1)
    torque = torque - q.cross(p_w - pos, f_on_h).sum(dim=1)
    B, J = body_pos.shape[0], model.num_bodies
    f_ext_h = body_pos.new_zeros(B, J, 6).index_add_(1, b, torch.cat([q.cross(arm_h, f_on_h), f_on_h], dim=-1))

    # ---- integrate: semi-implicit, Euler's equations in the body frame ---- #
    lin_vel = prop.lin_vel + h * force / m
    w_body = q.quat_rotate_inverse(prop.rot, prop.ang_vel)
    t_body = q.quat_rotate_inverse(prop.rot, torque)
    w_body = w_body + h * (t_body - q.cross(w_body, I_diag * w_body)) / I_diag
    new = PropState(pos=prop.pos + h * lin_vel,
                    rot=q.quat_mul_norm(prop.rot, q.exp_map_to_quat(h * w_body)),
                    lin_vel=lin_vel, ang_vel=q.quat_rotate(prop.rot, w_body))
    return new, f_ext_h, f_on_h.abs().sum(dim=1)
