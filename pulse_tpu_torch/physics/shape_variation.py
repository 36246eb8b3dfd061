"""Per-env body-shape variation: batched models for shape-varied training.

Counterpart of `pulse_tpu/physics/shape_variation.py` (PHC's
has_shape_variation). The physics Model's array leaves gain a leading env
axis (`physics/model.py`) while the topology stays shared. Two sources:

  * `vary_model_scales`: isotropic per-env scale factors s, drawn from a
    `torch.Generator` (`draw_scales`) and applied by `scale_model`, with
    mass ~ s^3, the spatial-inertia blocks ~ s^5 / s^4 / s^3, gains and
    armature ~ s^2 and lengths ~ s;
  * `models_from_betas`: skeletons from SMPL shape betas (`smpl/`).

Domain randomization's physical props (`env/domain_rand.py`) scale the
leaves of a batched model, or batch a shared one at scale 1 first.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pulse_tpu_torch.physics.model import Model


def draw_scales(generator: torch.Generator, num_envs: int, scale_range=(0.9, 1.1)) -> torch.Tensor:
    """[num_envs] scale factors uniform in scale_range, on the generator's
    device."""
    lo, hi = scale_range
    return lo + (hi - lo) * torch.rand(num_envs, generator=generator, device=generator.device)


def _block_factors(s: torch.Tensor) -> torch.Tensor:
    """[..., 6, 6] per-block factors of the spatial inertia about the body
    origin under an isotropic scale s [...]: A = I_o ~ s^5, B = m c× ~ s^4,
    C = m 1 ~ s^3 (consistent with mass s^3 and com s)."""
    F = s.new_zeros(s.shape + (6, 6))
    s_ = s[..., None, None]
    F[..., :3, :3] = s_ ** 5
    F[..., :3, 3:] = s_ ** 4
    F[..., 3:, :3] = s_ ** 4
    F[..., 3:, 3:] = s_ ** 3
    return F


def scale_model(model: Model, s: torch.Tensor) -> Model:
    """The batched model of a shared `model` under per-env isotropic scale
    factors s [N]. Limits, PD maps and friction are unchanged (broadcast)."""
    N = s.shape[0]

    def b(x, power=1.0):
        return x[None] * (s ** power).reshape((N,) + (1,) * x.dim())

    def bc(x):
        return x.expand((N,) + tuple(x.shape))

    return dataclasses.replace(
        model,
        local_translation=b(model.local_translation),
        body_mass=b(model.body_mass, 3.0),
        body_com=b(model.body_com),
        spatial_inertia=model.spatial_inertia[None] * _block_factors(s)[:, None],
        total_mass=b(model.total_mass, 3.0),
        joint_kp=b(model.joint_kp, 2.0),
        joint_kd=b(model.joint_kd, 2.0),
        joint_armature=b(model.joint_armature, 2.0),
        dof_lower=bc(model.dof_lower),
        dof_upper=bc(model.dof_upper),
        pd_action_offset=bc(model.pd_action_offset),
        pd_action_scale=bc(model.pd_action_scale),
        cp_offset=b(model.cp_offset),
        cp_radius=b(model.cp_radius),
        cp_friction=bc(model.cp_friction),
        **({} if model.cap_p0 is None else
           {"cap_p0": b(model.cap_p0), "cap_p1": b(model.cap_p1), "cap_r": b(model.cap_r)}),
    )


def vary_model_scales(model: Model, num_envs: int, scale_range, generator: torch.Generator) -> Model:
    """Batched model with per-env isotropic scale factors."""
    return scale_model(model, draw_scales(generator, num_envs, scale_range))


# the reference's limb grouping for the limb-weight obs channel
LIMB_WEIGHT_GROUPS = (
    ("L_Hip", "L_Knee", "L_Ankle", "L_Toe"),
    ("R_Hip", "R_Knee", "R_Ankle", "R_Toe"),
    ("Pelvis", "Torso", "Spine", "Chest", "Neck", "Head"),
    ("L_Thorax", "L_Shoulder", "L_Elbow", "L_Wrist", "L_Hand"),
    ("R_Thorax", "R_Shoulder", "R_Elbow", "R_Wrist", "R_Hand"),
)


def limb_weight_params(local_translation: torch.Tensor, body_mass: torch.Tensor, node_names) -> torch.Tensor:
    """Limb-weight obs: summed bone lengths, then summed masses, per limb
    group. [..., J, 3], [..., J] -> [..., 10]."""
    lengths = torch.linalg.vector_norm(local_translation, dim=-1)
    groups = [[list(node_names).index(n) for n in g] for g in LIMB_WEIGHT_GROUPS]
    parts = [lengths[..., ids].sum(-1) for ids in groups] + [body_mass[..., ids].sum(-1) for ids in groups]
    return torch.stack(parts, dim=-1)


def models_from_betas(model: Model, smpl_model, betas: torch.Tensor, node_names) -> Model:
    """Batched model whose per-env skeletons come from SMPL shape betas [N, S]
    (the reference's per-shape SMPL_Robot humanoids, without the XML).

    Bone offsets are the beta-shaped rest joints; masses, inertias and
    contact geometry scale per body by the bone-length ratio s (mass ~ s^3,
    the inertia blocks ~ s^5 / s^4 / s^3, armature ~ s^2); the PD gains scale
    by the total-mass ratio (the reference's pd_scale)."""
    from pulse_tpu_torch.smpl.body_model import SMPL_JOINT_NAMES, shaped_joints

    N = betas.shape[0]
    parents = np.asarray(model.parents)

    joints_smpl = shaped_joints(smpl_model, betas)                        # [N, Js, 3] SMPL order
    joints = joints_smpl[:, [SMPL_JOINT_NAMES.index(n) for n in node_names]]
    parent_pos = joints[:, np.maximum(parents, 0)]
    parent_pos[:, torch.as_tensor(parents < 0, device=joints.device)] = 0.0
    new_local = joints - parent_pos                                       # the root keeps its joint

    base_len = torch.linalg.vector_norm(model.local_translation, dim=-1)  # [J]
    new_len = torch.linalg.vector_norm(new_local, dim=-1)                 # [N, J]
    s = torch.where(base_len > 1e-6, new_len / torch.clamp(base_len, min=1e-6), torch.ones_like(new_len))
    # the root has no bone: it takes the mean of its children's scales
    child = torch.as_tensor(parents == 0, device=s.device)
    s_root = torch.where(child[None], s, torch.zeros_like(s)).sum(dim=1) / max(int(child.sum()), 1)
    s = torch.cat([s_root[:, None], s[:, 1:]], dim=1)

    body_mass = model.body_mass[None] * s ** 3
    total_mass = body_mass.sum(dim=-1)
    pd_scale = total_mass / model.total_mass                              # [N]
    s_cp = s[:, model.cp_body]                                            # [N, P]

    def bc(x):
        return x.expand((N,) + tuple(x.shape))

    return dataclasses.replace(
        model,
        local_translation=new_local,
        body_mass=body_mass,
        body_com=model.body_com[None] * s[..., None],
        spatial_inertia=model.spatial_inertia[None] * _block_factors(s),
        total_mass=total_mass,
        joint_kp=model.joint_kp[None] * pd_scale[:, None],
        joint_kd=model.joint_kd[None] * pd_scale[:, None],
        joint_armature=model.joint_armature[None] * s[:, 1:] ** 2,
        dof_lower=bc(model.dof_lower),
        dof_upper=bc(model.dof_upper),
        pd_action_offset=bc(model.pd_action_offset),
        pd_action_scale=bc(model.pd_action_scale),
        cp_offset=model.cp_offset[None] * s_cp[..., None],
        cp_radius=model.cp_radius[None] * s_cp,
        cp_friction=bc(model.cp_friction),
    )
