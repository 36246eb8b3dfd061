"""The SMPL body model: shaped rest-pose joints and linear blend skinning.

Counterpart of `pulse_tpu/smpl/body_model.py`: the joint names, the model
data of a SMPL release pickle (SMPL_{NEUTRAL,MALE,FEMALE}.pkl, not shipped
with the repository; a synthetic one comes from `smpl/synthetic.py`),
`shaped_joints` (per-env shape variation, `physics/shape_variation.py`),
and batched `lbs`, `ground_height_offset` and `GenderedSMPL` (the
ground-height fix of the AMASS conversion scripts, ≙ the reference's
MotionLibSMPL.fix_trans_height, motion_lib_smpl.py:46-99).
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch

from pulse_tpu_torch.ops import quat as q

SMPL_JOINT_NAMES = (
    "Pelvis", "L_Hip", "R_Hip", "Torso", "L_Knee", "R_Knee", "Spine",
    "L_Ankle", "R_Ankle", "Chest", "L_Toe", "R_Toe", "Neck", "L_Thorax",
    "R_Thorax", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow",
    "L_Wrist", "R_Wrist", "L_Hand", "R_Hand",
)
# (SMPL's Spine1/Spine2/Spine3/Foot/Collar under the MJCF humanoid's
# Torso/Spine/Chest/Toe/Thorax names, the reference's convention)

# a gender's code: the body model it picks, and the first entry of a clip's
# shape row (convert_amass_isaac.py, motion_lib_smpl.py:121-128)
GENDER_CODE = {"neutral": 0, "male": 1, "female": 2}


@dataclasses.dataclass(frozen=True)
class SMPLModel:
    v_template: np.ndarray     # [V, 3]
    shapedirs: np.ndarray      # [V, 3, S]
    J_regressor: np.ndarray    # [J, V]
    weights: np.ndarray        # [V, J]
    parents: np.ndarray        # [J]
    faces: np.ndarray | None = None  # [F, 3] triangles ('f' in the pickle)

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]


def load_smpl_model(path: str) -> SMPLModel:
    """Load a SMPL release pickle (chumpy arrays converted). Pickles can run
    code when loaded: load only files from a trusted source."""
    with open(path, "rb") as fh:
        data = pickle.load(fh, encoding="latin1")

    def arr(x):
        return np.asarray(x, np.float64) if not hasattr(x, "r") else np.asarray(x.r, np.float64)

    J_regressor = data["J_regressor"]
    if hasattr(J_regressor, "toarray"):
        J_regressor = J_regressor.toarray()
    # release pickles store the root's parent as uint32(-1) = 4294967295
    parents = np.asarray(data["kintree_table"][0], np.int64)[:24]
    return SMPLModel(
        v_template=arr(data["v_template"]),
        shapedirs=np.asarray(arr(data["shapedirs"])[:, :, :10]),
        J_regressor=np.asarray(J_regressor),
        weights=arr(data["weights"]),
        parents=np.where(parents >= 2**31, -1, parents),
        faces=np.asarray(data["f"], np.int64) if data.get("f") is not None else None,
    )


def shaped_joints(model: SMPLModel, betas: torch.Tensor) -> torch.Tensor:
    """Rest-pose joint positions for shape betas [..., S] -> [..., J, 3]
    float32 on betas' device. The joint regressor is linear, so it is applied
    to the template and the shape directions once, in float64, and the
    betas then weigh [J, 3, S] directions instead of [V, 3, S]."""
    dev = betas.device
    Jr = torch.as_tensor(model.J_regressor, dtype=torch.float64)
    j0 = Jr @ torch.as_tensor(model.v_template, dtype=torch.float64)                        # [J, 3]
    jdirs = torch.einsum("jv,vds->jds", Jr, torch.as_tensor(model.shapedirs, dtype=torch.float64))
    out = j0.to(dev) + torch.einsum("jds,...s->...jd", jdirs.to(dev), betas.to(torch.float64))
    return out.to(torch.float32)


def lbs(model: SMPLModel, betas: torch.Tensor, pose_quat: torch.Tensor,
        trans: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Linear blend skinning of a batch of poses: betas [B, S] or [S],
    pose_quat [B, J, 4] xyzw local joint rotations in SMPL order, trans
    [B, 3] -> (vertices [B, V, 3], joints [B, J, 3]), in pose_quat's dtype
    and on its device. A vertex is sum_j w_vj (R_j (v - j_rest) + j_world),
    computed as (sum_j w_vj R_j) v + sum_j w_vj (j_world - R_j j_rest), so
    that no [B, V, J, 3] tensor is formed."""
    dt, dev = pose_quat.dtype, pose_quat.device

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    B, J = pose_quat.shape[0], model.num_joints
    betas = betas.to(dt).expand(B, -1)
    v_shaped = t(model.v_template) + torch.einsum("vds,bs->bvd", t(model.shapedirs), betas)       # [B, V, 3]
    joints = torch.einsum("jv,bvd->bjd", t(model.J_regressor), v_shaped)                        # [B, J, 3]

    # world transforms down the chain (SMPL parents precede their children)
    g_rot, g_pos = [pose_quat[:, 0]], [joints[:, 0]]
    for i in range(1, J):
        p = int(model.parents[i])
        g_rot.append(q.quat_mul_norm(g_rot[p], pose_quat[:, i]))
        g_pos.append(g_pos[p] + q.quat_rotate(g_rot[p], joints[:, i] - joints[:, p]))
    g_rot, g_pos = torch.stack(g_rot, 1), torch.stack(g_pos, 1)

    # R_j as matrices: column k is R_j e_k
    eye = torch.eye(3, dtype=dt, device=dev)
    rot = q.quat_rotate(g_rot[:, :, None, :].expand(B, J, 3, 4), eye.expand(B, J, 3, 3)).transpose(-1, -2)
    w = t(model.weights)                                                                        # [V, J]
    offset = g_pos - (rot @ joints[..., None])[..., 0]                                          # [B, J, 3]
    blend = torch.einsum("vj,bjxk->bvxk", w, rot)                                               # [B, V, 3, 3]
    verts = (blend @ v_shaped[..., None])[..., 0] + torch.einsum("vj,bjx->bvx", w, offset)
    return verts + trans[:, None, :].to(dt), g_pos + trans[:, None, :].to(dt)


def ground_height_offset(model: SMPLModel, betas: torch.Tensor, pose_quat: torch.Tensor,
                         trans: torch.Tensor) -> torch.Tensor:
    """[B] vertical offsets putting each pose's lowest LBS vertex on the
    ground (≙ MotionLibSMPL.fix_trans_height, motion_lib_smpl.py:72-99)."""
    verts, _ = lbs(model, betas, pose_quat, trans)
    return -verts[..., 2].amin(dim=1)


def ground_offsets(models: list, betas: np.ndarray, pose_quat: np.ndarray, trans: np.ndarray,
                   device) -> np.ndarray:
    """[N] `ground_height_offset`s of N poses (betas [N, S], pose_quat
    [N, J, 4] in SMPL order, trans [N, 3]), pose i under body model
    models[i]: one batched LBS on `device` for each distinct model, in
    float32 (the scripts' ground-height fix)."""
    out = np.empty(len(models))
    groups: dict[int, tuple] = {}
    for i, m in enumerate(models):
        groups.setdefault(id(m), (m, []))[1].append(i)
    for model, idx in groups.values():
        def put(x):
            return torch.from_numpy(np.asarray(x, np.float32)[idx]).to(device)

        out[idx] = ground_height_offset(model, put(betas), put(pose_quat), put(trans)).cpu().numpy()
    return out


@dataclasses.dataclass(frozen=True)
class GenderedSMPL:
    """Gendered model triple (≙ MotionLibSMPL's smpl_parser_{n,m,f},
    motion_lib_smpl.py:46-70): the body model of a clip's gender for the
    ground-height fix; a missing gendered model falls back to neutral."""

    neutral: SMPLModel
    male: SMPLModel | None = None
    female: SMPLModel | None = None

    @classmethod
    def load(cls, data_dir: str) -> "GenderedSMPL":
        """SMPL_{NEUTRAL,MALE,FEMALE}.pkl from a directory (the reference's
        data/smpl layout); the neutral one must be there."""
        def maybe(name):
            p = os.path.join(data_dir, name)
            return load_smpl_model(p) if os.path.exists(p) else None

        neutral = maybe("SMPL_NEUTRAL.pkl")
        if neutral is None:
            raise FileNotFoundError(f"{data_dir}/SMPL_NEUTRAL.pkl")
        return cls(neutral=neutral, male=maybe("SMPL_MALE.pkl"), female=maybe("SMPL_FEMALE.pkl"))

    def for_gender(self, gender) -> SMPLModel:
        if isinstance(gender, str):
            gender = GENDER_CODE.get(gender, 0)
        return {0: self.neutral, 1: self.male or self.neutral, 2: self.female or self.neutral}[int(gender)]
