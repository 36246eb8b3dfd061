"""The SMPL body model's shape half: shaped rest-pose joints from betas.

Counterpart of the part of `pulse_tpu/smpl/body_model.py` that per-env
shape variation needs (`physics/shape_variation.py:models_from_betas`):
the joint names, the model data of a SMPL release pickle
(SMPL_{NEUTRAL,MALE,FEMALE}.pkl, not shipped with the repository; a
synthetic one comes from `smpl/synthetic.py`) and `shaped_joints`.
Linear blend skinning and the ground-height fix are not ported yet.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch

SMPL_JOINT_NAMES = (
    "Pelvis", "L_Hip", "R_Hip", "Torso", "L_Knee", "R_Knee", "Spine",
    "L_Ankle", "R_Ankle", "Chest", "L_Toe", "R_Toe", "Neck", "L_Thorax",
    "R_Thorax", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow",
    "L_Wrist", "R_Wrist", "L_Hand", "R_Hand",
)
# (SMPL's Spine1/Spine2/Spine3/Foot/Collar under the MJCF humanoid's
# Torso/Spine/Chest/Toe/Thorax names, the reference's convention)


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
