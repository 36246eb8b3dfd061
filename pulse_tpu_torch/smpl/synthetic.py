"""Schema-exact synthetic SMPL model data.

Counterpart of `pulse_tpu/smpl/synthetic.py`. The SMPL release pickles are
licensed and not in the repository, but the shape pipeline (load_smpl_model
-> shaped_joints -> models_from_betas) must run and be testable. This
module writes a pickle with the keys `load_smpl_model` reads, such that at
betas = 0 the regressed rest joints equal the given skeleton's joints, and
beta[0] acts as a stature component (±5%/unit about the pelvis) with
smaller random smooth components behind it. The same generator and seed
give the same bytes as the JAX package's.
"""

from __future__ import annotations

import pickle

import numpy as np

from pulse_tpu_torch.kinematics.skeleton import SkeletonTree
from pulse_tpu_torch.smpl.body_model import SMPL_JOINT_NAMES


def rest_joints(tree: SkeletonTree) -> np.ndarray:
    """Global joint positions of the rest pose (identity rotations)."""
    J = tree.num_joints
    joints = np.zeros((J, 3), np.float64)
    for i in range(J):
        p = int(tree.parent_indices[i])
        base = joints[p] if p >= 0 else 0.0
        joints[i] = base + np.asarray(tree.local_translation[i], np.float64)
    return joints


def synthetic_smpl_data(tree: SkeletonTree, num_surface_verts: int = 256, num_betas: int = 10, seed: int = 0) -> dict:
    """The SMPL pickle dict. The first J vertices are joint anchors (the
    joint regressor selects them exactly), the rest surface vertices hung
    off random bodies. Joints are in SMPL's canonical order
    (SMPL_JOINT_NAMES), as in the release pickles, whatever `tree`'s order."""
    rng = np.random.RandomState(seed)
    J = tree.num_joints
    perm = np.asarray([tree.node_names.index(n) for n in SMPL_JOINT_NAMES[:J]])
    inv = np.empty(J, np.int64)
    inv[perm] = np.arange(J)
    joints = rest_joints(tree)[perm]
    parents = np.asarray([
        -1 if int(tree.parent_indices[orig]) < 0 else int(inv[int(tree.parent_indices[orig])]) for orig in perm
    ])

    surf_body = rng.randint(0, J, num_surface_verts)
    surf_off = rng.uniform(-0.09, 0.09, (num_surface_verts, 3))
    v_template = np.concatenate([joints, joints[surf_body] + surf_off], axis=0)
    V = v_template.shape[0]

    J_regressor = np.zeros((J, V), np.float64)
    J_regressor[np.arange(J), np.arange(J)] = 1.0

    # anchors follow their joint; surface vertices their body, with a
    # little of its parent
    weights = np.zeros((V, J), np.float64)
    weights[np.arange(J), np.arange(J)] = 1.0
    for k, b in enumerate(surf_body):
        p = int(parents[b])
        if p >= 0:
            weights[J + k, b] = 0.8
            weights[J + k, p] = 0.2
        else:
            weights[J + k, b] = 1.0

    # component 0: stature (5%/unit uniform scale about the pelvis); the
    # rest smooth random per-body displacement fields (2 cm/unit)
    shapedirs = np.zeros((V, 3, num_betas), np.float64)
    shapedirs[:, :, 0] = 0.05 * (v_template - joints[0])
    body_of_vert = np.concatenate([np.arange(J), surf_body])
    for s in range(1, num_betas):
        per_body = rng.uniform(-0.02, 0.02, (J, 3))
        shapedirs[:, :, s] = per_body[body_of_vert]

    kintree_table = np.zeros((2, J), np.int64)
    kintree_table[0] = parents
    kintree_table[0, 0] = 2**32 - 1  # the release pickles store uint32(-1)
    kintree_table[1] = np.arange(J)

    # triangles over consecutive surface vertices of one body
    faces = []
    order = np.argsort(surf_body, kind="stable")
    for a, b, c in zip(order[:-2], order[1:-1], order[2:]):
        if surf_body[a] == surf_body[b] == surf_body[c]:
            faces.append((J + a, J + b, J + c))
    faces = np.asarray(faces if faces else np.zeros((0, 3)), np.int64)

    return {"v_template": v_template, "shapedirs": shapedirs, "J_regressor": J_regressor, "weights": weights,
            "kintree_table": kintree_table, "f": faces}


def write_smpl_pickle(path: str, tree: SkeletonTree, **kwargs) -> str:
    with open(path, "wb") as fh:
        pickle.dump(synthetic_smpl_data(tree, **kwargs), fh)
    return path
