"""Asset and DOF inspection: print the humanoid's bodies, joints, limits,
masses and gains, and sweep every DOF through its range kinematically.

Counterpart of `scripts/joint_monkey.py` (≙ the reference's
joint_monkey_smpl.py Isaac Gym demo, headless): the table replaces the
property panel, and the sweep is dumped as FK body positions (.npz).

    python -m pulse_tpu_torch.scripts.joint_monkey                 # the asset table
    python -m pulse_tpu_torch.scripts.joint_monkey --sweep out.npz [--frames-per-dof 20]
        [--device cpu]

The sweep's FK runs on `--device`, the card unless named.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pulse_tpu_torch.assets import load_smpl_humanoid


def print_asset(spec) -> None:
    tree = spec.skeleton
    print(f"bodies: {spec.num_bodies}  joints: {spec.num_joints}  dof: {spec.num_dof}")
    print(f"total mass: {spec.body_mass.sum():.2f} kg")
    print(f"{'body':<12} {'parent':<12} {'mass':>7} {'offset':>24}")
    for i, name in enumerate(tree.node_names):
        p = int(tree.parent_indices[i])
        parent = tree.node_names[p] if p >= 0 else "-"
        off = np.array2string(np.asarray(tree.local_translation[i]), precision=3, suppress_small=True)
        print(f"{name:<12} {parent:<12} {spec.body_mass[i]:>7.3f} {off:>24}")
    print(f"\n{'joint':<12} {'axis':>4} {'lower':>8} {'upper':>8} {'kp':>8} {'kd':>7}")
    for j, name in enumerate(tree.node_names[1:]):
        for a, ax in enumerate("xyz"):
            d = 3 * j + a
            print(f"{name if a == 0 else '':<12} {ax:>4} "
                  f"{spec.dof_lower[d]:>8.3f} {spec.dof_upper[d]:>8.3f} "
                  f"{spec.joint_stiffness[j]:>8.1f} {spec.joint_damping[j]:>7.1f}")


def sweep_dofs(spec, frames_per_dof: int, out: str | None = None, device=None) -> dict:
    """The joint_monkey sweep through FK on `device` -> {body_pos [T, J, 3],
    body_rot [T, J, 4]} (numpy), written to `out` (.npz) when given."""
    from pulse_tpu_torch._device import resolve_device
    from pulse_tpu_torch.kinematics.skeleton import forward_kinematics
    from pulse_tpu_torch.ops import quat as q

    D = spec.num_dof
    T = D * frames_per_dof
    dof = np.zeros((T, D), np.float32)
    phase = np.linspace(0, 2 * np.pi, frames_per_dof, endpoint=False)
    for d in range(D):   # each DOF in turn by a sine about the middle of its range
        lo, hi = float(spec.dof_lower[d]), float(spec.dof_upper[d])
        mid, amp = 0.5 * (hi + lo), 0.5 * (hi - lo)
        dof[d * frames_per_dof: (d + 1) * frames_per_dof, d] = mid + amp * np.sin(phase)
    device = resolve_device(device)
    dof = torch.as_tensor(dof, device=device)
    root = torch.tensor([0, 0, 0, 1.0], device=device).expand(T, 1, 4)
    local = torch.cat([root, q.exp_map_to_quat(dof.reshape(T, -1, 3))], dim=1)
    g_rot, g_pos = forward_kinematics(spec.skeleton, local, torch.tensor([0.0, 0.0, 0.95], device=device).expand(T, 3))
    res = {"body_pos": g_pos.cpu().numpy(), "body_rot": g_rot.cpu().numpy()}
    if out:
        np.savez_compressed(out, **res, fps=30.0, names=np.asarray(spec.skeleton.node_names))
        print(f"wrote {T} sweep frames -> {out}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", default="")
    ap.add_argument("--frames-per-dof", type=int, default=20)
    ap.add_argument("--device", default=None, help="the sweep's FK device (default: the card)")
    args = ap.parse_args(argv)
    spec = load_smpl_humanoid()
    print_asset(spec)
    if args.sweep:
        return sweep_dofs(spec, args.frames_per_dof, args.sweep, args.device)


if __name__ == "__main__":
    main()
