"""Imitation evaluation: per-clip success rate and MPJPE metrics over the
whole motion database.

Counterpart of `pulse_tpu/eval/im_eval.py` (≙ phc/learning/im_amp.py:136-363
and im_amp_players.py:59-190): the clips go through the env `batch_size` at
a time from t = 0 under a deterministic policy. A clip fails if the reset
bodies' mean distance to the reference exceeds `termination_distance` at
any scored step. The metrics are MPJPE-g (global), MPJPE-l (root-relative)
and MPJPE-pa (procrustes-aligned, every env and frame), and the velocity
and finite-difference acceleration distances, all in mm.

The JAX scan is a Python loop of `max_steps` env steps; on the card each
step launches K1 and K2 (`HumanoidImEnv.step`), and `reset_to` one K2. The
accumulators stay on the device: one host sync a batch.

The returned per-clip failure mask feeds PMCP reweighting
(`motion_lib.update_hard_sampling_weight`).

With a mesh (`pulse_tpu_torch.parallel`), each rank evaluates its
contiguous batch_size / D ids of every padded batch (the reference's
per-rank eval split under Horovod, im_amp.py:136-242), the failures and
sums are gathered in rank order, and every rank returns the same result.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pulse_tpu_torch.motion.motion_lib import get_motion_state
from pulse_tpu_torch.parallel.mesh import all_gather_rows


@dataclasses.dataclass
class EvalResult:
    success_rate: float
    mpjpe_g: float          # mm
    mpjpe_l: float          # mm
    mpjpe_pa: float         # mm
    vel_dist: float         # mm/frame
    accel_dist: float       # mm/frame^2
    failed_motions: np.ndarray  # [M] bool
    # per-motion means (mm), for per-clip benchmark tables; same
    # accumulators as the aggregate
    per_motion_mpjpe_g: np.ndarray | None = None  # [M]
    per_motion_mpjpe_l: np.ndarray | None = None  # [M]
    # scored (pre-reset, in-clip) steps per motion: a clip of exactly N
    # control steps scores N-1 comparisons, because the env's auto-reset
    # consumes the final one
    per_motion_steps: np.ndarray | None = None  # [M]


def _procrustes_err(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Batched per-frame similarity-transform alignment error on the
    device: pred/gt [..., J, 3] -> [...]. ≙ the p-mpjpe of the reference's
    compute_metrics_lite (im_amp_players.py:147-157), for every env and
    frame."""
    mu_p = pred.mean(dim=-2, keepdim=True)
    mu_g = gt.mean(dim=-2, keepdim=True)
    X = pred - mu_p
    Y = gt - mu_g
    H = X.transpose(-1, -2) @ Y
    U, S, Vt = torch.linalg.svd(H, full_matrices=False)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ Ut))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)   # diag(1, 1, det-sign)
    R = (V * D[..., None, :]) @ Ut
    var_p = torch.sum(X**2, dim=(-1, -2))
    scale = torch.sum(S * D, dim=-1) / torch.clamp(var_p, min=1e-9)
    aligned = scale[..., None, None] * (X @ R.transpose(-1, -2)) + mu_g
    return torch.linalg.vector_norm(aligned - gt, dim=-1).mean(-1)


def _procrustes_aligned_err(pred: np.ndarray, gt: np.ndarray) -> float:
    """Per-frame similarity-transform alignment (host, numpy). [N, J, 3]."""
    errs = []
    for p, g in zip(pred, gt):
        mu_p, mu_g = p.mean(0), g.mean(0)
        pc, gc = p - mu_p, g - mu_g
        H = pc.T @ gc
        U, S, Vt = np.linalg.svd(H)
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        D = np.diag([1.0, 1.0, d])
        R = Vt.T @ D @ U.T
        var_p = (pc**2).sum()
        scale = (S * np.diag(D)).sum() / max(var_p, 1e-9)
        aligned = scale * pc @ R.T + mu_g
        errs.append(np.linalg.norm(aligned - g, axis=-1).mean())
    return float(np.mean(errs)) if errs else 0.0


_SUMS = ("g", "l", "pa", "vel", "acc", "n")


@torch.no_grad()
def _eval_batch(env, policy_fn, motion_ids: torch.Tensor, max_steps: int, termination_distance: float,
                collect_pa: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One batch from t = 0: (failed [B] bool, sums [6, B] in _SUMS order),
    on the device."""
    motion, dev = env.motion, env.device
    B = motion_ids.shape[0]
    state = env.reset_to(motion_ids, torch.zeros(B, device=dev))
    lengths = motion.motion_lengths[motion_ids]
    reset_ids = torch.as_tensor(env.reset_body_ids, dtype=torch.long, device=dev)
    # local clock: clips all start at t = 0, in the env clock's float32
    # arithmetic (start 0 + progress * control_dt)
    clock = torch.arange(1, max_steps + 1, dtype=torch.float32, device=dev) * env.model.config.control_dt
    failed = torch.zeros(B, dtype=torch.bool, device=dev)
    sums = torch.zeros(len(_SUMS), B, device=dev)
    prev_sim = prev_ref = state.physics.body_vel
    for i in range(max_steps):
        state = env.step(state, policy_fn(state.obs))
        t = clock[i].expand(B)
        # STRICT: the env auto-resets on the step whose post-step clock
        # reaches the clip length (`t >= length`), so that state is not scored
        active = t < lengths
        ref = get_motion_state(motion, motion_ids, t)
        body_pos, ref_pos = state.physics.body_pos, ref["rg_pos"]
        track = torch.linalg.vector_norm(body_pos[:, reset_ids] - ref_pos[:, reset_ids], dim=-1).mean(-1)
        failed |= active & (track > termination_distance)

        jpe_g = torch.linalg.vector_norm(body_pos - ref_pos, dim=-1).mean(-1)
        jpe_l = torch.linalg.vector_norm((body_pos - body_pos[:, :1]) - (ref_pos - ref_pos[:, :1]), dim=-1).mean(-1)
        vel = state.physics.body_vel
        vel_d = torch.linalg.vector_norm(vel - ref["body_vel"], dim=-1).mean(-1)
        acc_d = torch.linalg.vector_norm((vel - prev_sim) - (ref["body_vel"] - prev_ref), dim=-1).mean(-1)
        jpe_pa = _procrustes_err(body_pos, ref_pos) if collect_pa else torch.zeros_like(jpe_g)
        # acceleration is not scored at the first step
        acc_d = acc_d if i > 0 else torch.zeros_like(acc_d)
        sums += torch.stack([jpe_g, jpe_l, jpe_pa, vel_d, acc_d, torch.ones_like(acc_d)]) * active
        prev_sim, prev_ref = vel, ref["body_vel"]
    return failed, sums


def im_eval(env, policy_fn, batch_size: int = 64, termination_distance: float = 0.5,
            collect_pa: bool = True, mesh=None) -> EvalResult:
    """policy_fn: obs [B, O] -> deterministic action [B, A]. Pass an env
    with early termination off: its auto-resets would otherwise cut the
    clips short. The last batch is padded with its last clip. With `mesh`,
    each rank steps batch_size / D envs of each batch (ValueError unless
    the mesh size divides batch_size)."""
    motion = env.motion
    M = motion.num_motions
    dt = env.model.config.control_dt
    max_steps = int(np.ceil(float(motion.motion_lengths.max()) / dt))
    if mesh is not None and batch_size % mesh.size:
        raise ValueError(f"im_eval's batch_size ({batch_size}) must be divisible by the mesh size ({mesh.size})")
    bl = batch_size // mesh.size if mesh is not None else batch_size
    lo = mesh.rank * bl if mesh is not None else 0

    failed_all = np.zeros(M, bool)
    per_sums = np.zeros((len(_SUMS), M))
    for start in range(0, M, batch_size):
        ids = np.arange(start, min(start + batch_size, M))
        pad = batch_size - len(ids)
        ids_p = np.concatenate([ids, np.full(pad, ids[-1])]) if pad else ids
        failed, sums = _eval_batch(env, policy_fn, torch.as_tensor(ids_p[lo:lo + bl], device=env.device), max_steps,
                                   termination_distance, collect_pa)
        out = torch.cat([sums, failed[None].to(sums.dtype)])
        if mesh is not None:
            out = all_gather_rows(out, mesh, dim=1)
        host = out.cpu().numpy()[:, : len(ids)]   # the batch's one sync
        per_sums[:, ids] = host[:-1]
        failed_all[ids] = host[-1] > 0

    g, l, pa, vel, acc, n = per_sums
    n_b = np.maximum(n, 1.0)
    n_sum = max(float(n.sum()), 1.0)
    return EvalResult(
        success_rate=float(1.0 - failed_all.mean()),
        mpjpe_g=1000.0 * float(g.sum()) / n_sum,
        mpjpe_l=1000.0 * float(l.sum()) / n_sum,
        mpjpe_pa=1000.0 * float(pa.sum()) / n_sum,
        vel_dist=1000.0 * float(vel.sum()) / n_sum,
        accel_dist=1000.0 * float(acc.sum()) / n_sum,
        failed_motions=failed_all,
        per_motion_mpjpe_g=1000.0 * g / n_b,
        per_motion_mpjpe_l=1000.0 * l / n_b,
        per_motion_steps=n,
    )
