"""The strike task: knock over a target box, batched over envs.

Counterpart of `pulse_tpu/env/humanoid_strike.py` (PHC's HumanoidStrike):
a free box (`physics/prop.py`, 0.5 x 0.5 x 1.8 m) spawns 1.2-2.5 m from the
humanoid, mostly in front of it; the humanoid and the box step together
with two-way contact (`physics_step_with_prop`, plain PyTorch: no kernel
covers the coupled step, as no TPU kernel does). The task obs (15) is the
box's position (its height absolute), rotation (tan-norm), velocity and
angular velocity in the heading frame; the reward is 0.6 of the tip term
(1 - the box's up-axis cosine) and 0.4 of the approach term (the root's
speed toward the box, against 1 m/s), and 1 once the box has tipped
(cosine < 0.2). Like the JAX package's, the step has its own bookkeeping:
the root position before the step rides in the task state for the
approach term, the fall check is on flat ground, no task update, no
power penalty.
"""

from __future__ import annotations

import math

import torch

from pulse_tpu_torch.env import kernels
from pulse_tpu_torch.env.humanoid_im import _select
from pulse_tpu_torch.env.humanoid_task import HumanoidTaskEnv, TaskEnvState
from pulse_tpu_torch.ops import quat as q
from pulse_tpu_torch.physics.prop import PropSpec, make_prop_state
from pulse_tpu_torch.physics.state import PhysicsState
from pulse_tpu_torch.physics.step import physics_step_with_prop

STRIKE_BODIES = ("R_Hand", "L_Hand", "R_Wrist", "L_Wrist", "R_Elbow", "L_Elbow")


class HumanoidStrikeEnv(HumanoidTaskEnv):
    """Knock over a target box. The task state: "prop" (the box's
    PropState), "prop_contact" (its substep-mean contact force [B, 3]) and
    "prev_root_pos" ([B, 3], the root before the step)."""

    task_obs_dim = 15   # 3 pos + 6 rot + 3 vel + 3 ang vel
    reward_raw_dim = 2  # tip term, approach term
    kernel_step = False  # the coupled step is plain PyTorch

    def __init__(self, model, motion, config=None, device=None, seed: int = 0, prop_spec: PropSpec | None = None,
                 strike_bodies=STRIKE_BODIES):
        super().__init__(model, motion, config, device=device, seed=seed)
        self.prop_spec = prop_spec or PropSpec()
        self.strike_bodies = tuple(strike_bodies)

    def _ctor_kwargs(self) -> dict:
        return {"prop_spec": self.prop_spec, "strike_bodies": self.strike_bodies}

    def _sample_task(self, n: int) -> dict:
        return {"theta": self._uniform(n, -math.pi, math.pi), "dist": self._uniform(n, 1.2, 2.5)}

    def _reset_task(self, draws: dict, physics: PhysicsState) -> dict:
        ang = q.calc_heading(physics.root_rot) + draws["theta"] * 0.35   # mostly in front
        xy = physics.root_pos[:, 0:2] + draws["dist"][:, None] * torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
        z = torch.full_like(xy[:, :1], self.prop_spec.half_extents[2])
        return {"prop": make_prop_state(torch.cat([xy, z], dim=-1)), "prop_contact": torch.zeros_like(physics.root_pos),
                "prev_root_pos": physics.root_pos}

    def _task_obs(self, state: TaskEnvState) -> torch.Tensor:
        ph, prop = state.physics, state.task["prop"]
        heading_inv = q.calc_heading_quat_inv(ph.root_rot)
        local_pos = torch.cat([prop.pos[:, 0:2] - ph.root_pos[:, 0:2], prop.pos[:, 2:3]], dim=-1)  # absolute height
        return torch.cat([q.quat_rotate(heading_inv, local_pos), q.quat_to_tan_norm(q.quat_mul(heading_inv, prop.rot)),
                          q.quat_rotate(heading_inv, prop.lin_vel), q.quat_rotate(heading_inv, prop.ang_vel)], dim=-1)

    def _task_reward(self, prev: TaskEnvState, state: TaskEnvState) -> tuple[torch.Tensor, torch.Tensor]:
        """PHC's compute_strike_reward on the stepped box, the approach speed
        from the finite difference of the root since `prev`."""
        prop = state.task["prop"]
        up = torch.zeros_like(prop.pos)
        up[:, 2] = 1.0
        tar_rot_err = torch.sum(up * q.quat_rotate(prop.rot, up), dim=-1)
        tar_rot_r = torch.clamp(1.0 - tar_rot_err, min=0.0)
        root_pos = state.physics.root_pos
        tar_dir = prop.pos[:, 0:2] - root_pos[:, 0:2]
        tar_dir = tar_dir / torch.clamp(torch.linalg.vector_norm(tar_dir, dim=-1, keepdim=True), min=1e-6)
        root_vel = (root_pos - prev.physics.root_pos) / self.model.config.control_dt
        tar_dir_speed = torch.sum(tar_dir * root_vel[:, 0:2], dim=-1)
        vel_err = torch.clamp(1.0 - tar_dir_speed, min=0.0)
        vel_r = torch.where(tar_dir_speed <= 0, 0.0, torch.exp(-4.0 * vel_err * vel_err))
        reward = torch.where(tar_rot_err < 0.2, 1.0, 0.6 * tar_rot_r + 0.4 * vel_r)
        return reward, torch.stack([tar_rot_r, vel_r], dim=-1)

    def step(self, state: TaskEnvState, actions: torch.Tensor) -> TaskEnvState:
        """The coupled control step, the reward against the root before the
        step, the fall check, the AMP history roll, the observation, then the
        auto-reset merge."""
        cfg, B = self.config, actions.shape[0]
        pd_target = self.action_to_pd_target(actions)
        physics, prop, prop_contact = physics_step_with_prop(self.model, self.prop_spec, state.physics,
                                                             state.task["prop"], pd_target)
        progress = state.progress + 1
        stepped = state.replace(physics=physics, progress=progress,
                                task={"prop": prop, "prop_contact": prop_contact, "prev_root_pos": physics.root_pos})
        prev = state.replace(physics=state.physics.replace(root_pos=state.task["prev_root_pos"]))
        reward, reward_raw = self._task_reward(prev, stepped)
        reset, terminate = kernels.compute_humanoid_reset(
            progress, physics.contact_force, physics.body_pos, self.non_contact_body_ids, cfg.termination_height,
            cfg.episode_length, enable_early_termination=cfg.enable_early_termination)
        stepped = stepped.replace(amp_hist=torch.cat([self._amp_row(physics)[:, None], state.amp_hist[:, :-1]], dim=1))
        stepped = stepped.replace(obs=self._observe(stepped))
        merged = _select(reset, self.reset(B), stepped)
        return merged.replace(reward=reward, reward_raw=reward_raw, done=reset, terminate=terminate)
