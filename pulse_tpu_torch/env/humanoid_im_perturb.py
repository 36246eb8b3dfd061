"""Projectile perturbations: fault injection during imitation.

Counterpart of `pulse_tpu/env/humanoid_im_perturb.py` (the reference's
projectiles): every env has a small dense box (`physics/prop.py`) with full
two-way contact, relaunched every `proj_interval` control steps from a
random direction at `proj_distance` from the pelvis and a random height,
aimed at the torso at a random speed. The projectile survives the env's
auto-resets. A library API, as in the JAX package:

    env = HumanoidImPerturbEnv(model, motion, PerturbConfig(), device="cuda")
    state, prop = env.reset(num_envs)
    state, prop = env.step((state, prop), actions)

The step is isaac_pd coupled with the prop (`step.physics_step_with_prop`,
plain PyTorch, as the JAX package's XLA), then the general finish step; it
takes no DR action noise and no `motor_actions` hook, as the JAX
package's. `prop_contact` holds the last step's substep-mean force on each
env's prop [B, 3].
"""

from __future__ import annotations

import dataclasses
import math

import torch

from pulse_tpu_torch.env.humanoid_im import EnvConfig, EnvState, HumanoidImEnv, _select
from pulse_tpu_torch.physics.prop import PropSpec, PropState
from pulse_tpu_torch.physics.step import physics_step_with_prop


@dataclasses.dataclass(frozen=True)
class PerturbConfig(EnvConfig):
    proj_interval: int = 60          # control steps between launches
    proj_speed_min: float = 5.0
    proj_speed_max: float = 12.0
    proj_distance: float = 2.0       # launch distance from the pelvis (m, XY)
    proj_half_extents: tuple = (0.06, 0.06, 0.06)
    proj_density: float = 400.0


class HumanoidImPerturbEnv(HumanoidImEnv):
    def __init__(self, model, motion, config: PerturbConfig | None = None, device=None, seed: int = 0):
        super().__init__(model, motion, config or PerturbConfig(), device=device, seed=seed)
        cfg = self.config
        self.proj_spec = PropSpec(half_extents=cfg.proj_half_extents, density=cfg.proj_density, friction=0.5)
        self.prop_contact: torch.Tensor | None = None

    def _launch_draws(self, n: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(heading angle in [-pi, pi), height in [0.6, 1.6), speed in
        [proj_speed_min, proj_speed_max)) [n] each, from the env's
        generator."""
        cfg = self.config
        u = torch.rand(3, n, generator=self.generator, device=self.device)
        return (-math.pi + 2.0 * math.pi * u[0], 0.6 + u[1],
                cfg.proj_speed_min + (cfg.proj_speed_max - cfg.proj_speed_min) * u[2])

    def _launch(self, root_pos: torch.Tensor) -> PropState:
        """Fresh projectiles [B] around the roots `root_pos` [B, 3], flying
        at the point over each root at a height of 0.9 m."""
        cfg = self.config
        theta, height, speed = self._launch_draws(root_pos.shape[0])
        pos = torch.stack([root_pos[:, 0] + cfg.proj_distance * torch.cos(theta),
                           root_pos[:, 1] + cfg.proj_distance * torch.sin(theta), height], dim=-1)
        target = torch.cat([root_pos[:, :2], torch.full_like(root_pos[:, 2:], 0.9)], dim=-1)
        d = target - pos
        vel = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-6) * speed[:, None]
        rot = torch.zeros(pos.shape[0], 4, device=self.device)
        rot[:, 3] = 1.0
        return PropState(pos=pos, rot=rot, lin_vel=vel, ang_vel=torch.zeros_like(pos))

    def reset(self, num_envs: int) -> tuple[EnvState, PropState]:
        state = super().reset(num_envs)
        return state, self._launch(state.physics.root_pos)

    def step(self, carry: tuple[EnvState, PropState], actions: torch.Tensor) -> tuple[EnvState, PropState]:
        """One control step of the humanoids with their projectiles; an env
        whose pre-step progress is proj_interval - 1 (mod proj_interval)
        relaunches its projectile, aimed from the stepped root."""
        state, prop = carry
        cfg = self.config
        pd_target = self.action_to_pd_target(actions)
        physics, prop, self.prop_contact = physics_step_with_prop(self.model, self.proj_spec, state.physics, prop,
                                                                  pd_target)
        out = self._finish_general(state, physics, pd_target)
        relaunch = state.progress % cfg.proj_interval == cfg.proj_interval - 1
        return out, _select(relaunch, self._launch(physics.root_pos), prop)
