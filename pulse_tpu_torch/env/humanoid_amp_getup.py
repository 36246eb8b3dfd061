"""The pure-AMP envs: style-reward locomotion, with and without fall recovery.

Counterpart of `pulse_tpu/env/humanoid_amp_getup.py` (PHC's HumanoidAMP
and HumanoidAMPGetup): the policy observes only its self obs (no imitation
task obs), the env's reward is the constant 1 (the AMP agent's mix adds
the discriminator's style reward), and termination is the generic
contact-based fall check (`kernels.compute_humanoid_reset`) instead of the
distance to the reference. The getup variant keeps HumanoidImGetup's
fall-state resets and recovery grace.

On the kernels' surface the step is K3 → RA (the termination is
overridden, so K1 does not apply): RA's AMP row is kept, its reward and
distances are discarded, and the observation is the self obs in plain
PyTorch, so K2 never runs, at the reset either. Off the surface (self obs
v2 or v3) `_step_general` observes through the same self obs. The env's
kernel constants (`consts`) are the imitation env's: RA reads only its key
and reset bodies, flags and reward weights, none of which change here.
"""

from __future__ import annotations

import torch

from pulse_tpu_torch.env import kernels
from pulse_tpu_torch.env.humanoid_im import EnvState, HumanoidImEnv
from pulse_tpu_torch.env.humanoid_im_getup import HumanoidImGetupEnv

FOOT_BODIES = ("L_Ankle", "R_Ankle", "L_Toe", "R_Toe")   # may touch the ground


class _AMPSurfaceMixin:
    """The AMP envs' observation, reward and fall check over an imitation
    env."""

    def _init_amp_surface(self, termination_height: float) -> None:
        self.task_obs_dim = 0
        self.obs_dim = self.self_obs_dim
        self.termination_height = float(termination_height)
        self.non_contact_body_ids = torch.as_tensor(
            [i for i, n in enumerate(self.body_names) if n not in FOOT_BODIES], dtype=torch.long, device=self.device)

    def _ctor_kwargs(self) -> dict:
        return {"termination_height": self.termination_height}

    def _observe(self, state: EnvState) -> torch.Tensor:
        """The self obs: the history, newest first, for v2, else one frame."""
        if self.config.self_obs_v == 2:
            return state.self_obs_hist.flatten(1)
        return self._self_obs_single(state.physics)

    _observe_general = _observe

    def _finish_step(self, *args, **kwargs) -> EnvState:
        out = super()._finish_step(*args, **kwargs)
        return out.replace(reward=torch.ones_like(out.reward), reward_raw=torch.ones_like(out.reward_raw))

    def _fallen(self, state: EnvState) -> torch.Tensor:
        cfg = self.config
        return kernels.compute_humanoid_reset(
            state.progress, state.physics.contact_force, state.physics.body_pos, self.non_contact_body_ids,
            self.termination_height, cfg.episode_length, enable_early_termination=cfg.enable_early_termination)[1]


class HumanoidAMPEnv(_AMPSurfaceMixin, HumanoidImEnv):
    """Plain AMP env: reference-state-init resets, no getup curriculum."""

    def __init__(self, model, motion, config=None, device=None, seed: int = 0, termination_height: float = 0.15):
        super().__init__(model, motion, config, device=device, seed=seed)
        self._init_amp_surface(termination_height)

    def _termination(self, state, dist_mean, dist_max, pass_time):
        """A fall, the clip's end or the episode's last step; the distances
        to the reference are not read."""
        terminate = self._fallen(state)
        return pass_time | (state.progress >= self.config.episode_length - 1) | terminate, terminate


class HumanoidAMPGetupEnv(_AMPSurfaceMixin, HumanoidImGetupEnv):
    """AMP + fall-state resets + recovery grace; `grace_holds` counts the
    falls the grace window held back."""

    def __init__(self, model, motion, config=None, device=None, seed: int = 0, termination_height: float = 0.15):
        super().__init__(model, motion, config, device=device, seed=seed)
        self._init_amp_surface(termination_height)

    def _termination(self, state, dist_mean, dist_max, pass_time):
        terminate = self._fallen(state)
        in_grace = state.progress < state.recovery_counter
        self.grace_holds += (terminate & in_grace).sum()
        terminate = terminate & ~in_grace
        return pass_time | (state.progress >= self.config.episode_length - 1) | terminate, terminate
