"""HumanoidImGetup: the fall-state recovery curriculum for imitation training.

Counterpart of `pulse_tpu/env/humanoid_im_getup.py` (PHC's getup
curriculum, with which PULSE trained its imitator): with probability
`fall_init_prob` a reset puts the humanoid into a crumpled fall state, and
such episodes, and a `recovery_episode_prob` share of the others, get
`recovery_steps` of termination grace to get up and re-acquire the motion.

The fall states are made once, when the env is built: random poses dropped
from `fall_drop_height` and run for `fall_settle_steps` control steps as a
ragdoll (gains off, light damping). On the card those steps are K3
launches at B = `num_fall_states` (plain steps with `use_pallas_physics`
false or on a model outside the kernel's surface). Because this env overrides termination
and reset, its step runs K3 → RA instead of K1 (`HumanoidImEnv.step`).
"""

from __future__ import annotations

import dataclasses

import torch

from pulse_tpu_torch.env.humanoid_im import EnvConfig, EnvState, HumanoidImEnv, _select
from pulse_tpu_torch.ops import quat as q
from pulse_tpu_torch.physics import substep_cuda
from pulse_tpu_torch.physics.state import PhysicsState, refresh_kinematics, state_from_kinematics
from pulse_tpu_torch.physics.step import physics_step

FALL_STATE_SEED = 42   # the JAX package draws its fall poses from PRNGKey(42)


@dataclasses.dataclass(frozen=True)
class GetupConfig(EnvConfig):
    recovery_steps: int = 90              # termination grace, control steps
    recovery_episode_prob: float = 0.3
    fall_init_prob: float = 0.1
    num_fall_states: int = 256
    fall_drop_height: float = 0.9
    fall_settle_steps: int = 60


def ragdoll(model):
    """The fall-state drop's model: gains off so that the body crumples
    instead of fighting toward the zero pose; a small kd keeps the joints
    from flailing."""
    return dataclasses.replace(model, joint_kp=torch.zeros_like(model.joint_kp),
                               joint_kd=torch.full_like(model.joint_kd, 5.0))


def fall_drop_start(model, n: int, drop_height: float, device) -> PhysicsState:
    """The drop's first state: [n] random poses at rest at `drop_height`
    (drawn from FALL_STATE_SEED), lifted so that no contact point starts
    inside the ground (a buried limb would see kN forces and launch the
    body)."""
    g = torch.Generator(device=device).manual_seed(FALL_STATE_SEED)
    root_rot = q.quat_unit(torch.randn(n, 4, generator=g, device=device))
    dof = torch.clamp(0.4 * torch.randn(n, model.num_dof, generator=g, device=device), model.dof_lower, model.dof_upper)
    root_pos = torch.tensor([0.0, 0.0, drop_height], device=device).expand(n, 3)
    zero3 = torch.zeros(n, 3, device=device)
    st = state_from_kinematics(model, root_pos, root_rot, dof, zero3, zero3, torch.zeros_like(dof))
    p = st.body_pos[:, model.cp_body] + q.quat_rotate(st.body_rot[:, model.cp_body], model.cp_offset)
    lowest = (p[..., 2] - model.cp_radius).amin(dim=1)
    lift = torch.zeros_like(zero3)
    lift[:, 2] = torch.clamp(0.02 - lowest, min=0.0)
    return st.replace(root_pos=st.root_pos + lift, body_pos=st.body_pos + lift[:, None])


class HumanoidImGetupEnv(HumanoidImEnv):
    """HumanoidIm + fall-state resets + a termination grace window.

    `fall_resets` and `grace_holds` count, on the device and since the env
    was built, the resets that drew a fall state and the terminations the
    grace window held back."""

    def __init__(self, model, motion, config: GetupConfig | None = None, device=None, seed: int = 0):
        super().__init__(model, motion, config or GetupConfig(), device=device, seed=seed)
        cfg = self.config
        self._getup_targets = (cfg.recovery_episode_prob, cfg.fall_init_prob)
        self.fall_resets = torch.zeros((), dtype=torch.long, device=self.device)
        self.grace_holds = torch.zeros((), dtype=torch.long, device=self.device)
        self.fall_states = self._generate_fall_states()

    def _generate_fall_states(self) -> PhysicsState:
        """[num_fall_states] ragdolls after the drop, velocities zeroed and
        world bodies refreshed. As in the JAX package, the settle does not
        bring every body to rest on the ground (ROADMAP queue 3)."""
        cfg, m = self.config, self.model
        st = fall_drop_start(m, cfg.num_fall_states, cfg.fall_drop_height, self.device)
        rag = ragdoll(m)
        pd = torch.zeros(cfg.num_fall_states, m.num_dof, device=self.device)
        kernel = substep_cuda.route(m, cfg.use_pallas_physics) == "kernel"
        step = substep_cuda.physics_step_cuda if kernel else physics_step
        for _ in range(cfg.fall_settle_steps):
            st = step(rag, st, pd)
        st = st.replace(root_vel6=torch.zeros_like(st.root_vel6), joint_omega=torch.zeros_like(st.joint_omega))
        return refresh_kinematics(m, st)

    def enable_shape_variation(self, *args, **kwargs) -> None:
        raise NotImplementedError("shape variation with HumanoidImGetup is not ported yet (ROADMAP queue 1, item 12)")

    def set_getup_phase(self, past_schedule: bool) -> bool:
        """Before the schedule epoch every episode starts from a fall state
        with no recovery-episode grace; after it the configured
        probabilities apply. Returns whether the config changed."""
        rec, fall = self._getup_targets if past_schedule else (0.0, 1.0)
        cfg = self.config
        if cfg.recovery_episode_prob == rec and cfg.fall_init_prob == fall:
            return False
        self.config = dataclasses.replace(cfg, recovery_episode_prob=rec, fall_init_prob=fall)
        return True

    # ------------------------------------------------------------------ #

    def _sample_getup(self, n: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(start from a fall state [n] bool, fall-state index [n] long,
        recovery grace for a non-fall episode [n] bool)."""
        cfg, g, dev = self.config, self.generator, self.device
        use_fall = torch.rand(n, generator=g, device=dev) < cfg.fall_init_prob
        idx = torch.randint(0, cfg.num_fall_states, (n,), generator=g, device=dev)
        recover = torch.rand(n, generator=g, device=dev) < cfg.recovery_episode_prob
        return use_fall, idx, recover

    def _reset_states(self, mask: torch.Tensor) -> EnvState:
        base = super()._reset_states(mask)
        use_fall, idx, recover = self._sample_getup(mask.shape[0])
        fall = PhysicsState(**{f.name: getattr(self.fall_states, f.name)[idx]
                               for f in dataclasses.fields(PhysicsState)})
        self.fall_resets += (use_fall & mask).sum()
        # a fall episode always gets the grace window, another one by chance;
        # clip, start time and AMP window stay the reference-state init's
        counter = torch.where(use_fall | recover, self.config.recovery_steps, 0).to(torch.int32)
        return base.replace(physics=_select(use_fall, fall, base.physics), recovery_counter=counter)

    def _termination(self, state, dist_mean, dist_max, pass_time):
        """Early termination is held back in the first recovery_counter steps
        of an episode."""
        _, terminate = super()._termination(state, dist_mean, dist_max, pass_time)
        in_grace = state.progress < state.recovery_counter
        self.grace_holds += (terminate & in_grace).sum()
        terminate = terminate & ~in_grace
        return pass_time | terminate, terminate
