"""Domain randomization: scheduled observation and action noise with held
correlated draws, and per-env physical-property multipliers.

Counterpart of `pulse_tpu/env/domain_rand.py` (the reference's
`BaseTask.apply_randomizations`):
  * noise (`apply_noise`): gaussian or uniform, additive or scaling, its
    magnitude on a linear, constant or no schedule, plus a correlated part
    from a standard-normal draw held between refreshes. The env applies it
    to the action before the motor mapping and to the final observation;
  * physical props (`randomize_model_props`): per-env uniform multipliers
    of the contact friction, the body masses (and inertias) and the PD
    gains, layered onto a batched model whose per-env leaves the physics
    kernel K3-rows reads.
The draws are arguments (`apply_noise`) or come from an explicit
`torch.Generator` (`randomize_model_props`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from pulse_tpu_torch.physics.model import Model
from pulse_tpu_torch.physics.shape_variation import scale_model


@dataclass(frozen=True)
class DRSpec:
    """One noise entry. gaussian: range = (mu, std multiplier); uniform:
    range = (lo, hi); range_correlated likewise for the held part."""

    distribution: str = "gaussian"          # gaussian | uniform
    operation: str = "additive"             # additive | scaling
    range: tuple[float, float] = (0.0, 0.02)
    range_correlated: tuple[float, float] = (0.0, 0.0)
    schedule: str | None = None             # linear | constant | None
    schedule_steps: int = 1

    def __post_init__(self):
        if self.distribution not in ("gaussian", "uniform"):
            raise ValueError(f"unknown distribution {self.distribution!r}")
        if self.operation not in ("additive", "scaling"):
            raise ValueError(f"unknown operation {self.operation!r}")
        if self.schedule not in (None, "linear", "constant"):
            raise ValueError(f"unknown schedule {self.schedule!r}")


@dataclass(frozen=True)
class DRConfig:
    """The env's randomization: obs and action noise, the refresh period of
    the correlated draws in policy steps, and the physical-prop multiplier
    ranges (None disables one)."""

    observations: DRSpec | None = None
    actions: DRSpec | None = None
    frequency: int = 1
    friction_range: tuple[float, float] | None = None
    mass_range: tuple[float, float] | None = None
    gain_range: tuple[float, float] | None = None

    @property
    def has_props(self) -> bool:
        return bool(self.friction_range or self.mass_range or self.gain_range)


def schedule_scaling(spec: DRSpec, step: torch.Tensor) -> torch.Tensor:
    """The noise magnitude's scale at `step` (any shape): linear ramps 0 to
    1 over schedule_steps, constant is 0 before schedule_steps and 1 from
    it, no schedule is 1."""
    step = step.to(torch.float32)
    if spec.schedule == "linear":
        n = float(max(spec.schedule_steps, 1))
        return torch.clamp(step, max=n) / n
    if spec.schedule == "constant":
        return torch.where(step < float(spec.schedule_steps), 0.0, 1.0)
    return torch.ones_like(step)


def _scheduled_params(spec: DRSpec, step: torch.Tensor) -> tuple:
    """The four scheduled parameters (p0, p1, p0_c, p1_c), shaped as `step`:
    additive ops scale all four by the schedule; scaling ops ramp the
    spread and move the centre or bounds from the identity 1."""
    a, b = spec.range
    ac, bc = spec.range_correlated
    s = schedule_scaling(spec, step)
    if spec.distribution == "gaussian" and spec.operation == "scaling":
        return a * s + (1.0 - s), b * s, ac * s + (1.0 - s), bc * s
    if spec.operation == "additive":
        return a * s, b * s, ac * s, bc * s
    return a * s + (1.0 - s), b * s + (1.0 - s), ac * s + (1.0 - s), bc * s + (1.0 - s)


def apply_noise(spec: DRSpec, tensor: torch.Tensor, corr_raw: torch.Tensor, draw: torch.Tensor,
                step: torch.Tensor) -> torch.Tensor:
    """`tensor` [B, n] with the noise of `spec` at per-env `step` [B]:
    `corr_raw` [B, n] is the held standard-normal draw, `draw` [B, n] this
    call's fresh one (standard normal for gaussian, uniform in [0, 1) for
    uniform)."""
    p0, p1, p0_c, p1_c = (p.reshape(p.shape + (1,) * (tensor.dim() - p.dim()))
                          for p in _scheduled_params(spec, step))
    if spec.distribution == "gaussian":
        noise = corr_raw * p1_c + p0_c + draw * p1 + p0
    else:
        noise = corr_raw * (p1_c - p0_c) + p0_c + draw * (p1 - p0) + p0
    return tensor + noise if spec.operation == "additive" else tensor * noise


def draw_noise(spec: DRSpec, shape, generator: torch.Generator) -> torch.Tensor:
    """The fresh draw `apply_noise` takes, from `generator`."""
    if spec.distribution == "gaussian":
        return torch.randn(shape, generator=generator, device=generator.device)
    return torch.rand(shape, generator=generator, device=generator.device)


def scale_model_props(model: Model, friction: torch.Tensor | None = None, mass: torch.Tensor | None = None,
                      gain: torch.Tensor | None = None) -> Model:
    """The batched `model` (a shared one batched at scale 1 first) with
    per-env multipliers [B, 1] of the contact friction, the body masses
    (with the whole spatial inertia and the total mass) and the PD gains."""
    n = next(x for x in (friction, mass, gain) if x is not None).shape[0]
    if not model.batched:
        model = scale_model(model, torch.ones(n, device=model.device))
    updates = {}
    if friction is not None:
        updates["cp_friction"] = model.cp_friction * friction
    if mass is not None:
        updates["body_mass"] = model.body_mass * mass
        updates["total_mass"] = updates["body_mass"].sum(dim=-1)
        updates["spatial_inertia"] = model.spatial_inertia * mass[..., None, None]
    if gain is not None:
        updates["joint_kp"] = model.joint_kp * gain
        updates["joint_kd"] = model.joint_kd * gain
    return dataclasses.replace(model, **updates)


def randomize_model_props(model: Model, generator: torch.Generator, num_envs: int,
                          friction_range: tuple[float, float] | None = None,
                          mass_range: tuple[float, float] | None = None,
                          gain_range: tuple[float, float] | None = None) -> Model:
    """A batched model with per-env multipliers drawn uniform in each
    range from `generator` (friction, then mass, then gains; None skips
    one). The model itself when every range is None."""
    def draw(r):
        if r is None:
            return None
        return r[0] + (r[1] - r[0]) * torch.rand(num_envs, 1, generator=generator, device=generator.device)

    mults = [draw(r) for r in (friction_range, mass_range, gain_range)]
    if all(m is None for m in mults):
        return model
    return scale_model_props(model, *mults)


def dr_config_from_dict(d: dict) -> DRConfig:
    """A DRConfig from the env YAML's `randomization_params` mapping:
    frequency, observations / actions blocks (distribution, operation,
    range, range_correlated, schedule, schedule_steps) and the three prop
    ranges."""

    def spec(block) -> DRSpec | None:
        if not block:
            return None
        return DRSpec(
            distribution=str(block.get("distribution", "gaussian")),
            operation=str(block.get("operation", "additive")),
            range=tuple(float(x) for x in block.get("range", (0.0, 0.02))),
            range_correlated=tuple(float(x) for x in block.get("range_correlated", (0.0, 0.0))),
            schedule=block.get("schedule"),
            schedule_steps=int(block.get("schedule_steps", 1)),
        )

    def rng(name) -> tuple[float, float] | None:
        v = d.get(name)
        return None if v is None else tuple(float(x) for x in v)

    return DRConfig(observations=spec(d.get("observations")), actions=spec(d.get("actions")),
                    frequency=int(d.get("frequency", 1)), friction_range=rng("friction_range"),
                    mass_range=rng("mass_range"), gain_range=rng("gain_range"))
