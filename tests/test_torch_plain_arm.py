"""`env.use_pallas_physics=false`: the env runs each kernel's plain PyTorch
version in its place (the JAX package's XLA arm, `pulse_tpu/run.py:122`).

On the CPU: the key reaches the env's config through `run.main`, and with
it false no kernel wrapper is called, on each of the step's paths (K1 on
env=im; K3 -> RA -> K2 and the fall-state settle on env=im_getup; K3-rows
-> RA -> K2 with per-env shapes): the wrappers are replaced by functions
that raise, and the step equals the default env's (on the CPU the
wrappers run the same plain versions): bit for bit, but with per-env
shapes within 2.5e-5 (2e-3 N on the contact force). On the card (marker `cuda`,
skipped without one): run.main with the key false launches no kernel, and
one step equals the kernel path's within chip_smoke.py's gates (the
physics' tolerances with at most 1% outlier envs; in the other envs the
flags alike, the reward 1e-4 and the observation 5e-3, the stepped
velocities' bar, as it reads them: 1.1e-3 at 256 envs and 3.7e-3 at 3072
envs in the first run on an H100).

The card tests import no JAX; run them on the card with
`python -m pytest --noconftest -m cuda tests/test_torch_plain_arm.py`.
"""

import dataclasses

import pytest
import torch

from torch_close import assert_close

from pulse_tpu_torch import _build, run
from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env import cuda_obs
from pulse_tpu_torch.env.humanoid_im import EnvConfig, HumanoidImEnv
from pulse_tpu_torch.env.humanoid_im_getup import GetupConfig, HumanoidImGetupEnv
from pulse_tpu_torch.motion.motion_lib import build_motion_data
from pulse_tpu_torch.motion.synthetic import make_synthetic_clips
from pulse_tpu_torch.physics import substep_cuda
from pulse_tpu_torch.physics.model import PhysicsConfig, build_model

TINY = ["num_envs=8", "learning.horizon_length=4", "learning.minibatch_size=16", "learning.mini_epochs=2",
        "learning.actor_units=[32,24]", "learning.critic_units=[32,24]", "max_epochs=1"]
WRAPPERS = ((cuda_obs, "step_reward_amp"), (cuda_obs, "reward_amp"), (cuda_obs, "observe"),
            (substep_cuda, "physics_step_cuda"))
PHYS_TOL = {"root_pos": 2e-4, "root_rot": 2e-4, "joint_rot": 2e-4, "root_vel6": 5e-3, "joint_omega": 5e-3,
            "body_pos": 3e-4, "body_rot": 2e-4, "body_vel": 5e-3, "body_ang_vel": 5e-3, "contact_force": 1.0}


def _env(kind: str, device, kernels: bool, B: int = 8, fall_init_prob: float = 0.5):
    spec = load_smpl_humanoid()
    model = build_model(spec, PhysicsConfig(), device=device)
    motion = build_motion_data(spec.skeleton, make_synthetic_clips(spec.skeleton, 4), device=device)
    if kind == "getup":
        return HumanoidImGetupEnv(model, motion, GetupConfig(use_pallas_physics=kernels, num_fall_states=8,
                                                             fall_settle_steps=2, fall_init_prob=fall_init_prob),
                                  device=device)
    env = HumanoidImEnv(model, motion, EnvConfig(use_pallas_physics=kernels), device=device)
    if kind == "shape":
        env.enable_shape_variation(B, generator=torch.Generator(device=device).manual_seed(7))
    return env


def _step(env, B: int = 8):
    g = torch.Generator(device=env.device).manual_seed(1)
    st = env.reset(B)
    actions = 0.5 * torch.randn(B, env.action_dim, generator=g, device=env.device)
    return env.step(st, actions)


@pytest.mark.parametrize("args", [["env=im"], ["env=im_getup", "env.num_fall_states=8", "env.fall_settle_steps=2"],
                                  ["env=amp", "learning=im_amp", "learning.amp_batch_size=8",
                                   "learning.amp_buffer_size=64", "learning.disc_units=[32]"]])
def test_the_key_reaches_the_env(args, tmp_path):
    before = dict(_build.launches)
    res = run.main([*args, "env.use_pallas_physics=false", "device=cpu", f"output_dir={tmp_path}", *TINY])
    assert res.agent.env.config.use_pallas_physics is False and _build.launches == before
    assert run.main([*args, "device=cpu", f"output_dir={tmp_path}", *TINY]).agent.env.config.use_pallas_physics


@pytest.mark.parametrize("kind", ["im", "getup", "shape"])
def test_the_plain_arm_calls_no_wrapper(kind, monkeypatch):
    want = _step(_env(kind, "cpu", kernels=True))

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called with use_pallas_physics false")

    for module, name in WRAPPERS:
        monkeypatch.setattr(module, name, refuse)
    got = _step(_env(kind, "cpu", kernels=False))
    # K3-rows' plain version reads each env's model back from the kernel's
    # rows; the plain arm steps the batched model itself, as the JAX
    # package's XLA arm does: they differ by rounding (measured: 9.5e-6 on
    # the state but the contact force, 7.8e-4 N there, 1.1e-5 on the obs)
    tol = 2.5e-5 if kind == "shape" else 0.0
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(a):
            for p in dataclasses.fields(a):
                t = 80 * tol if p.name == "contact_force" else tol
                assert_close(getattr(a, p.name), getattr(b, p.name), rtol=0, atol=t, msg=p.name)
        elif a is not None:
            assert_close(a, b, rtol=0, atol=tol, msg=f.name)
    with pytest.raises(AssertionError, match="kernel wrapper"):
        _step(_env(kind, "cpu", kernels=True))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_run_main_with_the_key_false_launches_no_kernel_on_the_card(card, tmp_path):
    _build.reset_launch_counts()
    res = run.main(["env=im", "env.use_pallas_physics=false", "device=cuda", f"output_dir={tmp_path}", *TINY])
    assert all(n == 0 for n in _build.launches.values()) and not res.agent.env.config.use_pallas_physics
    res = run.main(["env=im", "device=cuda", f"output_dir={tmp_path}", *TINY])
    assert _build.launches["step_reward_amp"] == 4 and _build.launches["observe"] == 5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["im", "getup", "shape"])
def test_the_plain_arm_matches_the_kernels_on_the_card(card, kind):
    """The fall states are settled in both arms but drawn by no reset (the
    settle's later steps are ill-conditioned, ROADMAP queue 3); reward and
    observation are held in the envs whose physics is within tolerance."""
    B = 256
    _build.reset_launch_counts()
    plain = _step(_env(kind, card, kernels=False, B=B, fall_init_prob=0.0), B)
    assert all(n == 0 for n in _build.launches.values())
    kern = _step(_env(kind, card, kernels=True, B=B, fall_init_prob=0.0), B)
    assert any(n > 0 for n in _build.launches.values())
    bad = torch.zeros(B, dtype=torch.bool, device=card)
    for f, tol in PHYS_TOL.items():
        bad |= (getattr(plain.physics, f) - getattr(kern.physics, f)).abs().reshape(B, -1).amax(dim=1) > tol
    assert int(bad.sum()) <= 0.01 * B
    assert torch.equal(plain.done[~bad], kern.done[~bad])
    assert_close(plain.reward[~bad], kern.reward[~bad], rtol=0, atol=1e-4)
    assert_close(plain.obs[~bad], kern.obs[~bad], rtol=0, atol=PHYS_TOL["body_vel"])
