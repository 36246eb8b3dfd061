"""The port's general physics (`physics/aba_fast.py`, `dynamics.
explicit_joint_torques`, `step._substep` and the pd, force and prop-coupled
control steps, `physics/prop.py`) and the projectile env
(`env/humanoid_im_perturb.py`) against the JAX package's on the CPU.

B = 6 humanoids at 1 substep of 1/120 s a control step, in random poses
with random velocities, envs 0-3 low enough for their feet to touch the
ground; a prop (the strike target) overlapping envs 0-2's bodies and out of
reach of the others. At 1 substep the JAX force step is `_substep` with raw
torques and passive damping, so it holds that case of `_substep` too.

The perturb env: one step of 4 envs from reference states (no reset),
proj_interval 4, envs at progress 1, 3, 7 and 2 (envs 1 and 2 relaunch
their projectiles, aimed from the stepped roots), each projectile in
flight toward its pelvis (envs 0 and 1 touching it), the JAX launch draws
fed to the port; and the launch itself on given roots and draws.

Every JAX function runs in one jit of all the cases (`jax_outputs`); the
port's gets the same numpy inputs.

Tolerances (max abs, per field): accelerations 1e-3 relative to the
field's largest entry; torques 1e-3; the stepped state as chip_smoke.py's
K1_TOL (positions and rotations 2e-4 to 3e-4, velocities 5e-3, contact
forces 1.0 N), the prop's state likewise and its contact and reaction
forces 1.0 N; the perturb step's obs and reward 4e-4, about twice their
measured maxima of 2.02e-4 and 1.95e-4 (they read the stepped
velocities' float rounding, as in tests/test_torch_domain_rand.py),
its flags exactly; the launch 1e-5. The compliant contacts flip on float
noise, so the contact-bearing steps allow one outlier env; the
contact-free ones none.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl
from pulse_tpu.env.humanoid_im import EnvState as JaxEnvState
from pulse_tpu.env.humanoid_im_perturb import HumanoidImPerturbEnv as JaxPerturbEnv
from pulse_tpu.env.humanoid_im_perturb import PerturbConfig as JaxPerturbConfig
from pulse_tpu.motion import build_motion_data as jax_build_motion_data
from pulse_tpu.motion.synthetic import make_synthetic_clips as jax_clips
from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig, build_model as jax_build_model
from pulse_tpu.physics import aba_fast as jax_aba_fast
from pulse_tpu.physics import dynamics as jax_dynamics, prop as jax_prop, step as jax_step
from pulse_tpu.physics.state import PhysicsState as JaxPhysicsState

from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env.humanoid_im import env_state_from_numpy
from pulse_tpu_torch.env.humanoid_im_perturb import HumanoidImPerturbEnv, PerturbConfig
from pulse_tpu_torch.motion.motion_lib import MotionData
from pulse_tpu_torch.physics import dynamics, prop, step
from pulse_tpu_torch.physics.aba_fast import aba_fast
from pulse_tpu_torch.physics.model import PhysicsConfig, build_model
from pulse_tpu_torch.physics.state import PhysicsState, refresh_kinematics, state_from_kinematics

B = 6
CFG = dict(dt=1.0 / 120.0, substeps=1, control_freq_inv=1)
H = 1.0 / 120.0
PROP = dict(half_extents=(0.25, 0.25, 0.9), density=100.0, friction=0.6)
STATE_TOL = {"root_pos": 2e-4, "root_rot": 2e-4, "joint_rot": 2e-4, "root_vel6": 5e-3, "joint_omega": 5e-3,
             "body_pos": 3e-4, "body_rot": 2e-4, "body_vel": 5e-3, "body_ang_vel": 5e-3, "contact_force": 1.0}
PROP_TOL = {"pos": 2e-4, "rot": 2e-4, "lin_vel": 5e-3, "ang_vel": 5e-3}
FIELDS = [f.name for f in dataclasses.fields(PhysicsState)]
NP = 4                      # the perturb step's envs
PERTURB = dict(proj_interval=4)


@pytest.fixture(scope="module")
def setup():
    model = build_model(load_smpl_humanoid(), PhysicsConfig(**CFG), device="cpu")
    jmodel = jax_build_model(jax_load_smpl(), JaxPhysicsConfig(**CFG))
    g = torch.Generator().manual_seed(0)
    root = torch.tensor([[0.0, 0.0, 0.86], [1.0, 0.0, 0.84], [0.0, 1.0, 0.86], [2.0, 2.0, 0.85],
                         [0.0, -3.0, 1.3], [3.0, 0.0, 1.4]])
    rot = torch.nn.functional.normalize(torch.tensor([[0.0, 0.0, 0.0, 1.0]]) + 0.1 * torch.randn(B, 4, generator=g),
                                        dim=-1)
    st = state_from_kinematics(model, root, rot, 0.3 * torch.randn(B, 69, generator=g),
                               0.3 * torch.randn(B, 3, generator=g), 0.5 * torch.randn(B, 3, generator=g),
                               torch.randn(B, 69, generator=g))
    ins = {
        "state": {f: getattr(st, f).numpy().copy() for f in FIELDS},
        "tau": (60.0 * torch.randn(B, 23, 3, generator=g)).numpy(),
        "f_ext": (30.0 * torch.randn(B, 24, 6, generator=g)).numpy(),
        "d_extra": (0.05 * torch.rand(B, 23, 3, generator=g)).numpy(),
        "tau_dof": (80.0 * torch.randn(B, 69, generator=g)).numpy(),
        "pd": (0.4 * torch.randn(B, 69, generator=g)).numpy(),
        # the prop beside envs 0-2's pelvis (overlapping the body), far from 3-5
        "prop_pos": (st.root_pos + torch.tensor([0.3, 0.05, 0.0])
                     + torch.tensor([0, 0, 0, 9.0, 9.0, 9.0])[:, None]).numpy(),
    }
    return model, jmodel, ins


@pytest.fixture(scope="module")
def perturb(setup):
    """(port env, JAX env, the env state as numpy, the projectiles as numpy,
    actions, the JAX env's keys)."""
    model, jmodel, _ = setup
    jspec = jax_load_smpl()
    jm = jax_build_motion_data(jspec.skeleton, jax_clips(jspec.skeleton, 4))
    fields = {f.name: torch.float32 for f in dataclasses.fields(MotionData)}
    fields.update(length_starts=torch.long, motion_num_frames=torch.long)
    motion = MotionData(**{k: torch.tensor(np.asarray(getattr(jm, k)), dtype=dt) for k, dt in fields.items()})
    env = HumanoidImPerturbEnv(model, motion, PerturbConfig(**PERTURB), device="cpu")
    start = np.array([0.5, 1.0, 1.5, 0.8], np.float32)
    st = env.reset_to(torch.arange(NP), torch.as_tensor(start))
    d = {f.name: getattr(st, f.name).numpy().copy() for f in dataclasses.fields(st)
         if f.name != "physics" and getattr(st, f.name) is not None}
    d["physics"] = {f.name: getattr(st.physics, f.name).numpy().copy() for f in dataclasses.fields(st.physics)}
    d["progress"] = np.array([1, 3, 7, 2], np.int32)
    d["start_time"] = (start - d["progress"] * model.config.control_dt).astype(np.float32)
    # projectiles flying at the pelvis at 6 m/s, envs 0 and 1 touching it
    off = np.array([[0.12, 0.0, 0.0], [0.0, 0.12, 0.0], [1.5, 0.0, 0.0], [0.0, -1.5, 0.2]], np.float32)
    prop_np = {"pos": d["physics"]["root_pos"] + off, "rot": np.tile(np.array([0, 0, 0, 1], np.float32), (NP, 1)),
               "lin_vel": -6.0 * off / np.linalg.norm(off, axis=1, keepdims=True),
               "ang_vel": np.zeros((NP, 3), np.float32)}
    actions = np.random.default_rng(1).uniform(-1, 1, (NP, 69)).astype(np.float32)
    jenv = JaxPerturbEnv(jmodel, jm, JaxPerturbConfig(**PERTURB))
    return env, jenv, d, prop_np, actions, jax.random.split(jax.random.PRNGKey(1), NP)


def _launch_draws(k):
    """HumanoidImPerturbEnv._launch's draws on step_proj_one's key."""
    k1, k2, k3 = jax.random.split(jax.random.fold_in(k, 33), 3)
    return (jax.random.uniform(k1, (), minval=-jnp.pi, maxval=jnp.pi),
            jax.random.uniform(k2, (), minval=0.6, maxval=1.6),
            jax.random.uniform(k3, (), minval=5.0, maxval=12.0))


@pytest.fixture(scope="module")
def jax_outputs(setup, perturb):
    """Every JAX case in one jit."""
    _, m, ins = setup
    _, jenv, d, prop_np, actions, keys = perturb
    spec = jax_prop.PropSpec(**PROP)

    def cases(st, tau, f_ext, d_extra, tau_dof, pd, prop_pos):
        st = jax_step.refresh_kinematics(m, st)
        pr = jax_prop.make_prop_state(prop_pos)
        return {
            "aba": jax_aba_fast.aba_fast(m, st, tau, f_ext, st.body_rot, H, d_extra),
            "aba_no_d": jax_aba_fast.aba_fast(m, st, tau, f_ext, st.body_rot, H),
            "explicit": jax_dynamics.explicit_joint_torques(m, st, tau_dof, H),
            "explicit_kd": jax_dynamics.explicit_joint_torques(m, st, tau_dof, H, passive_kd=m.joint_kd),
            "sub_f_ext": jax_step._substep(m, st, pd, H, f_ext_extra=f_ext),
            "sub_tau": jax_step._substep(m, st, None, H, tau_dof=tau_dof),
            "torque": jax_step.physics_step_torque(m, st, tau_dof),
            "pd_explicit": jax_step.physics_step_pd_explicit(m, st, pd),
            "prop_step": jax_prop.prop_step(m, spec, pr, st.body_pos, st.body_rot, st.body_vel, st.body_ang_vel, H),
            "with_prop": jax_step.physics_step_with_prop(m, spec, st, pr, pd),
        }

    def all_cases(st, phys_ins, es, prop_state, acts):
        out = jax.vmap(cases)(st, *phys_ins)
        out["perturb"] = jenv.step((es, prop_state), acts)
        out["launch"] = jax.vmap(lambda k, r: jenv._launch(jax.random.fold_in(k, 33), r))(keys, es.physics.root_pos)
        out["launch_draws"] = jax.vmap(_launch_draws)(keys)
        return out

    st = JaxPhysicsState(**{k: jnp.asarray(v) for k, v in ins["state"].items()})
    es = JaxEnvState(physics=JaxPhysicsState(**{k: jnp.asarray(v) for k, v in d["physics"].items()}), key=keys,
                     **{k: jnp.asarray(v) for k, v in d.items() if k != "physics"})
    out = jax.jit(all_cases)(st, [jnp.asarray(ins[k]) for k in ("tau", "f_ext", "d_extra", "tau_dof", "pd",
                                                                "prop_pos")],
                             es, jax_prop.PropState(**{k: jnp.asarray(v) for k, v in prop_np.items()}),
                             jnp.asarray(actions))
    return jax.tree.map(np.asarray, out)


def _state(ins, model) -> PhysicsState:
    return refresh_kinematics(model, PhysicsState(**{k: torch.tensor(v) for k, v in ins["state"].items()}))


def _t(ins, k):
    return torch.tensor(ins[k])


def _state_outliers(got: PhysicsState, want, tol=STATE_TOL) -> list:
    """The envs where some field differs from the JAX state's beyond its
    tolerance."""
    bad = np.zeros(B, bool)
    for f, t in tol.items():
        d = np.abs(getattr(got, f).numpy() - np.asarray(getattr(want, f))).reshape(B, -1).max(axis=1)
        bad |= d > t
    return list(np.nonzero(bad)[0])


@pytest.mark.parametrize("with_d", [True, False])
def test_aba_fast_matches_jax(setup, jax_outputs, with_d):
    model, _, ins = setup
    st = _state(ins, model)
    a0, qdd = aba_fast(model, st, _t(ins, "tau"), _t(ins, "f_ext"), st.body_rot, H,
                       _t(ins, "d_extra") if with_d else None)
    want_a0, want_qdd = jax_outputs["aba" if with_d else "aba_no_d"]
    for got, want in ((a0, want_a0), (qdd, want_qdd)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-3 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("passive", [False, True])
def test_explicit_joint_torques_match_jax(setup, jax_outputs, passive):
    model, _, ins = setup
    st = _state(ins, model)
    tau, d_extra = dynamics.explicit_joint_torques(model, st, _t(ins, "tau_dof"), H,
                                                   passive_kd=model.joint_kd if passive else None)
    want_tau, want_d = jax_outputs["explicit_kd" if passive else "explicit"]
    np.testing.assert_allclose(tau.numpy(), want_tau, atol=1e-3, rtol=0)
    np.testing.assert_allclose(d_extra.expand(B, 23, 3).numpy(), want_d, atol=1e-7, rtol=0)
    # the joint limits are active somewhere, so the springs were exercised
    assert (want_d > (H * model.joint_kd[:, None].numpy() if passive else 0) + 1e-6).any()


@pytest.mark.parametrize("case", ["sub_f_ext", "sub_tau", "sub_tau_kd"])
def test_substep_matches_jax(setup, jax_outputs, case):
    """`_substep` with extra external forces (under stable PD), with raw
    torques, and with raw torques and passive damping (against the JAX
    force step, which at 1 substep is that `_substep`)."""
    model, _, ins = setup
    st = _state(ins, model)
    kw = {"sub_f_ext": dict(f_ext_extra=_t(ins, "f_ext")), "sub_tau": dict(tau_dof=_t(ins, "tau_dof")),
          "sub_tau_kd": dict(tau_dof=_t(ins, "tau_dof"), passive_kd=model.joint_kd)}[case]
    got = step._substep(model, st, _t(ins, "pd") if case == "sub_f_ext" else None, H, **kw)
    tol = {k: v for k, v in STATE_TOL.items() if not k.startswith("body")}   # _substep leaves the bodies stale
    assert len(_state_outliers(got, jax_outputs["torque" if case == "sub_tau_kd" else case], tol)) <= 1


@pytest.mark.parametrize("case", ["torque", "pd_explicit"])
def test_control_mode_steps_match_jax(setup, jax_outputs, case):
    model, _, ins = setup
    st = _state(ins, model)
    if case == "torque":
        got = step.physics_step_torque(model, st, _t(ins, "tau_dof"))
    else:
        got = step.physics_step_pd_explicit(model, st, _t(ins, "pd"))
    assert len(_state_outliers(got, jax_outputs[case])) <= 1
    assert (got.contact_force.abs().sum(dim=(1, 2)) > 0).sum() >= 2   # the feet touch in some envs


def test_box_sdf_push_matches_jax():
    rng = np.random.default_rng(3)
    half = np.array([0.25, 0.2, 0.9], np.float32)
    rel = rng.uniform(-1.5, 1.5, (512, 3)).astype(np.float32)
    rel[:200] *= 0.2   # many points inside
    sdf, n = prop._box_sdf_push(torch.tensor(rel), torch.tensor(half))
    want_sdf, want_n = jax.jit(jax_prop._box_sdf_push)(jnp.asarray(rel), jnp.asarray(half))
    np.testing.assert_allclose(sdf.numpy(), want_sdf, atol=1e-6, rtol=0)
    np.testing.assert_allclose(n.numpy(), want_n, atol=1e-6, rtol=0)
    assert (want_sdf < 0).sum() > 100 and (want_sdf > 0).sum() > 100


def test_prop_step_matches_jax(setup, jax_outputs):
    model, _, ins = setup
    st = _state(ins, model)
    spec = prop.PropSpec(**PROP)
    pr = prop.make_prop_state(_t(ins, "prop_pos"))
    new, f_ext_h, contact = prop.prop_step(model, spec, pr, st.body_pos, st.body_rot, st.body_vel,
                                           st.body_ang_vel, H)
    want_new, want_f, want_c = jax_outputs["prop_step"]
    bad = np.zeros(B, bool)
    for f, t in PROP_TOL.items():
        bad |= np.abs(getattr(new, f).numpy() - getattr(want_new, f)).max(axis=1) > t
    bad |= np.abs(f_ext_h.numpy() - want_f).reshape(B, -1).max(axis=1) > 1.0
    bad |= np.abs(contact.numpy() - want_c).max(axis=1) > 1.0
    assert bad.sum() <= 1
    touched = np.abs(want_c).sum(axis=1) > 0
    assert touched[:3].any() and not touched[3:].any()


def test_physics_step_with_prop_matches_jax(setup, jax_outputs):
    model, _, ins = setup
    st = _state(ins, model)
    spec = prop.PropSpec(**PROP)
    got, new, contact = step.physics_step_with_prop(model, spec, st, prop.make_prop_state(_t(ins, "prop_pos")),
                                                    _t(ins, "pd"))
    want, want_prop, want_c = jax_outputs["with_prop"]
    bad = np.zeros(B, bool)
    bad[_state_outliers(got, want)] = True
    for f, t in PROP_TOL.items():
        bad |= np.abs(getattr(new, f).numpy() - getattr(want_prop, f)).max(axis=1) > t
    bad |= np.abs(contact.numpy() - want_c).max(axis=1) > 1.0
    assert bad.sum() <= 1
    assert (np.abs(want_c).sum(axis=1) > 0)[:3].any()


def test_perturb_launch_matches_jax(perturb, jax_outputs):
    env, _, d, _, _, _ = perturb
    draws = tuple(torch.tensor(x) for x in jax_outputs["launch_draws"])
    env._launch_draws = lambda n: draws
    try:
        got = env._launch(torch.tensor(d["physics"]["root_pos"]))
    finally:
        del env._launch_draws
    for f in ("pos", "rot", "lin_vel", "ang_vel"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(jax_outputs["launch"], f), atol=1e-5, rtol=0)
    st, pr = env.reset(6)     # one projectile per env, from the env's generator
    xy = torch.linalg.vector_norm((pr.pos - st.physics.root_pos)[:, :2], dim=-1)
    assert torch.allclose(xy, torch.full((6,), 2.0))
    speed = pr.lin_vel.norm(dim=-1)
    assert ((speed >= 5.0) & (speed <= 12.0)).all()


def test_perturb_step_matches_jax(perturb, jax_outputs):
    env, _, d, prop_np, actions, _ = perturb
    want, want_prop = jax_outputs["perturb"]
    draws = tuple(torch.tensor(x) for x in jax_outputs["launch_draws"])
    env._launch_draws = lambda n: draws
    try:
        got, got_prop = env.step((env_state_from_numpy(d), prop.PropState(**{k: torch.tensor(v)
                                                                            for k, v in prop_np.items()})),
                                 torch.tensor(actions))
    finally:
        del env._launch_draws
    assert not want.done.any()
    for f in ("done", "terminate", "progress"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f), err_msg=f)
    # about twice the measured maxima: obs 2.02e-4, reward 1.95e-4
    np.testing.assert_allclose(got.obs.numpy(), want.obs, atol=4e-4, rtol=0)
    np.testing.assert_allclose(got.reward.numpy(), want.reward, atol=4e-4, rtol=0)
    bad = np.zeros(NP, bool)
    for f, t in STATE_TOL.items():
        bad |= np.abs(getattr(got.physics, f).numpy() - getattr(want.physics, f)).reshape(NP, -1).max(axis=1) > t
    for f, t in PROP_TOL.items():
        bad |= np.abs(getattr(got_prop, f).numpy() - getattr(want_prop, f)).max(axis=1) > t
    assert bad.sum() <= 1
    # envs 1 and 2 relaunched (pre-step progress 3 and 7), from the stepped root
    xy = np.linalg.norm(got_prop.pos.numpy()[:, :2] - got.physics.root_pos.numpy()[:, :2], axis=1)
    assert (np.abs(xy - 2.0) < 1e-4).tolist() == [False, True, True, False]
    contact = env.prop_contact.abs().sum(dim=1)
    assert (contact[:2] > 0).all() and (contact[2:] == 0).all()
