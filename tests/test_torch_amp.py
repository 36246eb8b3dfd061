"""The port's AMP learner (learning/amp.py, learning/amp_agent.py) against the
JAX package's on the CPU.

Deterministic cores are held by value, on seeded numpy inputs:
  * `Discriminator` from `discriminator_from_jax`: logits 1e-5;
  * `_disc_loss` at the real 2320-wide input with disc_units (32, 16),
    some inputs beyond the normalizer's ±5 clip: total, BCE, R1 and the
    accuracies 1e-5 relative (accuracies exactly), and the gradient of
    every parameter 1e-5 relative to its largest entry (the R1 term
    backpropagates through a double backward);
  * one Adam step from an Adam state one step in (its count, mu and nu
    through `amp_state_from_jax`), against `optax.adam(1e-4)`: 1e-6;
  * `disc_reward` 1e-5 and `combine_rewards` (static and dynamic weights);
  * `RingBuffer` after pushes of 3, 5 and capacity + 2: data exactly, head,
    size;
  * `amp_rms` after `update` (the rollout and fresh demos merged by
    moments) against the JAX RunningMeanStd of their concatenation: 1e-5
    relative;
  * `_build_demo_steps` on the same (ids, t0) with shape and limb channels
    and per-clip shape rows, both reading the JAX store's tables: 1e-5;
  * `amp_state_from_jax` round-trips every leaf exactly.
The sampled paths (torch and JAX draw different numbers) are held by their
structure: the demo windows' shape channels, the encoder pair's nesting,
the AMP-obs dropout's chunk, `pre_epoch`'s schedules and a tiny `AMPAgent` / `JointAMPDistillAgent`
epoch on a port env.
"""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl
from pulse_tpu.env import EnvConfig as JaxEnvConfig, HumanoidImEnv as JaxEnv
from pulse_tpu.learning.amp import (AMPConfig as JaxAMPConfig, AMPModule as JaxAMPModule, AMPState as JaxAMPState,
                                    RingBuffer as JaxRingBuffer)
from pulse_tpu.learning.networks import Discriminator as JaxDiscriminator
from pulse_tpu.learning.running_norm import RunningMeanStd as JaxRMS
from pulse_tpu.motion import build_motion_data as jax_build_motion_data
from pulse_tpu.motion.synthetic import make_synthetic_clips as jax_clips
from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig, build_model as jax_build_model

from jax_reference import module_reference_compiles
from torch_close import assert_close

from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env.humanoid_im import EnvConfig, HumanoidImEnv
from pulse_tpu_torch.env.humanoid_im_getup import GetupConfig
from pulse_tpu_torch.learning.amp import AMPConfig, AMPModule, RingBuffer, amp_state_from_jax
from pulse_tpu_torch.learning.amp_agent import AMPAgent, JointAMPDistillAgent
from pulse_tpu_torch.learning.distill import DistillAgent, DistillConfig
from pulse_tpu_torch.learning.networks import (ActorCritic, Discriminator, PulseVAE, RNNActorCritic, disc_leaves,
                                               discriminator_from_jax)
from pulse_tpu_torch.learning.ppo import PPOConfig
from pulse_tpu_torch.learning.running_norm import RunningMeanStd
from pulse_tpu_torch.motion.motion_lib import MotionData, build_motion_data
from pulse_tpu_torch.motion.synthetic import make_synthetic_clips
from pulse_tpu_torch.physics.model import PhysicsConfig, build_model

# every JAX compile of this module's references at -O0 (tests/jax_reference.py)
reference_compiles_in_module = module_reference_compiles()

DIM = 2320
UNITS = (32, 16)
CPU = types.SimpleNamespace(device=torch.device("cpu"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_state():
    """A JAX AMPState one Adam step in (the disc at (32, 16) on 2320 inputs),
    with an amp_rms whose small variances push some inputs past the clip,
    and the batches of the next step."""
    rng = np.random.default_rng(0)
    params = JaxDiscriminator(units=UNITS).init(jax.random.PRNGKey(0), jnp.zeros((1, DIM)))["params"]
    opt = optax.adam(1e-4)
    rms = JaxRMS(mean=jnp.asarray(rng.normal(0, 0.5, DIM), jnp.float32),
                 var=jnp.asarray(rng.uniform(0.05, 2.0, DIM), jnp.float32), count=jnp.asarray(500.0))
    amp = JaxAMPModule(None, JaxAMPConfig(disc_units=UNITS))
    batches = [(jnp.asarray(rng.normal(0, 1, (24, DIM)), jnp.float32),
                jnp.asarray(rng.normal(0.3, 1, (24, DIM)), jnp.float32)) for _ in range(2)]
    grads = jax.grad(lambda p: amp._disc_loss(p, *batches[0], rms)[0])(params)
    opt_state = opt.init(params)
    updates, opt_state = opt.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    demo = JaxRingBuffer.create(64, DIM).push(jnp.asarray(rng.normal(0, 1, (20, DIM)), jnp.float32))
    replay = JaxRingBuffer.create(64, DIM).push(jnp.asarray(rng.normal(0, 1, (70, DIM)), jnp.float32))
    state = JaxAMPState(disc_params=params, disc_opt_state=opt_state, amp_rms=rms, demo_buffer=demo,
                        replay_buffer=replay, task_reward_w=jnp.asarray(0.25), disc_reward_w=jnp.asarray(0.75))
    return amp, state, batches[1]


def _port_module(**kw) -> AMPModule:
    return AMPModule(CPU, AMPConfig(disc_units=UNITS, **kw))


def test_discriminator_logits_match_jax(jax_state):
    _, state, (agent, _) = jax_state
    disc = discriminator_from_jax(_np(state.disc_params), device="cpu")
    want = JaxDiscriminator(units=UNITS).apply({"params": state.disc_params}, agent)
    got = disc(torch.tensor(np.asarray(agent)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # float32 under a caller's bf16 autocast; a fresh logit layer is uniform
    # in ±sqrt(3 / fan_in), both signs
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert disc(torch.tensor(np.asarray(agent))).dtype == torch.float32
    w = Discriminator(DIM, UNITS, device="cpu", seed=3).logit.weight
    assert float(w.abs().max()) <= (3.0 / UNITS[-1]) ** 0.5 and (w > 0).any() and (w < 0).any()


def test_disc_loss_and_gradients_match_jax(jax_state):
    amp, state, (agent, demo) = jax_state
    (want_total, want_m), want_g = jax.value_and_grad(amp._disc_loss, has_aux=True)(
        state.disc_params, agent, demo, state.amp_rms)
    port = amp_state_from_jax(_np(state), device="cpu")
    mod = _port_module()
    rms = port.amp_rms
    assert (torch.abs(rms.normalize(torch.as_tensor(np.asarray(demo)))) == 5.0).any(), "the clip must bite"
    total, m = mod._disc_loss(port.disc, torch.as_tensor(np.asarray(agent)), torch.as_tensor(np.asarray(demo)), rms)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(want_total), rtol=1e-5)
    for k in ("disc_loss", "disc_grad_pen"):
        np.testing.assert_allclose(float(m[k]), float(want_m[k]), rtol=1e-5, err_msg=k)
    for k in ("disc_acc_agent", "disc_acc_demo"):
        assert float(m[k]) == float(want_m[k]), k
    assert float(want_m["disc_grad_pen"]) > 0
    for p, g in disc_leaves(port.disc, _np(want_g)):
        scale = float(g.abs().max())
        assert scale > 0
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=0, atol=1e-5 * scale)


def test_one_adam_step_matches_optax(jax_state):
    amp, state, (agent, demo) = jax_state
    grads = jax.grad(lambda p: amp._disc_loss(p, agent, demo, state.amp_rms)[0])(state.disc_params)
    updates, _ = optax.adam(1e-4).update(grads, state.disc_opt_state, state.disc_params)
    want = optax.apply_updates(state.disc_params, updates)
    port = amp_state_from_jax(_np(state), device="cpu")
    total, _ = _port_module()._disc_loss(port.disc, torch.as_tensor(np.asarray(agent)),
                                         torch.as_tensor(np.asarray(demo)), port.amp_rms)
    port.optimizer.zero_grad()
    total.backward()
    port.optimizer.step()
    for p, w in disc_leaves(port.disc, _np(want)):
        np.testing.assert_allclose(p.detach().numpy(), w.numpy(), rtol=0, atol=1e-6)


def test_disc_reward_and_combine_match_jax(jax_state):
    amp, state, (agent, _) = jax_state
    obs = agent.reshape(4, 6, DIM)
    want = amp.disc_reward(state, obs)
    port = amp_state_from_jax(_np(state), device="cpu")
    mod = _port_module()
    got = mod.disc_reward(port, torch.as_tensor(np.asarray(obs)))
    assert got.shape == (4, 6) and (got >= 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # the combine on identical inputs: both take JAX's style reward, so the
    # 1e-6 below does not inherit the 1e-5 that holds `got` to `want`
    task = np.random.default_rng(1).uniform(size=(4, 6)).astype(np.float32)
    style = torch.as_tensor(np.asarray(want))
    for with_state in (False, True):
        w = amp.combine_rewards(jnp.asarray(task), want, state if with_state else None)
        g = mod.combine_rewards(torch.as_tensor(task), style, port if with_state else None)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    np.testing.assert_allclose(mod.combine_rewards(torch.ones(2), torch.zeros(2), port).numpy(), 0.25)


def test_ring_buffer_matches_jax():
    rng = np.random.default_rng(2)
    cap, dim = 8, 3
    want, got = JaxRingBuffer.create(cap, dim), RingBuffer.create(cap, dim)
    for n in (3, 5, cap + 2, 3):
        batch = rng.normal(size=(n, dim)).astype(np.float32)
        want = want.push(jnp.asarray(batch))
        got.push(torch.as_tensor(batch))
        assert (got.head, got.size) == (int(want.head), int(want.size))
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    g = torch.Generator().manual_seed(0)
    assert got.sample(g, 5).shape == (5, dim)
    empty = RingBuffer.create(cap, dim)
    assert torch.equal(empty.sample(g, 4), torch.zeros(4, dim))   # uniform over max(size, 1)


def test_amp_state_from_jax_round_trips(jax_state):
    _, state, _ = jax_state
    s = _np(state)
    port = amp_state_from_jax(s, device="cpu")
    for p, w in disc_leaves(port.disc, s.disc_params):
        assert torch.equal(p.detach(), w)
    adam = s.disc_opt_state[0]
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        for p, w in disc_leaves(port.disc, tree):
            assert torch.equal(port.optimizer.state[p][key], w), key
    assert all(float(port.optimizer.state[p]["step"]) == float(adam.count) == 1.0 for p in port.disc.parameters())
    for k in ("mean", "var", "count"):
        np.testing.assert_array_equal(getattr(port.amp_rms, k).numpy(), getattr(s.amp_rms, k))
    for name in ("demo_buffer", "replay_buffer"):
        b, w = getattr(port, name), getattr(s, name)
        assert (b.head, b.size) == (int(w.head), int(w.size))
        np.testing.assert_array_equal(b.data.numpy(), w.data)
    assert (float(port.task_reward_w), float(port.disc_reward_w)) == (0.25, 0.75)


# --------------------------------------------------------------------------- #
# on a port env (the CPU, 1 substep)
# --------------------------------------------------------------------------- #

CFG = dict(dt=1.0 / 120.0, substeps=1, control_freq_inv=1)
SHAPES = dict(has_shape_obs=True, has_shape_obs_disc=True, has_limb_weight_obs=True)


@pytest.fixture(scope="module")
def shaped():
    """(port env, JAX env) with shape and limb channels on the same 3 clips,
    each with its own shape row; the port's store holds the JAX store's
    arrays."""
    rng = np.random.default_rng(3)
    jspec = jax_load_smpl()
    clips = jax_clips(jspec.skeleton, 3, seconds=1.0)
    for c in clips:
        c["shape_params"] = rng.normal(size=11).astype(np.float32)
        c["limb_weights"] = rng.uniform(0.5, 2.0, 10).astype(np.float32)
    jm = jax_build_motion_data(jspec.skeleton, clips)
    fields = {f.name: torch.float32 for f in dataclasses.fields(MotionData)}
    fields.update(length_starts=torch.long, motion_num_frames=torch.long)
    motion = MotionData(**{k: torch.tensor(np.asarray(getattr(jm, k)), dtype=dt) for k, dt in fields.items()})
    model = build_model(load_smpl_humanoid(), PhysicsConfig(**CFG), device="cpu")
    env = HumanoidImEnv(model, motion, EnvConfig(**SHAPES), device="cpu")
    jenv = JaxEnv(jax_build_model(jspec, JaxPhysicsConfig(**CFG)), jm, JaxEnvConfig(**SHAPES))
    return env, jenv


def test_build_motion_data_reads_clip_shape_rows():
    spec = load_smpl_humanoid()
    clips = make_synthetic_clips(spec.skeleton, 2, seconds=1.0)
    clips[1]["shape_params"] = np.arange(11, dtype=np.float32)
    m = build_motion_data(spec.skeleton, clips, device="cpu")
    assert m.shape_params.shape == (2, 11) and m.limb_weights.shape == (2, 10)
    assert torch.equal(m.shape_params[1], torch.arange(11.0)) and not m.shape_params[0].any()
    assert not m.limb_weights.any()


def test_build_demo_steps_matches_jax(shaped):
    env, jenv = shaped
    S = env.config.num_amp_obs_steps
    dt = env.model.config.control_dt
    ids = np.array([0, 1, 2, 1, 0, 2], np.int32)
    t0 = (dt * (S - 1) + np.random.default_rng(4).uniform(0, 0.6, ids.shape)).astype(np.float32)
    want = JaxAMPModule(jenv, JaxAMPConfig())._build_demo_steps(jnp.asarray(ids), jnp.asarray(t0), S)
    got = AMPModule(env, AMPConfig())._build_demo_steps(torch.as_tensor(ids, dtype=torch.long),
                                                        torch.as_tensor(t0), S)
    assert got.shape == (6, S * env.amp_obs_dim_single) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_demo_shape_channels_carry_clip_betas(shaped):
    """Each demo row's [gender, betas] and limb columns are its own clip's,
    constant across the window (zeros would give the discriminator a
    trivial agent-vs-demo tell on shape-varied training)."""
    env, _ = shaped
    amp = AMPModule(env, AMPConfig())
    demo = amp.fetch_demo(16)
    S, A = env.config.num_amp_obs_steps, env.amp_obs_dim_single
    assert demo.shape == (16, env.amp_obs_dim)
    tail = demo.reshape(16, S, A)[..., A - 21:]
    table = torch.cat([env.motion.shape_params, env.motion.limb_weights], dim=-1)
    matched = set()
    for i in range(16):
        assert torch.equal(tail[i], tail[i, :1].expand(S, -1))
        dist = (table - tail[i, 0]).abs().amax(dim=1)
        assert float(dist.min()) == 0.0
        matched.add(int(dist.argmin()))
    assert len(matched) > 1


def test_demo_pairs_nest(shaped):
    env, _ = shaped
    amp = AMPModule(env, AMPConfig())
    dt, S, A = env.model.config.control_dt, env.config.num_amp_obs_steps, env.amp_obs_dim_single
    ids, enc_t, enc_obs, t, obs = amp.fetch_demo_enc_pair(8, enc_steps=12)
    lengths = env.motion.motion_lengths[ids]
    assert enc_obs.shape == (8, 12 * A) and obs.shape == (8, S * A)
    assert (t <= enc_t + 1e-6).all() and (enc_t <= lengths + 1e-6).all()
    assert (enc_t - t <= torch.clamp(lengths, max=11 * dt) - S * dt + 1e-6).all()
    ids, t0, obs0, t1, obs1 = amp.fetch_demo_pair(8, enc_steps=12)
    lengths = env.motion.motion_lengths[ids]
    assert obs0.shape == obs1.shape == (8, 12 * A)
    assert (t0 <= t1).all() and (t1 - t0 <= 0.5 + 1e-6).all() and (t1 <= lengths + 1e-6).all()
    assert_close(obs0, amp._build_demo_steps(ids, t0, 12), rtol=0, atol=0)


@pytest.fixture(scope="module")
def env():
    spec = load_smpl_humanoid()
    model = build_model(spec, PhysicsConfig(**CFG), device="cpu")
    motion = build_motion_data(spec.skeleton, make_synthetic_clips(spec.skeleton, 2, seconds=1.0), device="cpu")
    return HumanoidImEnv(model, motion, EnvConfig(episode_length=20), device="cpu")


def test_update_merges_amp_rms_as_jax_concatenation(env):
    amp = AMPModule(env, AMPConfig(disc_units=UNITS, amp_batch_size=16, amp_buffer_size=64))
    state = amp.init()
    assert (state.demo_buffer.size, state.replay_buffer.size) == (16, 0)
    fetched = []
    real = amp.fetch_demo
    amp.fetch_demo = lambda n: fetched.append(real(n)) or fetched[-1]
    roll = torch.as_tensor(np.random.default_rng(5).normal(1.0, 2.0, (4, 8, env.amp_obs_dim)).astype(np.float32))
    rms0 = state.amp_rms
    before = [p.detach().clone() for p in state.disc.parameters()]
    state, m = amp.update(state, roll)
    want = JaxRMS(mean=jnp.asarray(rms0.mean.numpy()), var=jnp.asarray(rms0.var.numpy()),
                  count=jnp.asarray(float(rms0.count))).update(
        jnp.concatenate([jnp.asarray(roll.reshape(-1, env.amp_obs_dim).numpy()), jnp.asarray(fetched[0].numpy())]))
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(state.amp_rms, k).numpy(), np.asarray(getattr(want, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert (state.demo_buffer.size, state.replay_buffer.size) == (32, 16)
    assert all(not torch.equal(a, b) for a, b in zip(before, state.disc.parameters()))
    for k in ("disc_loss", "disc_grad_pen"):
        assert np.isfinite(float(m[k])), k
    # replay holds the unmixed rollout rows
    rows = state.replay_buffer.data[:16]
    assert all((roll.reshape(-1, env.amp_obs_dim) == r).all(dim=1).any() for r in rows)


def test_amp_dropout_zeroes_one_chunk_of_every_row(env):
    """With amp_dropout at probability 1, the loss sees agent and demo rows
    with the same contiguous chunk of int(dim * frac) columns zeroed."""
    amp = AMPModule(env, AMPConfig(disc_units=UNITS, amp_batch_size=16, amp_buffer_size=64, amp_dropout=True,
                                   amp_dropout_prob=1.0))
    state = amp.init()
    seen, real = [], amp._disc_loss
    amp._disc_loss = lambda disc, a, d, rms: seen.append((a, d)) or real(disc, a, d, rms)
    roll = torch.as_tensor(np.random.default_rng(6).uniform(1.0, 2.0, (4, 8, env.amp_obs_dim)).astype(np.float32))
    amp.update(state, roll)
    agent_rows, demo_rows = seen[0]
    cols = torch.nonzero((agent_rows == 0).all(dim=0))[:, 0]
    width = int(env.amp_obs_dim * amp.config.amp_dropout_frac)
    assert len(cols) == width and int(cols[-1] - cols[0]) == width - 1 and not (agent_rows == 0).all(dim=1).any()
    assert (demo_rows[:, cols] == 0).all()


def _agent(env, **kw) -> AMPAgent:
    net = ActorCritic(env.obs_dim, env.action_dim, actor_units=(32,), critic_units=(32,), device="cpu")
    return AMPAgent(env, PPOConfig(num_envs=4, horizon_length=4, minibatch_size=8, mini_epochs=1),
                    AMPConfig(amp_batch_size=8, amp_buffer_size=64, disc_units=(32,)), net, seed=1, **kw)


def test_getup_weight_schedule(env):
    agent = _agent(env, getup_update_epoch=100)
    ts = agent.init()
    assert (float(ts.amp.task_reward_w), float(ts.amp.disc_reward_w)) == (0.0, 1.0)
    ts = agent.pre_epoch(ts, 50)
    assert float(ts.amp.task_reward_w) == 0.0
    ts = agent.pre_epoch(ts, 101)
    assert (float(ts.amp.task_reward_w), float(ts.amp.disc_reward_w)) == (0.5, 0.5)
    np.testing.assert_allclose(agent.amp.combine_rewards(torch.ones(3), torch.zeros(3), ts.amp).numpy(), 0.5)


def test_getup_env_phase_flip(env):
    from pulse_tpu_torch.env.humanoid_amp_getup import HumanoidAMPGetupEnv

    genv = HumanoidAMPGetupEnv(env.model, env.motion, GetupConfig(episode_length=20, num_fall_states=4,
                                                                  fall_settle_steps=2), device="cpu")
    agent = _agent(genv, getup_update_epoch=1)
    ts = agent.init()
    agent.pre_epoch(ts, 1)
    assert (genv.config.fall_init_prob, genv.config.recovery_episode_prob) == (1.0, 0.0)
    assert not genv.set_getup_phase(False)
    agent.pre_epoch(ts, 2)
    assert (genv.config.fall_init_prob, genv.config.recovery_episode_prob) == (0.1, 0.3)


def test_shape_resample_schedule(env):
    senv = HumanoidImEnv(env.model, env.motion, EnvConfig(episode_length=20), device="cpu")
    agent = _agent(senv, shape_resampling_interval=10)
    senv.enable_shape_variation(4)
    ts = agent.init()
    before = senv.batched_model.body_mass.clone()
    agent.pre_epoch(ts, 5)          # off the interval
    assert torch.equal(senv.batched_model.body_mass, before)
    agent.pre_epoch(ts, 11)         # epoch % 10 == 1
    assert not torch.equal(senv.batched_model.body_mass, before)
    # a batched model neither from shape variation nor from domain
    # randomization's props is left as it is, as in the JAX package (the
    # props' re-draw: tests/test_torch_domain_rand.py)
    senv._shape_args = None
    kept = senv.batched_model
    agent.pre_epoch(ts, 21)
    assert senv.batched_model is kept


def test_recurrent_network_raises(env):
    """A recurrent network trains (tests/test_torch_rnn.py); what still
    raises is a horizon that its BPTT sequences do not divide."""
    net = RNNActorCritic(env.obs_dim, env.action_dim, trunk_units=(8,), rnn_size=4, device="cpu")
    with pytest.raises(ValueError, match="divisible by seq_len"):
        AMPAgent(env, PPOConfig(horizon_length=6, seq_len=4), network=net)
    assert AMPAgent(env, PPOConfig(horizon_length=8, seq_len=4), network=net).ppo.recurrent


def test_amp_agent_epoch(env):
    """Finite metrics, the discriminator changed, buffers and amp_rms grown
    as one epoch's update grows them, the recorded AMP windows the env's
    post-merge history, and the mix 0.5 task + 0.5 style."""
    agent = _agent(env)
    ts = agent.init()
    disc0 = [p.detach().clone() for p in ts.amp.disc.parameters()]
    count0 = float(ts.amp.amp_rms.count)
    ts, m = agent.train_epoch(ts)
    for k in ("a_loss", "c_loss", "disc_loss", "disc_grad_pen", "reward_mean", "task_reward_mean",
              "disc_reward_mean", "rollout_s", "disc_reward_s", "gae_s", "update_s", "disc_update_s"):
        assert np.isfinite(float(m[k])), k
    for k in ("disc_acc_agent", "disc_acc_demo"):
        assert 0.0 <= float(m[k]) <= 1.0
    assert all(not torch.equal(a, b) for a, b in zip(disc0, ts.amp.disc.parameters()))
    assert (ts.amp.demo_buffer.size, ts.amp.replay_buffer.size) == (16 + 8, 8)
    assert float(ts.amp.amp_rms.count) == pytest.approx(count0 + 4 * 4 + 8)
    assert_close(agent.ppo.amp_obs[-1], ts.ppo.env_state.amp_hist.flatten(1), rtol=0, atol=0)
    r = agent.last_rewards
    assert_close(r["mixed"], 0.5 * r["task"] + 0.5 * r["disc"])
    assert ts.ppo.epoch == 1


def test_joint_amp_distill_epoch(env):
    agent = _agent(env)
    vae = PulseVAE(env.obs_dim, env.action_dim, latent_dim=8, self_obs_dim=env.self_obs_dim, encoder_units=(32,),
                   prior_units=(16,), decoder_units=(32,), critic_units=(32,), device="cpu")
    teacher_calls = []

    def teacher(obs):
        teacher_calls.append(obs.shape)
        return torch.zeros(obs.shape[:-1] + (env.action_dim,))

    dist = DistillAgent(env, teacher, DistillConfig(num_envs=4, horizon_length=4, minibatch_size=8, mini_epochs=1),
                        vae, seed=3)
    joint = JointAMPDistillAgent(agent, dist)
    ts = joint.init()
    steps = []
    real = env.step
    env.step = lambda s, a: steps.append(1) or real(s, a)
    try:
        ts, m = joint.train_epoch(ts)
    finally:
        del env.step
    assert len(steps) == 4 and teacher_calls == [(4, 4, env.obs_dim)]   # one rollout feeds both updates
    for k in ("disc_loss", "reward_mean", "kin_bc_loss", "kin_kld"):
        assert np.isfinite(float(m[k])), k
    assert ts.amp.amp.replay_buffer.size == 8 and ts.distill.epoch == 1 and ts.amp.ppo.epoch == 1
