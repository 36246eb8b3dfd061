"""The port's recurrent policy path against the JAX package's on the CPU,
with inputs from a numpy seed and float32 JAX networks (obs 12, trunk
(32, 24), LSTM 16, 5 actions; the slice tests at the SMPL env's widths
with trunk (32,) and LSTM 16):

  * `RNNActorCritic` from `rnn_actor_critic_from_jax`: three steps of carry
    and outputs, with `done` resets, and a reset env's output that of a
    zero carry: 1e-5 relative (atol 1e-6);
  * `rnn_loss` and its gradients against `jax.value_and_grad(_loss_rnn)`:
    the loss terms 1e-5, the gradients 1e-5 absolute with 1e-4 relative
    (sums over the BPTT steps in another order);
  * `update_rnn` from a train state converted by `train_state_from_jax`
    (Adam one step in, carry included), on a hand-built rollout whose
    carries and neg-log-probs are the policy's own (perturbed), with one
    mini-epoch of one minibatch of all sequences, so that the permutation
    drops out; `truncate_grads` on at a grad_norm of 0.05 that makes the
    clip scale the step, `temp_running_mean` off (the slice test runs each
    the other way).
    As for the feed-forward update (tests/test_torch_ppo.py): the norms
    1e-5 relative, the metrics 1e-4 relative or 1e-5 absolute (the
    surrogate is a mean of unit-scale normalized advantages that cancels
    to ~1e-3, so its float32 sum carries ~1e-6), the parameter steps 1e-4
    relative or 1e-3 of the learning rate (Adam's normalized step
    amplifies rounding in near-zero gradients), Adam's moments 1e-4
    relative or 1e-4 of their tensor's largest;
  * the slice: a recurrent `PPOAgent.train_epoch` on a 4-env
    `HumanoidImEnv` (horizon 4, seq_len 2): its recorded carries, mu,
    neg-log-probs and values against the JAX network replayed over the
    recorded obs and entry resets (1e-5 relative, atol 1e-6), its GAE
    against JAX's on that rollout, and its update against JAX's
    `update_rnn` on it (the tolerances above, but that this update is
    Adam's first step, lr g / (|g| + 1e-8), so 0.1% of a tensor's elements,
    whose gradients lie within a few 1e-8 of zero, may differ by up to 5%
    of lr). The env step's own parity is
    tests/test_torch_env.py's;
  * two epochs of a recurrent `AMPAgent` on the CPU: finite metrics, the
    second rollout starting from the first one's carry.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from pulse_tpu.learning.networks import RNNActorCritic as JaxRNN
from pulse_tpu.learning.ppo import PPOAgent as JaxPPOAgent, PPOConfig as JaxPPOConfig, Rollout as JaxRollout
from pulse_tpu.learning.ppo import TrainState as JaxTrainState, gaussian_neglogp as jax_neglogp
from pulse_tpu.learning.running_norm import RunningMeanStd as JaxRMS

from jax_reference import module_reference_compiles, reference_jit

from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.env.humanoid_im import EnvConfig, HumanoidImEnv
from pulse_tpu_torch.learning.amp import AMPConfig
from pulse_tpu_torch.learning.amp_agent import AMPAgent
from pulse_tpu_torch.learning.networks import RNNActorCritic, rnn_actor_critic_from_jax, rnn_leaves
from pulse_tpu_torch.learning.ppo import PPOAgent, PPOConfig, Rollout, compute_gae, rnn_loss, train_state_from_jax
from pulse_tpu_torch.motion.motion_lib import build_motion_data
from pulse_tpu_torch.motion.synthetic import make_synthetic_clips
from pulse_tpu_torch.physics.model import PhysicsConfig, build_model

# every JAX compile of this module's references at -O0 (tests/jax_reference.py)
reference_compiles_in_module = module_reference_compiles()

T, B, O, A, H = 8, 6, 12, 5, 16
L = 4
TRUNK = (32, 24)
TOL = dict(rtol=1e-5, atol=1e-6)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def f32(x):
    return np.asarray(x, np.float32)


class _Net:
    """A JAX RNNActorCritic with its init and apply compiled once."""

    def __init__(self, obs_dim=O, action_dim=A, trunk=TRUNK):
        self.net = JaxRNN(action_dim=action_dim, trunk_units=trunk, rnn_size=H, dtype=jnp.float32)
        self.obs_dim = obs_dim
        self._init = reference_jit(self.net.init)
        self.apply = reference_jit(lambda p, c, o, d: self.net.apply({"params": p}, c, o, d))

    def params(self, seed):
        carry = self.net.initial_carry((1,))
        return _np_tree(self._init(jax.random.PRNGKey(seed), carry, jnp.zeros((1, self.obs_dim)))["params"])


NET = _Net()


def _replay(net, params, carry0, obs_norm, dones):
    """The JAX cell of `net` (a _Net) stepped over [T, B] obs from carry0
    with the entry resets: (carries at entry [T, B, H] x2, mu, log_sigma,
    value_norm), and the carry after the last step."""
    step = lambda c, o, d: net.apply(params, c, o, d)   # noqa: E731
    carry, entry, mus, values = carry0, ([], []), [], []
    for t in range(obs_norm.shape[0]):
        entry[0].append(np.asarray(carry[0]))
        entry[1].append(np.asarray(carry[1]))
        carry, (mu, log_sigma, value) = step(carry, jnp.asarray(obs_norm[t]), jnp.asarray(dones[t]))
        mus.append(np.asarray(mu))
        values.append(np.asarray(value))
    return (np.stack(entry[0]), np.stack(entry[1])), np.stack(mus), np.asarray(log_sigma), np.stack(values), carry


# --------------------------------------------------------------------------- #
# the network
# --------------------------------------------------------------------------- #

def test_rnn_forward_and_carry_match_jax():
    params = NET.params(0)
    params["OptimizedLSTMCell_0"]["hf"]["bias"] = f32(np.linspace(-0.5, 0.5, H))   # a bias on each gate's path
    rng = np.random.default_rng(0)
    port = rnn_actor_critic_from_jax(params, device="cpu")
    assert port.is_recurrent and port.rnn_size == H
    carry_j = (jnp.asarray(f32(rng.standard_normal((B, H)))), jnp.asarray(f32(rng.standard_normal((B, H)))))
    carry_p = tuple(torch.tensor(np.asarray(c)) for c in carry_j)
    apply = lambda c, o, d: NET.apply(params, c, o, d)   # noqa: E731
    for step, done in enumerate(([False] * B, [False, True, False, True, False, False], [True] + [False] * (B - 1))):
        obs = f32(1.5 * rng.standard_normal((B, O)))
        done = np.asarray(done)
        carry_j, (mu_j, ls_j, v_j) = apply(carry_j, jnp.asarray(obs), jnp.asarray(done))
        with torch.no_grad():
            carry_p, (mu, ls, v) = port(carry_p, torch.as_tensor(obs), torch.as_tensor(done))
        for got, want, name in ((carry_p[0], carry_j[0], "c"), (carry_p[1], carry_j[1], "h"), (mu, mu_j, "mu"),
                                (v, v_j, "value"), (ls, ls_j, "log_sigma")):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"step {step} {name}", **TOL)
    # a reset env's output is a fresh carry's
    obs = torch.as_tensor(f32(rng.standard_normal((B, O))))
    done = torch.tensor([False, True, False, False, True, False])
    with torch.no_grad():
        (c_d, h_d), (mu_d, _, v_d) = port(carry_p, obs, done)
        (c_0, h_0), (mu_0, _, v_0) = port(port.initial_carry(B), obs)
    for got, want in ((c_d, c_0), (h_d, h_0), (mu_d, mu_0), (v_d, v_0)):
        np.testing.assert_allclose(got[done].numpy(), want[done].numpy(), **TOL)
        assert (got[~done] - want[~done]).abs().max() > 1e-4


# --------------------------------------------------------------------------- #
# the BPTT loss
# --------------------------------------------------------------------------- #

LOSS_CFG = dict(entropy_coef=0.01, seq_len=L)


@pytest.fixture(scope="module")
def loss_case():
    """(params, batch, obs stats, {normalize_value: JAX (loss, metrics),
    grads}): both configs' references in one program."""
    params = NET.params(1)
    params["Dense_0"]["bias"] = f32([1.3, -1.4, 0.0, 0.5, -2.0])    # |mu| past the bound loss's 1.1
    rng = np.random.default_rng(2)
    mb = 6
    rms = JaxRMS(mean=jnp.asarray(f32(rng.uniform(-0.5, 0.5, O))), var=jnp.asarray(f32(rng.uniform(0.5, 2, O))),
                 count=jnp.asarray(30.0))
    batch = {
        "obs": f32(1.5 * rng.standard_normal((mb, L, O))),
        "actions": f32(0.2 * rng.standard_normal((mb, L, A))),
        "neglogp": f32(rng.uniform(-5, 5, (mb, L))),
        "advantages": f32(rng.standard_normal((mb, L))),
        "returns": f32(rng.standard_normal((mb, L))),
        "returns_norm": f32(rng.standard_normal((mb, L))),
        "prev_dones": rng.uniform(size=(mb, L)) < 0.3,
        "hidden": (f32(rng.standard_normal((mb, H))), f32(rng.standard_normal((mb, H)))),
    }
    agents = {nv: JaxPPOAgent(types.SimpleNamespace(action_dim=A), JaxPPOConfig(normalize_value=nv, **LOSS_CFG),
                              NET.net) for nv in (True, False)}
    refs = reference_jit(lambda p, b: {nv: jax.value_and_grad(a._loss_rnn, has_aux=True)(p, b, rms, None)
                                       for nv, a in agents.items()})(params, jax.tree.map(jnp.asarray, batch))
    return params, batch, rms, refs


@pytest.mark.parametrize("normalize_value", [True, False])
def test_rnn_loss_and_gradients_match_jax(loss_case, normalize_value):
    params, batch, rms, refs = loss_case
    (total_j, m_j), g_j = refs[normalize_value]
    cfg = dict(normalize_value=normalize_value, **LOSS_CFG)
    tnet = rnn_actor_critic_from_jax(params, device="cpu")
    port_batch = {k: (tuple(map(torch.as_tensor, v)) if k == "hidden" else torch.as_tensor(v))
                  for k, v in batch.items() if k != "obs"}
    port_batch["obs_norm"] = torch.as_tensor(np.asarray(rms.normalize(jnp.asarray(batch["obs"]))))
    total, m = rnn_loss(PPOConfig(**cfg), tnet, port_batch)
    total.backward()
    assert float(m_j["b_loss"]) > 0.1 and batch["prev_dones"][:, 1:].any()
    np.testing.assert_allclose(float(total.detach()), float(total_j), rtol=1e-5, atol=1e-5)
    for k in ("a_loss", "c_loss", "b_loss", "entropy"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    for p, want in rnn_leaves(tnet, _np_tree(g_j)):
        np.testing.assert_allclose(p.grad.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------- #
# the update
# --------------------------------------------------------------------------- #

def _rollout(seed, net, params, obs_rms, value_rms):
    """A [T, B] rollout whose carries are the policy's own on its obs and
    resets and whose neg-log-probs and values are the policy's, the
    neg-log-probs perturbed so that the PPO ratio sits near 1."""
    rng = np.random.default_rng(seed)
    r = dict(obs=f32(1.5 * rng.standard_normal((T, B, O)) + 0.3), actions=f32(0.3 * rng.standard_normal((T, B, A))),
             rewards=f32(rng.uniform(0, 1, (T, B))), dones=rng.uniform(size=(T, B)) < 0.2)
    r["terminates"] = r["dones"] & (rng.uniform(size=(T, B)) < 0.5)
    r["prev_dones"] = np.concatenate([np.zeros((1, B), bool), r["dones"][:-1]])
    carry0 = tuple(jnp.asarray(f32(0.5 * rng.standard_normal((B, H)))) for _ in range(2))
    hid, mu, ls, v, carry = _replay(net, params, carry0, np.asarray(obs_rms.normalize(jnp.asarray(r["obs"]))),
                                    r["prev_dones"])
    nl = np.asarray(jax_neglogp(jnp.asarray(mu), jnp.asarray(ls), jnp.asarray(r["actions"])))
    r.update(hiddens=hid, neglogp=f32(nl + 0.05 * rng.standard_normal((T, B))),
             values=f32(np.asarray(value_rms.denormalize(jnp.asarray(v)[..., None]))[..., 0]))
    return r, f32(rng.standard_normal(B)), carry


def _jax_rollout(r):
    z = jnp.zeros(r["rewards"].shape + (1,))
    return JaxRollout(**{k: jax.tree.map(jnp.asarray, r[k]) for k in ("obs", "actions", "neglogp", "values", "rewards",
                                                                        "dones", "terminates", "hiddens",
                                                                        "prev_dones")},
                      amp_obs=z, mus=z)


def _port_rollout(r):
    return Rollout(**{k: torch.as_tensor(r[k]) for k in ("obs", "actions", "neglogp", "values", "rewards", "dones",
                                                          "terminates", "prev_dones")},
                   hiddens=tuple(torch.as_tensor(h) for h in r["hiddens"]))


def _check_update(got, m, want, m_j, before, lr, step_outliers=0.0):
    """The port's state after update_rnn against JAX's (module docstring's
    tolerances); a fraction `step_outliers` of each parameter's elements
    may miss the step tolerance by up to 5% of lr."""
    for k in ("a_loss", "c_loss", "b_loss", "entropy"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    for name in ("obs_rms", "value_rms"):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(getattr(got, name), f).numpy(),
                                       np.asarray(getattr(getattr(want, name), f)), rtol=1e-5, err_msg=f"{name}.{f}")
    jparams = dict(rnn_leaves(got.network, _np_tree(want.params)))
    for (name, p), p0 in zip(got.network.named_parameters(), before):
        step_got, step_want = (p - p0).detach().numpy(), (jparams[p] - p0).numpy()
        assert np.abs(step_want).max() > 0.1 * lr
        miss = np.abs(step_got - step_want) > 1e-4 * np.abs(step_want) + 1e-3 * lr
        assert miss.mean() <= step_outliers, (name, int(miss.sum()), np.abs(step_got - step_want).max() / lr)
        np.testing.assert_allclose(step_got, step_want, rtol=0, atol=5e-2 * lr if step_outliers else 1e-3 * lr,
                                   err_msg=name)
    adam = want.opt_state[1][0]
    assert isinstance(adam, optax.ScaleByAdamState)
    mu, nu = dict(rnn_leaves(got.network, _np_tree(adam.mu))), dict(rnn_leaves(got.network, _np_tree(adam.nu)))
    for p in got.network.parameters():
        state = got.optimizer.state[p]
        assert float(state["step"]) == float(adam.count)
        for got_m, want_m in ((state["exp_avg"], mu[p]), (state["exp_avg_sq"], nu[p])):
            np.testing.assert_allclose(got_m.numpy(), want_m.numpy(), rtol=1e-4, atol=1e-4 * float(want_m.abs().max()))


def test_update_rnn_from_converted_state_matches_jax():
    """truncate_grads on at a grad_norm that scales every step, and
    temp_running_mean off: the loss on the updated obs stats (the slice
    test below runs them the other way round)."""
    lr = 1e-3
    cfg = dict(mini_epochs=1, minibatch_size=T * B, learning_rate=lr, grad_norm=0.05, entropy_coef=0.0, seq_len=L,
               truncate_grads=True, temp_running_mean=False)
    agent = JaxPPOAgent(types.SimpleNamespace(action_dim=A), JaxPPOConfig(**cfg), NET.net)
    params = NET.params(1)
    rms0 = JaxRMS(mean=jnp.full(O, 0.2), var=jnp.full(O, 1.7), count=jnp.asarray(50.0))
    vrms0 = JaxRMS(mean=jnp.full(1, 0.1), var=jnp.full(1, 0.8), count=jnp.asarray(50.0))
    ts = JaxTrainState(params=params, opt_state=agent.optimizer.init(params), obs_rms=rms0, value_rms=vrms0,
                       env_state=None, key=jax.random.PRNGKey(2), epoch=jnp.asarray(0))
    update = reference_jit(lambda ts_, roll, last: agent.update_rnn(ts_, roll, *agent.compute_gae(roll, last)))
    # a first JAX update gives Adam non-zero moments and a step count of 1
    r0, last0, carry = _rollout(3, NET, params, rms0, vrms0)
    ts, _ = update(ts, _jax_rollout(r0), jnp.asarray(last0))
    ts = ts.replace(hidden=carry)

    r1, last1, _ = _rollout(4, NET, _np_tree(ts.params), ts.obs_rms, ts.value_rms)
    port_ts = train_state_from_jax(_np_tree(ts), learning_rate=lr, device="cpu")
    assert isinstance(port_ts.network, RNNActorCritic)
    for got_h, want_h in zip(port_ts.hidden, carry):
        np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    before = [p.detach().clone() for p in port_ts.network.parameters()]
    want, m_j = update(ts, _jax_rollout(r1), jnp.asarray(last1))

    port = PPOAgent(types.SimpleNamespace(device=torch.device("cpu"), obs_dim=O, action_dim=A),
                    PPOConfig(**cfg), network=port_ts.network)
    assert port.recurrent
    roll = _port_rollout(r1)
    got, m = port.update(port_ts, roll, *compute_gae(port.config, roll, torch.as_tensor(last1)))
    assert got.epoch == 2 and int(want.epoch) == 2
    _check_update(got, m, want, m_j, before, lr)


def test_horizon_must_divide_by_seq_len():
    net = RNNActorCritic(O, A, trunk_units=(8,), rnn_size=4, device="cpu")
    with pytest.raises(ValueError, match="divisible by seq_len"):
        PPOAgent(types.SimpleNamespace(device=torch.device("cpu"), obs_dim=O, action_dim=A),
                 PPOConfig(horizon_length=6, seq_len=4), network=net)


# --------------------------------------------------------------------------- #
# the slice: a recurrent train_epoch on the SMPL env
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def env():
    spec = load_smpl_humanoid()
    model = build_model(spec, PhysicsConfig(dt=1.0 / 120.0, substeps=1, control_freq_inv=1), device="cpu")
    motion = build_motion_data(spec.skeleton, make_synthetic_clips(spec.skeleton, 2, seconds=1.0), device="cpu")
    return HumanoidImEnv(model, motion, EnvConfig(cycle_motion=True, episode_length=3), device="cpu")


def test_train_epoch_matches_jax_replay_and_update(env):
    """One recurrent PPOAgent.train_epoch: what its rollout recorded is the
    JAX network replayed over the recorded obs and entry resets, and its
    GAE and update are JAX's on that rollout. A cycled episode of 3 steps puts resets
    inside the horizon and inside a sequence."""
    lr = 1e-3
    nenv, horizon = 4, 4
    # truncate_grads off and temp_running_mean on (the update test above
    # runs them the other way round)
    cfg = dict(num_envs=nenv, horizon_length=horizon, seq_len=2, minibatch_size=nenv * horizon, mini_epochs=1,
               learning_rate=lr, truncate_grads=False)
    jnet = _Net(env.obs_dim, env.action_dim, trunk=(32,))
    params = jnet.params(5)
    jagent = JaxPPOAgent(types.SimpleNamespace(action_dim=env.action_dim), JaxPPOConfig(**cfg), jnet.net)
    net = rnn_actor_critic_from_jax(params, device="cpu")
    agent = PPOAgent(env, PPOConfig(**cfg), network=net, seed=3)
    ts = agent.init()
    mus, seen = [], {}
    hook = net.mu.register_forward_hook(lambda mod, inp, out: mus.append(out.detach().clone()))
    real_update = agent.update

    def spy(ts_, roll, adv, ret):
        seen.update(roll={k: (tuple(h.clone() for h in v) if isinstance(v, tuple) else v.clone())
                          for k, v in vars(roll).items()},
                    adv=adv.clone(), ret=ret.clone(), hidden=tuple(h.clone() for h in ts_.hidden))
        return real_update(ts_, roll, adv, ret)

    agent.update = spy
    try:
        ts, m = agent.train_epoch(ts)
    finally:
        hook.remove()
    r = {k: (tuple(h.numpy() for h in v) if isinstance(v, tuple) else v.numpy()) for k, v in seen["roll"].items()}
    assert r["dones"][:-1].any() and r["prev_dones"][1:].any() and not r["prev_dones"][0].any()

    obs_rms0, vrms0 = JaxRMS.create(env.obs_dim), JaxRMS.create(1)
    zero = jagent.network.initial_carry((nenv,))
    hid, mu_j, ls_j, v_j, carry = _replay(jnet, params, zero, np.asarray(obs_rms0.normalize(jnp.asarray(r["obs"]))),
                                          r["prev_dones"])
    for got, want, name in ((r["hiddens"][0], hid[0], "c"), (r["hiddens"][1], hid[1], "h"),
                            (torch.stack(mus[:horizon]).numpy(), mu_j, "mu"),
                            (r["neglogp"], jax_neglogp(jnp.asarray(mu_j), jnp.asarray(ls_j), jnp.asarray(r["actions"])),
                             "neglogp"),
                            (r["values"], np.asarray(vrms0.denormalize(jnp.asarray(v_j)[..., None]))[..., 0], "values"),
                            (seen["hidden"][0].numpy(), carry[0], "final c"), (seen["hidden"][1].numpy(), carry[1],
                                                                               "final h")):
        np.testing.assert_allclose(got, np.asarray(want), err_msg=name, **TOL)

    # the bootstrap through the cell, GAE, then the update on this rollout
    st = ts.env_state
    _, (_, _, last_norm) = jnet.apply(params, carry, obs_rms0.normalize(jnp.asarray(st.obs.numpy())),
                                      jnp.asarray(st.done.numpy()))
    jts = JaxTrainState(params=params, opt_state=jagent.optimizer.init(params), obs_rms=obs_rms0, value_rms=vrms0,
                        env_state=None, key=jax.random.PRNGKey(0), epoch=jnp.asarray(0), hidden=carry)

    def gae_update(ts_, roll, last):
        gae = jagent.compute_gae(roll, last)
        return gae, jagent.update_rnn(ts_, roll, *gae)

    (adv_j, ret_j), (want, m_j) = reference_jit(gae_update)(jts, _jax_rollout(r), vrms0.denormalize(
        last_norm[..., None])[..., 0])
    np.testing.assert_allclose(seen["adv"].numpy(), np.asarray(adv_j), **TOL)
    np.testing.assert_allclose(seen["ret"].numpy(), np.asarray(ret_j), **TOL)
    fresh = rnn_actor_critic_from_jax(params, device="cpu")
    # Adam's first step is lr g / (|g| + 1e-8): where a weight's gradient is
    # within a few 1e-8 of zero (obs columns near zero in all 16 rows) the
    # gradients' float32 rounding moves its step by a few % of lr
    _check_update(ts, m, want, m_j, [p.detach() for p in fresh.parameters()], lr, step_outliers=1e-3)
    for k in ("reward_mean", "episode_done_frac", "rollout_s", "update_s"):
        assert np.isfinite(float(m[k])), k


def test_amp_agent_two_recurrent_epochs(env):
    """Two epochs of a recurrent AMPAgent: finite metrics, the AMP windows
    recorded, the second rollout starting from the first's final carry."""
    net = RNNActorCritic(env.obs_dim, env.action_dim, trunk_units=(32,), rnn_size=H, device="cpu")
    agent = AMPAgent(env, PPOConfig(num_envs=4, horizon_length=4, seq_len=2, minibatch_size=8, mini_epochs=1),
                     AMPConfig(amp_batch_size=8, amp_buffer_size=64, disc_units=(32,)), net, seed=1)
    assert agent.ppo.recurrent
    ts = agent.init()
    for epoch in range(2):
        carry = tuple(h.clone() for h in ts.ppo.hidden)
        ts, m = agent.train_epoch(ts)
        roll = agent.ppo._buffers
        for got, want in zip(roll.hiddens, carry):
            assert torch.equal(got[0], want)
        assert not all(torch.equal(a, b) for a, b in zip(ts.ppo.hidden, carry))
        for k in ("a_loss", "c_loss", "disc_loss", "disc_grad_pen", "reward_mean", "disc_reward_mean", "update_s"):
            assert np.isfinite(float(m[k])), (epoch, k)
        assert torch.equal(agent.ppo.amp_obs[-1], ts.ppo.env_state.amp_hist.flatten(1))
    assert ts.ppo.epoch == 2 and ts.amp.replay_buffer.size == 16
