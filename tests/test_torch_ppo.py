"""The port's PPO pieces against the JAX package's on the CPU, with inputs
from a numpy seed: `compute_gae`, `RunningMeanStd.update`, the PPO loss and
its gradients on a narrow float32 ActorCritic (units (32, 24)), and one
`update` (one mini-epoch, one minibatch of the whole rollout) started from
a JAX train state converted by `train_state_from_jax`, with the global-norm
clip and the epoch-start obs stats (`truncate_grads`, `temp_running_mean`)
on and off.

Tolerances (float32, sums in another order): GAE and the running moments
1e-5 relative; the loss terms 1e-5 and the gradients 1e-5 absolute with
1e-4 relative; after one Adam step the parameter changes (each about the
learning rate) 1e-4 relative or 1e-3 of the learning rate (Adam's
normalized step amplifies rounding in near-zero gradients), and the new
Adam moments 1e-4 relative or 1e-4 of the largest moment of their tensor.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp

import optax
import pytest
import torch

from pulse_tpu.learning.networks import ActorCritic as JaxActorCritic
from pulse_tpu.learning.ppo import PPOAgent as JaxPPOAgent, PPOConfig as JaxPPOConfig, Rollout as JaxRollout
from pulse_tpu.learning.ppo import TrainState as JaxTrainState
from pulse_tpu.learning.running_norm import RunningMeanStd as JaxRMS

from jax_reference import module_reference_compiles

from pulse_tpu_torch.learning.networks import actor_critic_from_jax, flax_leaves
from pulse_tpu_torch.learning.ppo import PPOAgent, PPOConfig, Rollout, compute_gae, ppo_loss, train_state_from_jax
from pulse_tpu_torch.learning.running_norm import RunningMeanStd

# every JAX compile of this module's references at -O0 (tests/jax_reference.py)
reference_compiles_in_module = module_reference_compiles()

T, B, O, A = 8, 6, 12, 5
UNITS = (32, 24)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def f32(x):
    return np.asarray(x, np.float32)


def _rollout(seed, net=None, params=None, obs_rms=None):
    """A [T, B] rollout; with a network its neg-log-probs are those of its
    own policy, perturbed, so that the PPO ratio sits near 1."""
    rng = np.random.default_rng(seed)
    r = dict(
        obs=f32(1.5 * rng.standard_normal((T, B, O)) + 0.3),
        actions=f32(0.3 * rng.standard_normal((T, B, A))),
        values=f32(rng.standard_normal((T, B))),
        rewards=f32(rng.uniform(0, 1, (T, B))),
        dones=rng.uniform(size=(T, B)) < 0.2,
    )
    r["terminates"] = r["dones"] & (rng.uniform(size=(T, B)) < 0.5)
    if net is None:
        r["neglogp"] = f32(rng.standard_normal((T, B)))
    else:
        mu, ls, _ = net.apply({"params": params}, obs_rms.normalize(jnp.asarray(r["obs"])))
        nl = 0.5 * jnp.sum(((r["actions"] - mu) / jnp.exp(ls)) ** 2, -1) + jnp.sum(ls) + 0.5 * A * np.log(2 * np.pi)
        r["neglogp"] = f32(np.asarray(nl) + 0.05 * rng.standard_normal((T, B)))
    return r, f32(rng.standard_normal(B))


def _jax_rollout(r):
    z = jnp.zeros((T, B, 1))
    return JaxRollout(obs=jnp.asarray(r["obs"]), actions=jnp.asarray(r["actions"]), neglogp=jnp.asarray(r["neglogp"]),
                      values=jnp.asarray(r["values"]), rewards=jnp.asarray(r["rewards"]), dones=jnp.asarray(r["dones"]),
                      terminates=jnp.asarray(r["terminates"]), amp_obs=z, mus=z)


def _port_rollout(r):
    return Rollout(**{k: torch.as_tensor(r[k]) for k in ("obs", "actions", "neglogp", "values", "rewards", "dones",
                                                          "terminates")})


def _jax_agent(**cfg):
    net = JaxActorCritic(action_dim=A, actor_units=UNITS, critic_units=UNITS, dtype=jnp.float32)
    return JaxPPOAgent(types.SimpleNamespace(action_dim=A), JaxPPOConfig(**cfg), net), net


# --------------------------------------------------------------------------- #
# (c) GAE and the running normalizer
# --------------------------------------------------------------------------- #

def test_compute_gae_matches_jax():
    r, last = _rollout(0)
    agent, _ = _jax_agent()
    adv_j, ret_j = agent.compute_gae(_jax_rollout(r), jnp.asarray(last))
    adv, ret = compute_gae(PPOConfig(), _port_rollout(r), torch.as_tensor(last))
    assert r["terminates"].any() and (r["dones"] & ~r["terminates"]).any()
    np.testing.assert_allclose(adv.numpy(), np.asarray(adv_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ret.numpy(), np.asarray(ret_j), rtol=1e-5, atol=1e-6)


def test_running_mean_std_update_matches_jax():
    rng = np.random.default_rng(1)
    port, ref = RunningMeanStd.create(7, device="cpu"), JaxRMS.create(7)
    for n in (64, 3, 200):
        x = (rng.standard_normal((n, 7)) * rng.uniform(0.1, 10, 7) + rng.uniform(-5, 5, 7)).astype(np.float32)
        port, ref = port.update(torch.as_tensor(x)), ref.update(jnp.asarray(x))
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(port, f).numpy(), np.asarray(getattr(ref, f)), rtol=1e-5, err_msg=f)


# --------------------------------------------------------------------------- #
# (d) the loss and its gradients
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("normalize_value", [True, False])
def test_loss_and_gradients_match_jax(normalize_value):
    agent, net = _jax_agent(normalize_value=normalize_value, entropy_coef=0.01)
    rng = np.random.default_rng(2)
    obs = rng.standard_normal((32, O)).astype(np.float32)
    params = _np_tree(jax.jit(net.init)(jax.random.PRNGKey(0), jnp.asarray(obs))["params"])
    batch = {
        "obs_norm": obs,
        # some |mu| beyond the bound loss's 1.1 needs mu-scale actions; the
        # mu head starts near 0, so the bound term is exercised by a shift
        "actions": (0.2 * rng.standard_normal((32, A))).astype(np.float32),
        "neglogp": rng.uniform(-5, 5, 32).astype(np.float32),
        "advantages": rng.standard_normal(32).astype(np.float32),
        "returns": rng.standard_normal(32).astype(np.float32),
        "returns_norm": rng.standard_normal(32).astype(np.float32),
    }
    params["Dense_0"]["bias"] = np.asarray([1.3, -1.4, 0.0, 0.5, -2.0], np.float32)
    (total_j, m_j), g_j = jax.value_and_grad(agent._loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, None)

    tnet = actor_critic_from_jax(params, device="cpu")
    total, m = ppo_loss(agent.config, tnet, {k: torch.as_tensor(v) for k, v in batch.items()})
    total.backward()
    assert float(m_j["b_loss"]) > 0.1
    np.testing.assert_allclose(float(total.detach()), float(total_j), rtol=1e-5, atol=1e-5)
    for k in ("a_loss", "c_loss", "b_loss", "entropy"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    for p, want in flax_leaves(tnet, _np_tree(g_j)):
        np.testing.assert_allclose(p.grad.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------- #
# (e) one update from a converted JAX train state
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("grad_norm", [50.0, 0.05])     # the clip idle, and the clip scaling every step
def test_update_from_converted_state_matches_jax(grad_norm):
    _update_matches_jax(grad_norm=grad_norm)


def test_update_without_clip_or_temp_running_mean_matches_jax():
    """truncate_grads off (no clip at a grad_norm that would scale every
    step) and temp_running_mean off (the loss reads the updated obs stats)."""
    _update_matches_jax(grad_norm=0.05, truncate_grads=False, temp_running_mean=False)


def _update_matches_jax(**switches):
    lr = 1e-3
    cfg = dict(mini_epochs=1, minibatch_size=T * B, learning_rate=lr, entropy_coef=0.0, **switches)
    agent, net = _jax_agent(**cfg)
    params = jax.jit(net.init)(jax.random.PRNGKey(1), jnp.zeros((1, O)))["params"]
    rms0 = JaxRMS(mean=jnp.full(O, 0.2), var=jnp.full(O, 1.7), count=jnp.asarray(50.0))
    ts = JaxTrainState(params=params, opt_state=agent.optimizer.init(params), obs_rms=rms0,
                       value_rms=JaxRMS(mean=jnp.full(1, 0.1), var=jnp.full(1, 0.8), count=jnp.asarray(50.0)),
                       env_state=None, key=jax.random.PRNGKey(2), epoch=jnp.asarray(0))
    # a first JAX update gives Adam non-zero moments and a step count of 1
    r0, last0 = _rollout(3, net, params, rms0)
    ts, _ = agent.update(ts, _jax_rollout(r0), *agent.compute_gae(_jax_rollout(r0), jnp.asarray(last0)))

    r1, last1 = _rollout(4, net, ts.params, ts.obs_rms)
    port_ts = train_state_from_jax(_np_tree(ts), learning_rate=lr, device="cpu")
    before = [p.detach().clone() for p in port_ts.network.parameters()]
    want, m_j = agent.update(ts, _jax_rollout(r1), *agent.compute_gae(_jax_rollout(r1), jnp.asarray(last1)))

    port = PPOAgent(types.SimpleNamespace(device=torch.device("cpu"), obs_dim=O, action_dim=A),
                    PPOConfig(**cfg), network=port_ts.network)
    roll = _port_rollout(r1)
    got, m = port.update(port_ts, roll, *compute_gae(port.config, roll, torch.as_tensor(last1)))

    assert got.epoch == 2 and int(want.epoch) == 2
    for k in ("a_loss", "c_loss", "b_loss"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for name in ("obs_rms", "value_rms"):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(getattr(got, name), f).numpy(),
                                       np.asarray(getattr(getattr(want, name), f)), rtol=1e-5, err_msg=f"{name}.{f}")
    jparams = dict(flax_leaves(got.network, _np_tree(want.params)))
    for p, p0 in zip(got.network.parameters(), before):
        step_got, step_want = (p - p0).detach().numpy(), (jparams[p] - p0).numpy()
        assert np.abs(step_want).max() > 0.1 * lr
        np.testing.assert_allclose(step_got, step_want, rtol=1e-4, atol=1e-3 * lr)
    adam = want.opt_state[1][0]
    assert isinstance(adam, optax.ScaleByAdamState) and int(adam.count) == 2
    mu, nu = dict(flax_leaves(got.network, _np_tree(adam.mu))), dict(flax_leaves(got.network, _np_tree(adam.nu)))
    for p in got.network.parameters():
        state = got.optimizer.state[p]
        assert float(state["step"]) == 2.0
        for got_m, want_m in ((state["exp_avg"], mu[p]), (state["exp_avg_sq"], nu[p])):
            np.testing.assert_allclose(got_m.numpy(), want_m.numpy(), rtol=1e-4, atol=1e-4 * float(want_m.abs().max()))
