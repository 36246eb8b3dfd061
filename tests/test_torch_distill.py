"""The port's PULSE distillation pieces against the JAX package's on the CPU,
with inputs from a numpy seed: `kl_multi`, a narrow float32 PulseVAE
(latent 8, encoder (64,), prior (32,), decoder (64,), critic (32,)) carried
over by `pulse_vae_from_jax`, the distill loss terms and their gradients
against `DistillAgent._loss`, the KL anneal, one `update` (one mini-epoch,
one minibatch of all (T - 1) B pairs) started from a JAX state converted by
`distill_state_from_jax` with the same latent noise and teacher actions,
the frozen normalizer, and the rollout's wiring on a stub env; and
`PulseVAE(full_precision=True)` (the JAX package's `dtype=None`) under an
enclosing bf16 autocast.

Tolerances (float32, sums in another order): kl_multi 1e-6 relative; the
network's outputs 1e-5; the loss terms and gradients 1e-5 absolute with
1e-4 relative; the KL coefficient 1e-6 relative (the JAX package's is
float32, the port's a Python float); after one Adam step those
of tests/test_torch_ppo.py (the parameter changes 1e-4 relative or 1e-3 of
the learning rate, the moments 1e-4 relative or 1e-4 of the largest moment
of their tensor), the running moments 1e-5 relative.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp

import optax
import pytest
import torch

from pulse_tpu.learning.distill import DistillAgent as JaxDistillAgent, DistillConfig as JaxDistillConfig
from pulse_tpu.learning.distill import DistillState as JaxDistillState
from pulse_tpu.learning.networks import PulseVAE as JaxPulseVAE, kl_multi as jax_kl_multi
from pulse_tpu.learning.running_norm import RunningMeanStd as JaxRMS

from jax_reference import module_reference_compiles

from pulse_tpu_torch.learning.distill import (
    DistillAgent, DistillConfig, DistillState, distill_state_from_jax, trained_parameters,
)
from pulse_tpu_torch.learning.networks import PulseVAE, kl_multi, pulse_vae_from_jax, vae_leaves
from pulse_tpu_torch.learning.running_norm import RunningMeanStd

# every JAX compile of this module's references at -O0 (tests/jax_reference.py)
reference_compiles_in_module = module_reference_compiles()

T, B, O, S, A, L = 6, 5, 20, 8, 7, 8     # horizon, envs, obs, self obs, action, latent
WIDTHS = dict(encoder_units=(64,), prior_units=(32,), decoder_units=(64,), critic_units=(32,))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def f32(x):
    return np.asarray(x, np.float32)


def _jax_net():
    return JaxPulseVAE(action_dim=A, latent_dim=L, self_obs_dim=S, **WIDTHS)


def _params(seed):
    return _np_tree(jax.jit(_jax_net().init)(jax.random.PRNGKey(seed), jnp.zeros((1, O)), jnp.zeros((1, L)))["params"])


def _jax_agent(**cfg):
    return JaxDistillAgent(types.SimpleNamespace(action_dim=A, self_obs_dim=S), None, JaxDistillConfig(**cfg), _jax_net())


def _port_agent(net, **cfg):
    env = types.SimpleNamespace(device=torch.device("cpu"), obs_dim=O, action_dim=A, self_obs_dim=S)
    return DistillAgent(env, None, DistillConfig(**cfg), network=net)


def _traj(seed):
    """A [T, B] rollout: raw obs off zero mean and unit scale, the latent
    noise, and teacher actions in [-1, 1]."""
    rng = np.random.default_rng(seed)
    return {"obs": f32(1.5 * rng.standard_normal((T, B, O)) + 0.3),
            "z_noise": f32(rng.standard_normal((T, B, L))),
            "gt_action": f32(np.clip(0.5 * rng.standard_normal((T, B, A)), -1, 1))}


# --------------------------------------------------------------------------- #
# the network
# --------------------------------------------------------------------------- #

def test_kl_multi_matches_jax():
    rng = np.random.default_rng(0)
    x = [f32(rng.standard_normal((16, L)) * s) for s in (1.0, 1.5, 0.7, 1.2)]
    want = np.asarray(jax_kl_multi(*(jnp.asarray(a) for a in x)))
    got = kl_multi(*(torch.as_tensor(a) for a in x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_pulse_vae_from_jax_matches_jax():
    params = _params(1)
    rng = np.random.default_rng(1)
    obs, z = f32(rng.standard_normal((32, O))), f32(rng.standard_normal((32, L)))
    # a prior logvar head pushed past the clamp on both sides
    params["prior"]["prior_logvar"]["bias"] = f32(np.linspace(-12, 6, L))
    want = _jax_net().apply({"params": params}, jnp.asarray(obs), jnp.asarray(z))
    net = pulse_vae_from_jax(params, device="cpu")
    with torch.no_grad():
        got = net(torch.as_tensor(obs), torch.as_tensor(z))
    assert set(got) == set(want)
    assert float(got["prior_logvar"].min()) == -8.0 and float(got["prior_logvar"].max()) == 2.0
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    assert [p for p, _ in vae_leaves(net, params)] == list(net.parameters())


def test_full_precision_vae_matches_jax_and_turns_autocast_off():
    """PulseVAE(full_precision=True) from a JAX PulseVAE(dtype=None) matches
    it at float32 tolerance under an enclosing bf16 autocast, every Linear
    computing in float32; without the flag the same autocast reaches the
    trunks (bf16) and the outputs move by far more."""
    params = _params(2)
    rng = np.random.default_rng(2)
    obs, z = f32(rng.standard_normal((32, O))), f32(rng.standard_normal((32, L)))
    want = _jax_net().apply({"params": params}, jnp.asarray(obs), jnp.asarray(z))
    dtypes = {}

    def run(full_precision):
        net = pulse_vae_from_jax(params, full_precision=full_precision, device="cpu")
        assert net.full_precision is full_precision and net.decoder.full_precision is full_precision
        dtypes.clear()
        hooks = [m.register_forward_hook(lambda m, i, o, name=name: dtypes.update({name: o.dtype}))
                 for name, m in net.named_modules() if isinstance(m, torch.nn.Linear)]
        with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
            got = net(torch.as_tensor(obs), torch.as_tensor(z))
        for h in hooks:
            h.remove()
        return got

    got = run(True)
    assert len(dtypes) == 11 and set(dtypes.values()) == {torch.float32}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    low = run(False)
    assert dtypes["encoder.trunk.0"] == torch.bfloat16 and dtypes["decoder.trunk.0"] == torch.bfloat16
    assert float((low["action_mu"].float() - torch.tensor(np.asarray(want["action_mu"]))).abs().max()) > 1e-4


# --------------------------------------------------------------------------- #
# the loss
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("epoch", [0, 2500, 3750, 6000])
def test_kld_coef_matches_jax(epoch):
    got = _port_agent(PulseVAE(O, A, latent_dim=L, self_obs_dim=S, device="cpu", **WIDTHS)).kld_coef(epoch)
    np.testing.assert_allclose(got, float(_jax_agent().kld_coef(jnp.asarray(epoch))), rtol=1e-6)


def test_loss_terms_and_gradients_match_jax():
    params = _params(2)
    rng = np.random.default_rng(2)
    n = 24
    batch = {"obs": f32(rng.standard_normal((n, 2, O))), "z_noise": f32(rng.standard_normal((n, 2, L))),
             "gt_action": f32(np.clip(0.5 * rng.standard_normal((n, 2, A)), -1, 1))}
    epoch = 3000      # inside the KL anneal
    agent = _jax_agent()
    (total_j, m_j), g_j = jax.value_and_grad(agent._loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, epoch)

    net = pulse_vae_from_jax(params, device="cpu")
    t = {k: torch.as_tensor(v) for k, v in batch.items()}
    total, m = _port_agent(net).loss(net, t["obs"][:, 0], t["obs"][:, 1], t["z_noise"][:, 1], t["gt_action"][:, 1],
                                     epoch)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(total_j), rtol=1e-4, atol=1e-5)
    for k in ("bc_loss", "kld", "ar1", "prior_reg"):
        assert float(m_j[k]) > 1e-3, k
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    trained = {id(p) for p in trained_parameters(net)}
    for p, want in vae_leaves(net, _np_tree(g_j)):
        if id(p) in trained:
            assert p.grad is not None
            np.testing.assert_allclose(p.grad.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
        else:     # the critic: no gradient in either package
            assert p.grad is None and not want.any()


# --------------------------------------------------------------------------- #
# one update from a converted JAX state
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("grad_norm", [50.0, 0.05])     # the clip idle, and the clip scaling every step
def test_update_from_converted_state_matches_jax(grad_norm):
    lr = 1e-3
    cfg = dict(mini_epochs=1, minibatch_size=(T - 1) * B, kin_lr=lr, grad_norm=grad_norm)
    agent = _jax_agent(**cfg)
    params = jax.tree_util.tree_map(jnp.asarray, _params(3))
    rms0 = JaxRMS(mean=jnp.full(O, 0.2), var=jnp.full(O, 1.7), count=jnp.asarray(50.0))
    ds = JaxDistillState(params=params, opt_state=agent.optimizer.init(params), obs_rms=rms0, env_state=None,
                         key=jax.random.PRNGKey(4), epoch=jnp.asarray(0))
    # a first JAX update gives Adam non-zero moments and a step count of 1
    ds, _ = agent.update(ds, {k: jnp.asarray(v) for k, v in _traj(5).items()})

    traj = _traj(6)
    port_ds = distill_state_from_jax(_np_tree(ds), kin_lr=lr, device="cpu")
    before = [p.detach().clone() for p in port_ds.network.parameters()]
    want, m_j = agent.update(ds, {k: jnp.asarray(v) for k, v in traj.items()})

    roll = types.SimpleNamespace(**{k: torch.as_tensor(v) for k, v in traj.items()})
    got, m = _port_agent(port_ds.network, **cfg).update(port_ds, roll)

    assert got.epoch == 2 and int(want.epoch) == 2
    for k in ("bc_loss", "kld", "ar1", "prior_reg"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(got.obs_rms, f).numpy(), np.asarray(getattr(want.obs_rms, f)), rtol=1e-5,
                                   err_msg=f)
    trained = {id(p) for p in trained_parameters(got.network)}
    jparams = dict(vae_leaves(got.network, _np_tree(want.params)))
    for p, p0 in zip(got.network.parameters(), before):
        step_got, step_want = (p - p0).detach().numpy(), (jparams[p] - p0).numpy()
        if id(p) not in trained:     # the critic stays as it was in both
            assert not step_got.any() and not step_want.any()
            continue
        assert np.abs(step_want).max() > 0.1 * lr
        np.testing.assert_allclose(step_got, step_want, rtol=1e-4, atol=1e-3 * lr)
    adam = want.opt_state[1][0]
    assert isinstance(adam, optax.ScaleByAdamState) and int(adam.count) == 2
    mu, nu = dict(vae_leaves(got.network, _np_tree(adam.mu))), dict(vae_leaves(got.network, _np_tree(adam.nu)))
    for p in trained_parameters(got.network):
        state = got.optimizer.state[p]
        assert float(state["step"]) == 2.0
        for got_m, want_m in ((state["exp_avg"], mu[p]), (state["exp_avg_sq"], nu[p])):
            np.testing.assert_allclose(got_m.numpy(), want_m.numpy(), rtol=1e-4, atol=1e-4 * float(want_m.abs().max()))


# --------------------------------------------------------------------------- #
# the frozen normalizer and the rollout
# --------------------------------------------------------------------------- #

def test_frozen_running_mean_std_ignores_updates_as_jax():
    rng = np.random.default_rng(7)
    x = f32(rng.standard_normal((40, 6)) * 3 + 1)
    port = RunningMeanStd.create(6, device="cpu").update(torch.as_tensor(x)).freeze()
    ref = JaxRMS.create(6).update(jnp.asarray(x)).freeze()
    assert port.frozen and ref.frozen
    assert port.update(torch.as_tensor(2 * x)) is port
    ref2 = ref.update(jnp.asarray(2 * x))
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(port, f).numpy(), np.asarray(getattr(ref2, f)), rtol=1e-5, err_msg=f)
    np.testing.assert_allclose(port.normalize(torch.as_tensor(x)).numpy(), np.asarray(ref2.normalize(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def test_rollout_drives_the_env_with_the_students_clipped_action():
    """Each step the env gets clip(action_mu, -1, 1) of the student on the
    normalized obs and the noise stored beside it; the buffers hold the raw
    obs and the teacher's action on it."""
    torch.manual_seed(0)
    net = PulseVAE(O, A, latent_dim=L, self_obs_dim=S, device="cpu", seed=3, **WIDTHS)
    with torch.no_grad():
        net.decoder.out.bias.fill_(3.0)      # every action beyond the bound before the clip
    steps = []

    def step(st, action):
        steps.append(action)
        return types.SimpleNamespace(obs=st.obs + 1.0, reward=torch.full((B,), float(len(steps))))

    env = types.SimpleNamespace(device=torch.device("cpu"), obs_dim=O, action_dim=A, self_obs_dim=S, step=step,
                                reset=lambda n: types.SimpleNamespace(obs=torch.randint(-3, 4, (n, O)).float()))
    agent = DistillAgent(env, lambda obs: torch.tanh(obs[:, :A]), DistillConfig(num_envs=B, horizon_length=T),
                         network=net, seed=1)
    ds = agent.init()
    ds.obs_rms = RunningMeanStd(mean=torch.full((O,), 0.5), var=torch.full((O,), 2.0), count=torch.tensor(10.0))
    obs0 = ds.env_state.obs.clone()
    ds, roll = agent.rollout(ds)
    assert len(steps) == T and torch.equal(ds.env_state.obs, obs0 + T)
    for t in range(T):
        assert torch.equal(roll.obs[t], obs0 + t)
        assert torch.equal(roll.gt_action[t], torch.tanh(roll.obs[t][:, :A]))
        mu = net.latent_action(ds.obs_rms.normalize(roll.obs[t]), roll.z_noise[t])["action_mu"]
        assert torch.equal(steps[t], torch.clamp(mu, -1.0, 1.0)) and float(steps[t].max()) == 1.0
    assert float(roll.rewards.mean()) == (T + 1) / 2
