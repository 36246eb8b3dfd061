"""The port's remaining learning API against the JAX package's on the CPU,
with inputs from a numpy seed and float32 JAX networks:

  * `SeptActorCritic` (self 10, task 5, widths (32,) and (24,)), with and
    without a point-net channel of 4 points of 3, from
    `sept_actor_critic_from_jax`: mu and value 1e-5 relative (atol 1e-6);
    mu unchanged (1e-6) when the points are permuted;
  * `CNNActorCritic` on a 16 x 16 grid behind 5 flat entries, from
    `cnn_actor_critic_from_jax`: the conv features against flax's
    `ConvEncoder` ('SAME' padding, channels-last flatten) and mu and value,
    1e-5 relative (atol 1e-6);
  * `ZEmbedding` of each z type on a codebook of 16 entries of 8, from
    `z_embedding_from_jax`: z, the pre-quantization z and the quantizer's
    losses 1e-5 relative (atol 1e-6), the indexes equal, and the gradients
    of a loss through the straight-through estimator within 1e-5 of their
    tensor's largest entry (the sphere projection's gradient cancels);
  * `quantize`, `ema_update` and `project_to_norm`: 1e-5 relative (atol
    1e-6), the indexes equal;
  * a distillation `update` and `rollout` with `normalize_input=False`:
    the update from a converted state against JAX's (the tolerances of
    tests/test_torch_distill.py), `obs_rms` untouched, and the rollout's
    student reading the raw obs.
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
from pulse_tpu.learning.networks import CNNActorCritic as JaxCNN, ConvEncoder as JaxConvEncoder
from pulse_tpu.learning.networks import PulseVAE as JaxPulseVAE, SeptActorCritic as JaxSept
from pulse_tpu.learning.networks import ZEmbedding as JaxZEmbedding
from pulse_tpu.learning.running_norm import RunningMeanStd as JaxRMS
from pulse_tpu.learning import vq_quantizer as jvq

from jax_reference import module_reference_compiles, reference_jit

from pulse_tpu_torch.learning import vq_quantizer as vq
from pulse_tpu_torch.learning.distill import DistillAgent, DistillConfig, distill_state_from_jax, trained_parameters
from pulse_tpu_torch.learning.networks import (CNNActorCritic, PulseVAE, SeptActorCritic, ZEmbedding, cnn_leaves,
                                               sept_leaves, vae_leaves, z_embedding_from_jax, z_embedding_leaves)
from pulse_tpu_torch.learning.ppo import policy_from_jax
from pulse_tpu_torch.learning.running_norm import RunningMeanStd

# every JAX compile of this module's references at -O0 (tests/jax_reference.py)
reference_compiles_in_module = module_reference_compiles()

TOL = dict(rtol=1e-5, atol=1e-6)
N, A = 7, 4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def f32(x):
    return np.asarray(x, np.float32)


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **{**TOL, **kw})


# --------------------------------------------------------------------------- #
# Sept and CNN
# --------------------------------------------------------------------------- #

S, TASK, P = 10, 5, 3
SEPT_WIDTHS = dict(self_units=(32,), task_units=(24,), actor_units=(32, 24), critic_units=(32,))


@pytest.fixture(scope="module")
def sept_refs():
    """{num_points: (obs, params, (mu, log_sigma, value))}, both JAX
    networks initialized and applied in one program."""
    nets = {n: JaxSept(action_dim=A, self_obs_dim=S, num_points=n, point_dim=P if n else 0, point_units=(16, 8),
                       **SEPT_WIDTHS) for n in (0, 4)}
    obs = {n: f32(np.random.default_rng(0).standard_normal((N, S + TASK + n * P))) for n in nets}

    def run(o):
        out = {}
        for n, net in nets.items():
            p = net.init(jax.random.PRNGKey(0), o[n])["params"]
            out[n] = (p, net.apply({"params": p}, o[n]))
        return out

    out = _np_tree(reference_jit(run)({n: jnp.asarray(o) for n, o in obs.items()}))
    return {n: (obs[n], *out[n]) for n in nets}


@pytest.mark.parametrize("num_points", [0, 4])
def test_sept_matches_jax_and_pools_points(sept_refs, num_points):
    obs, params, (mu_j, ls_j, v_j) = sept_refs[num_points]
    net, leaves = policy_from_jax(params, device="cpu")
    assert isinstance(net, SeptActorCritic) and leaves is sept_leaves and net.num_points == num_points
    with torch.no_grad():
        mu, ls, v = net(torch.as_tensor(obs))
    _close(mu, mu_j)
    _close(v, v_j)
    _close(ls, ls_j)
    if num_points:
        pts = obs[:, -num_points * P:].reshape(N, num_points, P)[:, [2, 0, 3, 1]]
        perm = np.concatenate([obs[:, : -num_points * P], pts.reshape(N, -1)], axis=-1)
        with torch.no_grad():
            mu_p = net(torch.as_tensor(perm))[0]
        _close(mu_p, mu.numpy(), rtol=0)     # the critic reads the points in order


def test_cnn_matches_jax_padding_and_flatten_order():
    G, FLAT = (16, 16), 5
    jnet = JaxCNN(action_dim=A, grid_shape=G, actor_units=(32,), critic_units=(24,), dtype=jnp.float32)
    rng = np.random.default_rng(1)
    obs = f32(np.concatenate([rng.standard_normal((N, FLAT)), rng.uniform(-2, 2, (N, G[0] * G[1]))], axis=-1))

    def run(o):
        p = jnet.init(jax.random.PRNGKey(1), o)["params"]
        feat = JaxConvEncoder((16, 32), dtype=jnp.float32).apply({"params": p["conv"]},
                                                                 o[:, FLAT:].reshape(N, *G, 1))
        return p, jnet.apply({"params": p}, o), feat

    params, (mu_j, _, v_j), feat_j = _np_tree(reference_jit(run)(jnp.asarray(obs)))
    net, leaves = policy_from_jax(params, device="cpu")
    assert isinstance(net, CNNActorCritic) and leaves is cnn_leaves
    with torch.no_grad():
        feat = net.features(torch.as_tensor(obs))
        mu, _, v = net(torch.as_tensor(obs))
    assert feat.shape == (N, FLAT + 4 * 4 * 32)
    _close(feat[:, :FLAT], obs[:, :FLAT], rtol=0, atol=0)
    _close(feat[:, FLAT:], feat_j)
    _close(mu, mu_j)
    _close(v, v_j)


# --------------------------------------------------------------------------- #
# the codebook and the latent heads
# --------------------------------------------------------------------------- #

K, D, F = 16, 8, 12


def _codebook(seed=2):
    cb = jvq.create_codebook(jax.random.PRNGKey(seed), K, D)
    return cb, vq.codebook_from_jax({k: np.asarray(getattr(cb, k)) for k in ("codebook", "ema_counts", "ema_means")})


def _z_loss(z, ex, sin, total):
    """A loss through z and the quantizer's losses (the same in both
    packages)."""
    return total(sin(z) * z) + ex.get("commit_loss", 0.0) + 0.5 * ex.get("codebook_loss", 0.0)


@pytest.fixture(scope="module")
def z_refs():
    """(feat, the codebook pair, {z_type: (params, ((loss, (z, extras)),
    grads))}), every z type's JAX init and value_and_grad in one program."""
    cb_j, cb = _codebook()
    feat = f32(np.random.default_rng(3).standard_normal((N, F)))

    def run(x):
        out = {}
        for z_type in ZEmbedding.Z_TYPES:
            jnet = JaxZEmbedding(latent_dim=D, z_type=z_type, embedding_norm=3.0)

            def loss(p, jnet=jnet):
                z, ex = jnet.apply({"params": p}, x, cb_j)
                return _z_loss(z, ex, jnp.sin, jnp.sum), (z, ex)

            p = jnet.init(jax.random.PRNGKey(3), x, cb_j)["params"]
            out[z_type] = (p, jax.value_and_grad(loss, has_aux=True)(p))
        return out

    return feat, cb, _np_tree(reference_jit(run)(jnp.asarray(feat)))


@pytest.mark.parametrize("z_type", ["sphere", "vq_vae", "vq_vae_hybrid", "vq_vae_res"])
def test_z_embedding_matches_jax_with_straight_through_gradients(z_refs, z_type):
    feat, cb, refs = z_refs
    params, ((_, (z_j, ex_j)), g_j) = refs[z_type]
    net = z_embedding_from_jax(params, z_type, embedding_norm=3.0, device="cpu")
    z, ex = net(torch.as_tensor(feat), cb)
    _z_loss(z, ex, torch.sin, torch.sum).backward()
    _close(z, z_j)
    assert set(ex) == set(ex_j)
    for k in ex:
        if k == "indexes":
            np.testing.assert_array_equal(ex[k].numpy(), np.asarray(ex_j[k]))
        else:
            _close(ex[k], ex_j[k], err_msg=k)
    for p, want in z_embedding_leaves(net, g_j):
        assert float(want.abs().max()) > 0.0
        _close(p.grad, want.numpy(), rtol=0, atol=1e-5 * float(want.abs().max()))


def test_quantize_ema_update_and_project_match_jax():
    cb_j, cb = _codebook(4)
    rng = np.random.default_rng(5)
    z = f32(0.15 * rng.standard_normal((3, 40, D)))
    x = f32(3.0 * rng.standard_normal((6, D)))
    projections = (("sphere", 5.0), ("uniform", 0.1), ("none", 1.0))

    def run(z_, x_):
        zq_, idx_, losses_ = jvq.quantize(cb_j, z_)
        return zq_, idx_, losses_, jvq.ema_update(cb_j, z_, idx_, decay=0.9), [
            jvq.project_to_norm(x_, norm, z_type) for z_type, norm in projections]

    zq_j, idx_j, loss_j, new_j, proj_j = reference_jit(run)(jnp.asarray(z), jnp.asarray(x))
    zq, idx, losses = vq.quantize(cb, torch.as_tensor(z))
    assert idx.shape == (3, 40) and len(np.unique(np.asarray(idx_j))) > K // 2
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    _close(zq, zq_j)
    for k in ("commit_loss", "codebook_loss"):
        _close(losses[k], loss_j[k], err_msg=k)
    new = vq.ema_update(cb, torch.as_tensor(z), idx, decay=0.9)
    for k in ("codebook", "ema_counts", "ema_means"):
        _close(getattr(new, k), getattr(new_j, k), err_msg=k)
    for (z_type, norm), want in zip(projections, proj_j):
        _close(vq.project_to_norm(torch.as_tensor(x), norm, z_type), want, err_msg=z_type)
    made = vq.create_codebook(K, D, torch.Generator().manual_seed(0), device="cpu")
    assert made.codebook.shape == (K, D) and torch.equal(made.ema_means, made.codebook)
    assert torch.equal(made.ema_counts, torch.ones(K)) and 0.05 < float(made.codebook.std()) < 0.15


# --------------------------------------------------------------------------- #
# distillation on the raw obs
# --------------------------------------------------------------------------- #

T, B, O, S, L = 6, 5, 20, 8, 8
WIDTHS = dict(encoder_units=(64,), prior_units=(32,), decoder_units=(64,), critic_units=(32,))


def test_distill_without_input_normalization_matches_jax():
    lr = 1e-3
    cfg = dict(mini_epochs=1, minibatch_size=(T - 1) * B, kin_lr=lr, normalize_input=False)
    jnet = JaxPulseVAE(action_dim=A, latent_dim=L, self_obs_dim=S, **WIDTHS)
    agent = JaxDistillAgent(types.SimpleNamespace(action_dim=A, self_obs_dim=S), None, JaxDistillConfig(**cfg), jnet)
    params = reference_jit(jnet.init)(jax.random.PRNGKey(6), jnp.zeros((1, O)), jnp.zeros((1, L)))["params"]
    rms0 = JaxRMS(mean=jnp.full(O, 0.2), var=jnp.full(O, 1.7), count=jnp.asarray(50.0))

    def traj(seed):
        rng = np.random.default_rng(seed)
        return {"obs": f32(1.5 * rng.standard_normal((T, B, O)) + 0.3), "z_noise": f32(rng.standard_normal((T, B, L))),
                "gt_action": f32(np.clip(0.5 * rng.standard_normal((T, B, A)), -1, 1))}

    ds = JaxDistillState(params=params, opt_state=agent.optimizer.init(params), obs_rms=rms0, env_state=None,
                         key=jax.random.PRNGKey(4), epoch=jnp.asarray(0))
    update = reference_jit(agent.update)
    # a first JAX update gives Adam non-zero moments and a step count of 1
    ds, _ = update(ds, {k: jnp.asarray(v) for k, v in traj(5).items()})
    t1 = traj(7)
    port_ds = distill_state_from_jax(_np_tree(ds), kin_lr=lr, device="cpu")
    before = [p.detach().clone() for p in port_ds.network.parameters()]
    want, m_j = update(ds, {k: jnp.asarray(v) for k, v in t1.items()})
    env = types.SimpleNamespace(device=torch.device("cpu"), obs_dim=O, action_dim=A, self_obs_dim=S)
    port = DistillAgent(env, None, DistillConfig(**cfg), network=port_ds.network)
    got, m = port.update(port_ds, types.SimpleNamespace(**{k: torch.as_tensor(v) for k, v in t1.items()}))

    for k in ("bc_loss", "kld", "ar1", "prior_reg"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for f in ("mean", "var", "count"):     # untouched in both
        np.testing.assert_array_equal(getattr(got.obs_rms, f).numpy(), np.asarray(getattr(rms0, f)), err_msg=f)
        np.testing.assert_array_equal(np.asarray(getattr(want.obs_rms, f)), np.asarray(getattr(rms0, f)), err_msg=f)
    trained = {id(p) for p in trained_parameters(got.network)}
    jparams = dict(vae_leaves(got.network, _np_tree(want.params)))
    for p, p0 in zip(got.network.parameters(), before):
        if id(p) in trained:
            step_got, step_want = (p - p0).detach().numpy(), (jparams[p] - p0).numpy()
            assert np.abs(step_want).max() > 0.1 * lr
            np.testing.assert_allclose(step_got, step_want, rtol=1e-4, atol=1e-3 * lr)
    adam = want.opt_state[1][0]
    assert isinstance(adam, optax.ScaleByAdamState) and int(adam.count) == 2
    mu = dict(vae_leaves(got.network, _np_tree(adam.mu)))
    for p in trained_parameters(got.network):
        want_m = mu[p]
        np.testing.assert_allclose(got.optimizer.state[p]["exp_avg"].numpy(), want_m.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(want_m.abs().max()))

    # the rollout's student reads the raw obs
    net = PulseVAE(O, A, latent_dim=L, self_obs_dim=S, device="cpu", seed=3, **WIDTHS)
    actions = []

    def step(st, action):
        actions.append(action)
        return types.SimpleNamespace(obs=st.obs + 1.0, reward=torch.zeros(B))

    env = types.SimpleNamespace(device=torch.device("cpu"), obs_dim=O, action_dim=A, self_obs_dim=S, step=step,
                                reset=lambda n: types.SimpleNamespace(obs=torch.randint(-3, 4, (n, O)).float()))
    agent = DistillAgent(env, lambda obs: obs[:, :A], DistillConfig(num_envs=B, horizon_length=2, normalize_input=False),
                         network=net, seed=1)
    ds = agent.init()
    ds.obs_rms = RunningMeanStd(mean=torch.full((O,), 0.5), var=torch.full((O,), 2.0), count=torch.tensor(10.0))
    ds, roll = agent.rollout(ds)
    for t in range(2):
        with torch.no_grad():
            mu = net.latent_action(roll.obs[t], roll.z_noise[t])["action_mu"]
        assert torch.equal(actions[t], torch.clamp(mu, -1.0, 1.0))
