"""The port's data-parallel paths (`pulse_tpu_torch.parallel`) on two gloo
ranks on the CPU, against the JAX package's `_update_dp` on a two-device
mesh and against the port's single-process updates.

One module fixture writes the cases' inputs, starts the two ranks once
through the dry run's rank module (`python -m
pulse_tpu_torch.parallel.dryrun --rank r --cases <file>`: torch and the
port only) and, while they run, computes the JAX references on
`make_mesh(2)` of the 8-device CPU platform (`tests/conftest.py`). Each
rank writes what its updates left; the tests compare.

  * PPO and distillation, one minibatch of every row and one mini-epoch
    (`tests/test_dp_update.py`'s sizes and bars): the port's DP update
    against JAX's, params within 2e-5, moments 1e-5, metrics 1e-4;
  * PPO over four minibatches and two mini-epochs on the same rollout:
    the moments JAX's within 1e-5 (its DP moments come before the
    minibatching), the params finite and the same bits on both ranks;
  * AMP: `amp_rms` the moments of the gathered rollout merged with the
    fresh demos (mean 1e-5, var 1e-5 absolute and relative), the demo and
    replay buffers the same bits on both ranks, each rank's replay block
    rows of its own shard; the discriminator's DP step (no dropout, the
    replay empty) against the single-process step on the ranks' demo
    slices and agent rows joined (`cases._amp_plain`), at the PPO bars;
  * the recurrent update under the mesh equal, bit for bit, to the
    single-process `update_rnn` on the whole rollout;
  * `im_eval` split over the ranks equal to the unsplit eval (failures
    exact, sums within 1e-9 relative: the same per-env steps);
  * the ValueError of sizes the mesh size does not divide.
"""

import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pulse_tpu.learning.distill import DistillAgent as JaxDistillAgent, DistillConfig as JaxDistillConfig
from pulse_tpu.learning.distill import DistillState as JaxDistillState
from pulse_tpu.learning.networks import ActorCritic as JaxActorCritic, PulseVAE as JaxPulseVAE
from pulse_tpu.learning.ppo import PPOAgent as JaxPPOAgent, PPOConfig as JaxPPOConfig, Rollout as JaxRollout
from pulse_tpu.learning.ppo import TrainState as JaxTrainState
from pulse_tpu.learning.running_norm import RunningMeanStd as JaxRMS
from pulse_tpu.parallel import make_mesh as jax_make_mesh

from jax_reference import module_reference_compiles, reference_jit

from pulse_tpu_torch.eval.im_eval import im_eval
from pulse_tpu_torch.learning.amp import AMPConfig
from pulse_tpu_torch.learning.distill import DistillConfig, DistillRollout, distill_state_from_jax
from pulse_tpu_torch.learning.networks import RNNActorCritic
from pulse_tpu_torch.learning.ppo import PPOConfig, Rollout, TrainState, train_state_from_jax
from pulse_tpu_torch.learning.running_norm import RunningMeanStd
from pulse_tpu_torch.parallel import dryrun
from pulse_tpu_torch.parallel.cases import tiny_env

# every JAX compile of this module's references at -O0 (tests/jax_reference.py)
reference_compiles_in_module = module_reference_compiles()

D = 2
T, B, O, A = 4, 16, 9, 5      # tests/test_dp_update.py's sizes
Z, S = 4, 5                   # the VAE's latent and self obs
AMP_T, AMP_B = 4, 8
DISTILL_CFG = dict(num_envs=B, horizon_length=T, minibatch_size=(T - 1) * B, mini_epochs=1)
TINY_ENV = dict(clips=3, seconds=0.25)


def f32(x):
    return np.asarray(x, np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class _JaxEnv:
    obs_dim, action_dim, self_obs_dim = O, A, S

    def __init__(self, mesh=None):
        self.mesh = mesh


def _ppo_inputs(rng):
    return dict(obs=f32(1.5 * rng.standard_normal((T, B, O)) + 0.3), actions=f32(0.3 * rng.standard_normal((T, B, A))),
                neglogp=f32(rng.standard_normal((T, B)) + 5.0), values=f32(rng.standard_normal((T, B))),
                rewards=f32(rng.standard_normal((T, B))), advantages=f32(rng.standard_normal((T, B))),
                returns=f32(rng.standard_normal((T, B))))


def _jax_ppo_case(cfg_kw, ts, seed):
    """(JAX DP agent, rollout dict, the port's case) of a config, from the
    JAX state ts."""
    cfg = JaxPPOConfig(num_envs=B, horizon_length=T, **cfg_kw)
    dp = JaxPPOAgent(_JaxEnv(jax_make_mesh(D)), cfg, _jax_actor_critic())
    r = _ppo_inputs(np.random.default_rng(seed))
    roll = Rollout(**{k: torch.as_tensor(r[k]) for k in ("obs", "actions", "neglogp", "values", "rewards")},
                   dones=torch.zeros(T, B, dtype=torch.bool), terminates=torch.zeros(T, B, dtype=torch.bool))
    case = dict(kind="ppo", config=PPOConfig(num_envs=B, horizon_length=T, **cfg_kw),
                state=train_state_from_jax(_np_tree(ts), cfg.learning_rate, device="cpu"), rollout=roll,
                advantages=torch.as_tensor(r["advantages"]), returns=torch.as_tensor(r["returns"]), seed=0)
    return dp, r, case


def _jax_actor_critic():
    return JaxActorCritic(action_dim=A, actor_units=(16,), critic_units=(16,), dtype=jnp.float32)


def _jax_distill_agent():
    """(the VAE, JAX's DP distillation agent on make_mesh(D))."""
    net = JaxPulseVAE(action_dim=A, latent_dim=Z, self_obs_dim=S, encoder_units=(8,), prior_units=(8,),
                      decoder_units=(8,), critic_units=(8,))
    dp = JaxDistillAgent(_JaxEnv(jax_make_mesh(D)), lambda obs: jnp.zeros(obs.shape[:-1] + (A,)),
                         JaxDistillConfig(**DISTILL_CFG), net)
    return net, dp


def _jax_states(ppo_seed, distill_seed, distill_net, distill_dp):
    """Fresh JAX PPO and distillation states (params, the optax chains'
    states), both built in one compiled program."""
    net, opt = _jax_actor_critic(), JaxPPOAgent(_JaxEnv(), JaxPPOConfig(), _jax_actor_critic()).optimizer

    def init(kp, kd):
        params = net.init(kp, jnp.zeros((1, O)))["params"]
        ts = JaxTrainState(params=params, opt_state=opt.init(params), obs_rms=JaxRMS.create(O),
                           value_rms=JaxRMS.create(1), env_state=None, key=jax.random.PRNGKey(3),
                           epoch=jnp.zeros((), jnp.int32))
        dparams = distill_net.init(kd, jnp.zeros((1, O)), jnp.zeros((1, Z)))["params"]
        ds = JaxDistillState(params=dparams, opt_state=distill_dp.optimizer.init(dparams), obs_rms=JaxRMS.create(O),
                             env_state=None, key=jax.random.PRNGKey(3), epoch=jnp.zeros((), jnp.int32))
        return ts, ds

    return reference_jit(init)(jax.random.PRNGKey(ppo_seed), jax.random.PRNGKey(distill_seed))


def _jax_updates(ppo_dp, r, ts, distill_dp, ds, dtraj):
    """JAX's PPO and distillation DP updates, both in one compiled program:
    ((state, metrics) of each) with numpy leaves."""
    z = jnp.zeros((T, B, 1))
    traj = JaxRollout(obs=jnp.asarray(r["obs"]), actions=jnp.asarray(r["actions"]), neglogp=jnp.asarray(r["neglogp"]),
                      values=jnp.asarray(r["values"]), rewards=jnp.asarray(r["rewards"]),
                      dones=jnp.zeros((T, B), bool), terminates=jnp.zeros((T, B), bool), amp_obs=z, mus=z)

    def both(ts, traj, adv, ret, ds, dtraj):
        return ppo_dp.update(ts, traj, adv, ret), distill_dp.update(ds, dtraj)

    out = reference_jit(both)(ts, traj, jnp.asarray(r["advantages"]), jnp.asarray(r["returns"]), ds,
                              {k: jnp.asarray(v) for k, v in dtraj.items()})
    return tuple((_np_tree(st), {k: float(v) for k, v in m.items()}) for st, m in out)


def _distill_case(ds, seed):
    """(the rollout as numpy, the port's case) from the JAX state ds."""
    rng = np.random.default_rng(seed)
    traj = {"obs": f32(1.5 * rng.standard_normal((T, B, O)) + 0.3),
            "gt_action": f32(np.clip(0.5 * rng.standard_normal((T, B, A)), -1, 1)),
            "z_noise": f32(rng.standard_normal((T, B, Z)))}
    roll = DistillRollout(obs=torch.as_tensor(traj["obs"]), gt_action=torch.as_tensor(traj["gt_action"]),
                          z_noise=torch.as_tensor(traj["z_noise"]), rewards=torch.zeros(T, B))
    case = dict(kind="distill", config=DistillConfig(**DISTILL_CFG), rollout=roll, seed=0,
                state=distill_state_from_jax(_np_tree(ds), JaxDistillConfig().kin_lr, device="cpu"))
    return traj, case


def _rnn_case(seed):
    rng = np.random.default_rng(seed)
    net = RNNActorCritic(O, A, trunk_units=(16,), rnn_size=8, device="cpu", seed=seed)
    H = net.rnn_size
    r = _ppo_inputs(rng)
    roll = Rollout(**{k: torch.as_tensor(r[k]) for k in ("obs", "actions", "neglogp", "values", "rewards")},
                   dones=torch.zeros(T, B, dtype=torch.bool), terminates=torch.zeros(T, B, dtype=torch.bool),
                   hiddens=tuple(torch.as_tensor(f32(0.5 * rng.standard_normal((T, B, H)))) for _ in range(2)),
                   prev_dones=torch.as_tensor(rng.uniform(size=(T, B)) < 0.2))
    ts = TrainState(network=net, optimizer=torch.optim.Adam(net.parameters(), lr=1e-3),
                    obs_rms=RunningMeanStd.create(O), value_rms=RunningMeanStd.create(1), env_state=None)
    cfg = PPOConfig(num_envs=B, horizon_length=T, minibatch_size=8, mini_epochs=2, seq_len=2)
    return dict(kind="ppo", config=cfg, state=ts, rollout=roll, advantages=torch.as_tensor(r["advantages"]),
                returns=torch.as_tensor(r["returns"]), seed=0)


CASES = ("ppo_one", "ppo_multi", "ppo_indivisible", "distill_one", "rnn", "amp", "im_eval")


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The ranks' outputs by case, [rank 0's, rank 1's], and the JAX
    references."""
    out = str(tmp_path_factory.mktemp("dp"))
    dnet, ddp = _jax_distill_agent()
    ts0, ds0 = _jax_states(0, 4, dnet, ddp)
    ppo_one = _jax_ppo_case(dict(minibatch_size=T * B, mini_epochs=1), ts0, 0)
    # the same rollout as ppo_one: the DP moments do not depend on the
    # minibatching, so JAX's are ppo_one's
    ppo_multi = _jax_ppo_case(dict(minibatch_size=T * B // 4, mini_epochs=2), ts0, 0)
    bad = dict(ppo_one[2], config=PPOConfig(num_envs=B, horizon_length=T, minibatch_size=T * B - 1, mini_epochs=1))
    dtraj, distill = _distill_case(ds0, 4)
    cases = [ppo_one[2], ppo_multi[2], bad, distill, _rnn_case(5),
             dict(kind="amp", env=TINY_ENV, config=AMPConfig(disc_units=(16,), amp_batch_size=16, amp_buffer_size=64),
                  T=AMP_T, B=AMP_B, data_seed=6, seed=0),
             dict(kind="im_eval", env=TINY_ENV, batch_size=4, policy_seed=7, plain_rank=0)]
    path = os.path.join(out, "cases.pt")
    torch.save({"cases": cases}, path)
    procs = dryrun.start_ranks(D, "gloo", "cpu", out, ["--cases", path])
    try:
        ref = dict(zip(("ppo_one", "distill_one"), _jax_updates(*ppo_one[:2], ts0, ddp, ds0, dtraj)))
    finally:
        dryrun.wait_ranks(procs, timeout_s=600)
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(D)]
    return {name: [ranks[r][i] for r in range(D)] for i, name in enumerate(CASES)}, ref


def _jax_params_as_port(kind, jax_state):
    if kind == "ppo":
        return [p.detach() for p in train_state_from_jax(jax_state, 1e-3, device="cpu").network.parameters()]
    return [p.detach() for p in distill_state_from_jax(jax_state, 1e-3, device="cpu").network.parameters()]


@pytest.mark.parametrize("name", ["ppo_one", "distill_one"])
def test_dp_update_one_minibatch_matches_jax(dp, name):
    out, ref = dp
    jax_state, jax_metrics = ref[name]
    want = _jax_params_as_port("ppo" if name.startswith("ppo") else "distill", jax_state)
    for r in range(D):
        got = out[name][r]
        assert len(got["params"]) == len(want)
        for a, b in zip(got["params"], want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)
        np.testing.assert_allclose(got["obs_rms"]["mean"].numpy(), jax_state.obs_rms.mean, atol=1e-5)
        np.testing.assert_allclose(got["obs_rms"]["var"].numpy(), jax_state.obs_rms.var, atol=1e-5)
        if name == "ppo_one":
            np.testing.assert_allclose(got["value_rms"]["mean"].numpy(), jax_state.value_rms.mean, atol=1e-5)
        for k, v in jax_metrics.items():
            np.testing.assert_allclose(got["metrics"][k], v, atol=1e-4, err_msg=k)
    assert all(torch.equal(a, b) for a, b in zip(out[name][0]["params"], out[name][1]["params"]))


def test_dp_update_multi_minibatch_moments_match_jax(dp):
    """On ppo_one's rollout: JAX's DP moments are computed before the
    minibatching, so they are those of ppo_one's JAX update."""
    out, ref = dp
    jax_state, _ = ref["ppo_one"]
    r0, r1 = out["ppo_multi"]
    for f in ("mean", "var"):
        np.testing.assert_allclose(r0["obs_rms"][f].numpy(), getattr(jax_state.obs_rms, f), atol=1e-5)
        np.testing.assert_allclose(r0["value_rms"][f].numpy(), getattr(jax_state.value_rms, f), atol=1e-5)
    assert all(bool(torch.isfinite(p).all()) for p in r0["params"])
    assert all(np.isfinite(v) for v in r0["metrics"].values())
    assert all(torch.equal(a, b) for a, b in zip(r0["params"], r1["params"]))
    assert r0["metrics"] == r1["metrics"]


def test_dp_update_rejects_indivisible_minibatch(dp):
    out, _ = dp
    for r in range(D):
        assert "divisible" in out["ppo_indivisible"][r]["error"]


def test_im_eval_rejects_indivisible_batch():
    env = tiny_env("cpu", **TINY_ENV)
    with pytest.raises(ValueError, match="divisible"):
        im_eval(env, lambda obs: obs[:, :A], batch_size=3, mesh=types.SimpleNamespace(size=2, rank=0))


def test_rnn_update_under_mesh_is_the_global_update(dp):
    out, _ = dp
    for r in range(D):
        got = out["rnn"][r]
        assert all(torch.equal(a, b) for a, b in zip(got["params"], got["plain"]["params"]))
        for k in ("obs_rms", "value_rms"):
            assert all(torch.equal(got[k][f], got["plain"][k][f]) for f in ("mean", "var", "count"))
        assert got["metrics"] == got["plain"]["metrics"]
    assert all(torch.equal(a, b) for a, b in zip(out["rnn"][0]["params"], out["rnn"][1]["params"]))


def test_amp_dp_update_moments_and_buffers(dp):
    r0, r1 = dp[0]["amp"]
    rollout, demo_new = r0["rollout"].double(), r0["demo_new"].double()
    assert torch.equal(r0["rollout"], r1["rollout"]) and torch.equal(r0["demo_new"], r1["demo_new"])
    rows = torch.cat([rollout.reshape(-1, rollout.shape[-1]), demo_new])
    # the Chan merge of the batch moments into the fresh normalizer (0, 1, 1e-4)
    n, c0 = rows.shape[0], 1e-4
    tot = c0 + n
    bm, bv = rows.mean(0), rows.var(0, correction=0)
    want_mean = bm * n / tot
    want_var = (c0 + bv * n + bm**2 * c0 * n / tot) / tot
    np.testing.assert_allclose(r0["amp_rms"]["mean"].numpy(), want_mean.numpy(), atol=1e-5)
    np.testing.assert_allclose(r0["amp_rms"]["var"].numpy(), want_var.numpy(), rtol=1e-5, atol=1e-5)
    for key in ("demo_buffer", "replay_buffer"):
        assert torch.equal(r0[key][0], r1[key][0]) and r0[key][1:] == r1[key][1:]
    for k in ("amp_rms",):
        assert all(torch.equal(r0[k][f], r1[k][f]) for f in ("mean", "var", "count"))
    assert all(torch.equal(a, b) for a, b in zip(r0["params"], r1["params"]))
    n_batch = 16
    assert r0["replay_buffer"][2] == n_batch
    nl = n_batch // D
    shard = AMP_B // D
    for r in range(D):
        mine = r0["rollout"][:, r * shard:(r + 1) * shard].reshape(-1, rollout.shape[-1])
        block = r0["replay_buffer"][0][r * nl:(r + 1) * nl]
        assert bool((block[:, None, :] == mine[None]).all(-1).any(-1).all()), f"rank {r}'s replay rows"


def test_amp_dp_update_matches_single_process_step(dp):
    """Each rank's demo slice and agent rows, the mean (not the sum) of
    the gradients and metrics: the DP step equals one process's step on
    the joined batch (params within 2e-5, a fifth of the learning rate
    that Adam's first step moves every weight by)."""
    for r in range(D):
        got = dp[0]["amp"][r]
        want = got["plain"]
        assert len(got["params"]) == len(want["params"])
        for a, b in zip(got["params"], want["params"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)
        for f in ("mean", "var"):
            np.testing.assert_allclose(got["amp_rms"][f].numpy(), want["amp_rms"][f].numpy(), atol=1e-5)
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, atol=1e-4, err_msg=k)


def test_im_eval_split_matches_unsplit(dp):
    out, _ = dp
    plain = out["im_eval"][0]["plain"]
    for r in range(D):
        got = out["im_eval"][r]
        np.testing.assert_array_equal(got["failed_motions"], plain["failed_motions"])
        np.testing.assert_array_equal(got["per_motion_steps"], plain["per_motion_steps"])
        for k in ("success_rate", "mpjpe_g", "mpjpe_l", "mpjpe_pa", "vel_dist", "accel_dist"):
            np.testing.assert_allclose(got[k], plain[k], rtol=1e-9, err_msg=k)
        np.testing.assert_allclose(got["per_motion_mpjpe_g"], plain["per_motion_mpjpe_g"], rtol=1e-9)
    a, b = out["im_eval"]
    assert {k: str(v) for k, v in a.items() if k != "plain"} == {k: str(v) for k, v in b.items() if k != "plain"}
