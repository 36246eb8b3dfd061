"""The port's training CLI on the CPU at a tiny size:

    python -m pulse_tpu_torch.run env=im_getup device=cpu num_envs=8 ...

with a narrow network, 8 fall states settled for 2 steps and a horizon of
4. It must write the config, a metrics JSONL line per epoch and a
checkpoint, and a second run with `epoch=-1` must restore that checkpoint
and go on from its epoch. `test=true epoch=-1` evaluates the restored
policy and prints the EvalResult as JSON; `eval_frequency` evaluates
during training and writes the PMCP weights of the failed clips into the
motion store the resets sample from. `env=im_vae learning=im_z_fit`
distills a PPO checkpoint into a narrow PulseVAE, checkpoints and resumes;
it has no evaluator. `learning=im_amp` trains env=amp, env=amp_getup
(with the getup schedule) and env=im with the AMP discriminator, resumes
it with both buffers, and `test=true` evaluates an AMP checkpoint's PPO
policy. `env=im_mcp` and `env=im_mcp_getup` (composer weights over a
fresh frozen PNN), `env.randomize=true` (with PPO, and with AMP re-drawing
the props) and `env.control_mode=pd|force` train in process. Options the
port does not have yet raise NotImplementedError, and the demo task names
train the envs they alias (the reference `.pth`
paths, strike and terrain run in tests/test_torch_checkpoint.py, the
motion files in tests/test_torch_motion_file.py). The port's config
dataclasses default as the JAX package's.

One tiny `env=im` run in this process (`trained`) gives the checkpoint
that test=true evaluates and that distillation takes as its teacher.
"""

import json

import dataclasses

import numpy as np
import pytest
import torch

from pulse_tpu.env import EnvConfig as JaxEnvConfig
from pulse_tpu.learning.amp import AMPConfig as JaxAMPConfig
from pulse_tpu.learning.distill import DistillConfig as JaxDistillConfig
from pulse_tpu.learning.ppo import PPOConfig as JaxPPOConfig
from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig

from pulse_tpu_torch import _build, run
from pulse_tpu_torch.env.humanoid_im import EnvConfig, HumanoidImEnv
from pulse_tpu_torch.env.humanoid_im_mcp import HumanoidImMCPEnv
from pulse_tpu_torch.learning.amp import AMPConfig
from pulse_tpu_torch.learning.distill import DistillConfig
from pulse_tpu_torch.learning.pnn import PNN
from pulse_tpu_torch.learning.ppo import PPOConfig
from pulse_tpu_torch.motion.motion_lib import build_motion_data, update_hard_sampling_weight
from pulse_tpu_torch.motion.synthetic import make_synthetic_clips
from pulse_tpu_torch.physics.model import PhysicsConfig

TINY = ["device=cpu", "num_envs=8", "learning.horizon_length=4", "learning.minibatch_size=16",
        "learning.mini_epochs=2", "learning.actor_units=[32,24]", "learning.critic_units=[32,24]", "log_frequency=1"]
GETUP = ["env=im_getup", "env.num_fall_states=8", "env.fall_settle_steps=2"]
DISTILL = ["env=im_vae", "learning=im_z_fit", "device=cpu", "num_envs=8", "learning.horizon_length=4",
           "learning.minibatch_size=16", "learning.encoder_units=[64]", "learning.prior_units=[32]",
           "learning.decoder_units=[64]", "env.num_fall_states=4", "env.fall_settle_steps=2", "log_frequency=1"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(output dir, TrainResult, launch counts before and after) of a
    2-epoch env=im run in this process; its checkpoint is under im/ckpt."""
    out = tmp_path_factory.mktemp("trained")
    before = dict(_build.launches)
    res = run.main(["env=im", "max_epochs=2", f"output_dir={out}", "exp_name=im", *TINY])
    return out, res, before, dict(_build.launches)


def test_cli_trains_logs_checkpoints_and_resumes(tmp_path, capsys):
    # in process: tests/test_torch_motion_file.py runs the module as a
    # program (`python -m pulse_tpu_torch.run`'s __main__) in a subprocess
    run.main([*GETUP, "max_epochs=1", "exp_name=g", f"output_dir={tmp_path}", *TINY])
    first = capsys.readouterr().out
    exp = tmp_path / "g"
    assert json.loads((exp / "config.json").read_text())["env"]["task"] == "HumanoidImGetup"
    rows = [json.loads(l) for l in (exp / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0] and "epoch=0" in first
    for k in ("a_loss", "c_loss", "b_loss", "reward_mean", "rollout_s", "gae_s", "update_s"):
        assert k in rows[0] and rows[0][k] == rows[0][k], k
    ck = torch.load(exp / "ckpt" / "epoch_1.pt", weights_only=True)
    assert ck["epoch"] == 1 and float(ck["obs_rms"]["count"]) > 8 * 4

    run.main([*GETUP, "max_epochs=2", "exp_name=g", "epoch=-1", f"output_dir={tmp_path}", *TINY])
    second = capsys.readouterr().out
    assert "restored" in second and "epoch=1" in second and "epoch=0" not in second
    assert torch.load(exp / "ckpt" / "epoch_2.pt", weights_only=True)["epoch"] == 2


def test_main_runs_env_im_in_process(trained):
    _, res, before, after = trained
    assert after == before   # the CPU runs the plain versions: no kernel launched
    assert len(res.metrics) == 2 and res.train_state.epoch == 2
    assert res.agent.env._fused_step_ok()
    assert float(res.train_state.obs_rms.count) == pytest.approx(2 * 8 * 4, abs=1e-3)


@pytest.mark.parametrize("args", [
    ["env=amp_getup", "learning=im_amp", "env.shape_variation=true"], ["env=im_getup", "env.shape_variation=true"],
])
def test_unported_options_raise(args, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run.main(["device=cpu", f"output_dir={tmp_path}", *args])


@pytest.mark.parametrize("args,cls", [
    (["env=im", "env.task=HumanoidImDemo"], HumanoidImEnv),
    (["env=im_mcp", "env.task=HumanoidImMCPDemo"], HumanoidImMCPEnv),
])
def test_demo_task_names_train_their_envs(args, cls, tmp_path):
    # the demo names are the same envs (pulse_tpu/run.py's im_plain), which
    # scripts/demo_server.py drives live
    res = run.main([*args, "max_epochs=1", f"output_dir={tmp_path}", *TINY])
    assert type(res.agent.env) is cls and len(res.metrics) == 1
    assert json.loads((tmp_path / "default" / "config.json").read_text())["env"]["task"] == args[1].split("=")[1]


def _one_second_clips(monkeypatch):
    """run.main builds its four synthetic clips one second long, not four,
    so that an eval steps 30 times, not 120."""
    monkeypatch.setattr(run, "build_motion_from_cfg", lambda cfg, spec, device: build_motion_data(
        spec.skeleton, make_synthetic_clips(spec.skeleton, 4, seconds=1.0), device=device))


def test_cli_test_true_prints_the_eval_result(trained, capsys, monkeypatch):
    _one_second_clips(monkeypatch)
    run.main(["env=im", "test=true", "epoch=-1", "exp_name=im", f"output_dir={trained[0]}", *TINY])
    out = capsys.readouterr().out
    assert "restored" in out and "epoch=" not in out   # evaluated, not trained
    res = json.loads(out[out.index("{"):])
    assert len(res["failed_motions"]) == 4
    assert res["per_motion_steps"] == [29.0] * 4   # 1 s clips: the step at t = length is not scored
    for k in ("success_rate", "mpjpe_g", "mpjpe_l", "mpjpe_pa", "vel_dist", "accel_dist"):
        assert np.isfinite(res[k]) and res[k] >= 0, k


def test_eval_frequency_reweights_pmcp_sampling(tmp_path, monkeypatch):
    """Evals after epochs 1 and 2 (not 0); the failure mask of the last one
    (forced to two of the four clips, as a trained policy would leave it)
    becomes the live sampling weights, which the env's resets then draw from."""
    evals, real = [], run.run_eval

    def run_eval(*args):
        result = real(*args)
        result.failed_motions = np.array([True, False, False, True])
        evals.append(result)
        return result

    monkeypatch.setattr(run, "run_eval", run_eval)
    _one_second_clips(monkeypatch)
    res = run.main(["env=im", "eval_frequency=1", "max_epochs=3", f"output_dir={tmp_path}", *TINY])
    assert len(evals) == 2 and len(res.metrics) == 3
    assert [e.per_motion_steps.tolist() for e in evals] == [[29.0] * 4] * 2
    motion = res.agent.env.motion
    want = update_hard_sampling_weight(motion, torch.as_tensor(evals[-1].failed_motions)).sampling_prob
    assert torch.equal(motion.sampling_prob, want) and want.tolist() == [0.5, 0.0, 0.0, 0.5]
    ids, _ = res.agent.env._sample_reset(64)
    assert set(ids.tolist()) <= {0, 3}


def test_cli_distills_from_a_teacher_checkpoint_and_resumes(trained, tmp_path, capsys):
    """Two epochs of env=im_vae learning=im_z_fit with the env=im run's
    policy as the frozen teacher, then a resume to a third."""
    teacher = trained[0] / "im" / "ckpt"
    args = [*DISTILL, f"learning.teacher_checkpoint={teacher}", "exp_name=d", f"output_dir={tmp_path}"]
    res = run.main([*args, "max_epochs=2"])
    first = capsys.readouterr().out
    assert f"teacher restored from {teacher / 'epoch_2.pt'}" in first and "epoch=1" in first
    env, agent = res.agent.env, res.agent
    assert type(env).__name__ == "HumanoidImGetupEnv" and env.config.cycle_motion and env.config.power_reward
    assert env.config.episode_length == 300 and not env._fused_step_ok()
    rows = [json.loads(l) for l in (tmp_path / "d" / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0, 1]
    for k in ("bc_loss", "kld", "ar1", "prior_reg", "kld_coef", "reward_mean", "rollout_s", "update_s"):
        assert all(np.isfinite(r[k]) for r in rows), k
    assert res.train_state.epoch == 2 and float(res.train_state.obs_rms.count) == pytest.approx(2 * 8 * 4, abs=1e-3)
    # the teacher is the checkpoint's network, frozen, its normalizer too
    ck = torch.load(teacher / "epoch_2.pt", weights_only=True)
    sd = agent.teacher_fn.network.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in ck["network"].items())
    assert agent.teacher_fn.obs_rms.frozen and not any(p.requires_grad for p in agent.teacher_fn.network.parameters())
    assert torch.equal(agent.teacher_fn.obs_rms.mean, ck["obs_rms"]["mean"])
    saved = torch.load(tmp_path / "d" / "ckpt" / "epoch_2.pt", weights_only=True)
    assert saved["epoch"] == 2 and "value_rms" not in saved and "encoder.z_mu.weight" in saved["network"]

    res = run.main([*args, "max_epochs=3", "epoch=-1"])
    second = capsys.readouterr().out
    assert "restored" in second and "epoch=2" in second and "epoch=0" not in second
    assert res.train_state.epoch == 3 and float(res.train_state.obs_rms.count) == pytest.approx(3 * 8 * 4, abs=1e-3)
    assert torch.load(tmp_path / "d" / "ckpt" / "epoch_3.pt", weights_only=True)["epoch"] == 3


def test_distill_full_precision_reaches_the_network_and_its_checkpoint(trained, tmp_path, monkeypatch):
    """`learning.full_precision` (read as the JAX package reads it, from a
    config that holds it) builds the student float32 and the checkpoint
    keeps the flag; on resume the config, not the checkpoint, sets the
    precision, as in the JAX package; the frozen decoder of env.z_checkpoint
    is float32 whatever the flag."""
    from pulse_tpu_torch.utils import config as port_config

    load = port_config.load_config

    def with_flag(argv):
        cfg = load(argv)
        cfg["learning"]["full_precision"] = True
        return cfg

    args = [*DISTILL, f"learning.teacher_checkpoint={trained[0] / 'im' / 'ckpt'}", "exp_name=d",
            f"output_dir={tmp_path}"]
    monkeypatch.setattr(port_config, "load_config", with_flag)
    res = run.main([*args, "max_epochs=1"])
    assert res.agent.network.full_precision and res.agent.network.encoder.full_precision
    assert torch.load(tmp_path / "d" / "ckpt" / "epoch_1.pt", weights_only=True)["full_precision"] is True
    monkeypatch.setattr(port_config, "load_config", load)
    res = run.main([*args, "max_epochs=2", "epoch=-1"])
    net = res.train_state.network
    assert not (net.full_precision or net.encoder.full_precision or net.prior.full_precision
                or net.decoder.full_precision)
    assert torch.load(tmp_path / "d" / "ckpt" / "epoch_2.pt", weights_only=True)["full_precision"] is False
    z = run.main(["env=speed_z", f"env.z_checkpoint={tmp_path / 'd' / 'ckpt'}", "max_epochs=0",
                  f"output_dir={tmp_path}", *Z_TASK])
    assert z.agent.env.frozen.network.full_precision


@pytest.mark.parametrize("args", [["test=true"], ["eval_frequency=1"]])
def test_distill_has_no_evaluator(args, tmp_path):
    with pytest.raises(NotImplementedError, match="no evaluator"):
        run.main([*DISTILL, *args, f"output_dir={tmp_path}"])


@pytest.mark.parametrize("port_cls, jax_cls", [(EnvConfig, JaxEnvConfig), (PPOConfig, JaxPPOConfig),
                                               (PhysicsConfig, JaxPhysicsConfig),
                                               (DistillConfig, JaxDistillConfig), (AMPConfig, JaxAMPConfig)])
def test_config_defaults_match_jax(port_cls, jax_cls):
    """Every field both packages' config dataclasses have defaults alike, so
    the quality A/B's settings are the JAX arm's."""
    port = {f.name: getattr(port_cls(), f.name) for f in dataclasses.fields(port_cls)}
    want = {f.name: getattr(jax_cls(), f.name) for f in dataclasses.fields(jax_cls)}
    shared = port.keys() & want.keys()
    assert len(shared) >= 10
    for k in shared:
        a, b = port[k], want[k]
        assert (tuple(a) if isinstance(a, (list, tuple)) else a) == (tuple(b) if isinstance(b, (list, tuple)) else b), k



# --------------------------------------------------------------------------- #
# AMP: env=amp, env=amp_getup and env=im with learning=im_amp
# --------------------------------------------------------------------------- #

AMP = ["learning=im_amp", "learning.amp_batch_size=8", "learning.amp_buffer_size=64", "learning.disc_units=[32]"]


@pytest.mark.parametrize("env_args, task", [
    (["env=amp"], "HumanoidAMPEnv"),
    (["env=amp_getup", "env.num_fall_states=8", "env.fall_settle_steps=2", "env.getup_update_epoch=1"],
     "HumanoidAMPGetupEnv"),
    (["env=im"], "HumanoidImEnv"),
])
def test_cli_trains_amp(env_args, task, tmp_path, capsys):
    """Three epochs of AMP training through run.main in process (the CLI's
    own process is test_cli_trains_logs_checkpoints_and_resumes'): the env
    the task names, the AMP metrics logged, task reward 1 on the pure-AMP
    envs (the style reward alone in the getup schedule's first epochs),
    buffers grown by amp_batch_size an epoch, and the checkpoint holds the
    discriminator and both buffers."""
    res = run.main([*env_args, *AMP, "max_epochs=3", "exp_name=a", f"output_dir={tmp_path}", *TINY])
    assert "epoch=2" in capsys.readouterr().out and type(res.agent.env).__name__ == task
    rows = [json.loads(l) for l in (tmp_path / "a" / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0, 1, 2]
    for k in ("disc_loss", "disc_grad_pen", "disc_acc_agent", "disc_acc_demo", "disc_reward_mean",
              "task_reward_mean", "reward_mean", "disc_reward_s", "disc_update_s", "rollout_s", "a_loss"):
        assert all(np.isfinite(r[k]) for r in rows), k
    if task != "HumanoidImEnv":
        assert all(r["task_reward_mean"] == 1.0 for r in rows)
    else:
        assert all(0.0 <= r["task_reward_mean"] <= 1.0 for r in rows)
    for r in rows:
        w = (0.0, 1.0) if "env.getup_update_epoch=1" in env_args and r["epoch"] <= 1 else (0.5, 0.5)
        assert r["reward_mean"] == pytest.approx(w[0] * r["task_reward_mean"] + w[1] * r["disc_reward_mean"],
                                                 rel=1e-5), r["epoch"]
    ck = torch.load(tmp_path / "a" / "ckpt" / "epoch_3.pt", weights_only=True)
    assert ck["epoch"] == 3 and ck["amp"]["replay_buffer"]["size"] == 3 * 8
    assert ck["amp"]["demo_buffer"]["size"] == 64 // 4 + 3 * 8 and "logit.weight" in ck["amp"]["disc"]
    assert float(ck["amp"]["amp_rms"]["count"]) == pytest.approx(3 * (8 * 4 + 8), abs=1e-3)
    assert json.loads((tmp_path / "a" / "config.json").read_text())["learning"]["agent"] == "amp"


@pytest.fixture(scope="module")
def amp_trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("amp")
    res = run.main(["env=amp", *AMP, "max_epochs=2", f"output_dir={out}", "exp_name=a", *TINY])
    return out, res


def test_amp_resume_restores_disc_and_buffers(amp_trained, capsys):
    out, first = amp_trained
    assert type(first.agent.env).__name__ == "HumanoidAMPEnv" and first.agent.env.obs_dim == 358
    amp0 = first.train_state.amp
    res = run.main(["env=amp", *AMP, "max_epochs=2", "epoch=-1", f"output_dir={out}", "exp_name=a", *TINY])
    assert "restored" in capsys.readouterr().out and res.metrics == []   # nothing left to train
    amp = res.train_state.amp
    assert res.train_state.ppo.epoch == 2
    for a, b in zip(amp0.disc.parameters(), amp.disc.parameters()):
        assert torch.equal(a, b)
    for name in ("demo_buffer", "replay_buffer"):
        b0, b1 = getattr(amp0, name), getattr(amp, name)
        assert (b0.head, b0.size) == (b1.head, b1.size) and torch.equal(b0.data, b1.data), name
    assert torch.equal(amp0.amp_rms.mean, amp.amp_rms.mean) and float(amp0.amp_rms.count) == float(amp.amp_rms.count)
    s0, s1 = amp0.optimizer.state_dict()["state"], amp.optimizer.state_dict()["state"]
    assert s0.keys() == s1.keys() and all(torch.equal(s0[k]["exp_avg"], s1[k]["exp_avg"]) for k in s0)
    assert torch.equal(first.train_state.ppo.obs_rms.mean, res.train_state.ppo.obs_rms.mean)


def test_amp_test_true_evaluates_the_ppo_policy(amp_trained, capsys, monkeypatch):
    _one_second_clips(monkeypatch)
    out, _ = amp_trained
    run.main(["env=amp", *AMP, "test=true", "epoch=-1", f"output_dir={out}", "exp_name=a", *TINY])
    text = capsys.readouterr().out
    assert "restored" in text and "epoch=" not in text
    res = json.loads(text[text.index("{"):])
    assert len(res["failed_motions"]) == 4 and res["per_motion_steps"] == [29.0] * 4


# --------------------------------------------------------------------------- #
# MCP, domain randomization and the pd / force control modes
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("args, epochs", [
    (["env=im_mcp"], 2),
    (["env=im_mcp_getup", "env.num_fall_states=8", "env.fall_settle_steps=2"], 2),
    (["env=im", "env.randomize=true"], 2),
    (["env=im", "env.randomize=true", *AMP, "env.shape_resampling_interval=2"], 4),
    (["env=im", "env.control_mode=pd"], 2),
    (["env=im", "env.control_mode=force"], 2),
], ids=["mcp", "mcp_getup", "dr_ppo", "dr_amp", "pd", "force"])
def test_cli_trains_mcp_dr_and_control_modes(args, epochs, tmp_path, monkeypatch):
    """Each trains `epochs` epochs in process with finite losses. MCP: the
    policy's action is the 3 composer weights and the frozen PNN (512-512
    from seed + PNN_SEED_OFFSET) is bit-unchanged. DR: the env's batched model carries
    per-env friction multipliers in [0.7, 1.3], and the AMP agent re-draws
    them before epoch 3 (epoch % 2 == 1 past epoch 1) from the pre-DR
    model. pd / force: the control mode reaches the env, off the kernels'
    surface."""
    redraws = []
    real = HumanoidImEnv.randomize_physical_props
    monkeypatch.setattr(HumanoidImEnv, "randomize_physical_props",
                        lambda self, *a, **k: (redraws.append(1), real(self, *a, **k))[1])
    res = run.main([*args, f"max_epochs={epochs}", f"output_dir={tmp_path}", "exp_name=x", *TINY])
    env, ms = res.agent.env, res.metrics
    assert len(ms) == epochs and all(np.isfinite(m["a_loss"]) and np.isfinite(m["reward_mean"]) for m in ms)
    if "mcp" in args[0]:
        assert type(env).__name__ == ("HumanoidImMCPGetupEnv" if "getup" in args[0] else "HumanoidImMCPEnv")
        assert env.action_dim == 3 and env.pnn.units == (512, 512)
        fresh = PNN(env.obs_dim, 69, 3, (512, 512), device="cpu", seed=run.PNN_SEED_OFFSET)   # cfg seed 0
        assert all(torch.equal(a, b) for a, b in zip(env.pnn.state_dict().values(), fresh.state_dict().values()))
        assert res.train_state.network.mu.out_features == 3
    if "env.randomize=true" in args:
        m = env.batched_model.cp_friction[:, 0] / env.model.cp_friction[0]
        assert ((m >= 0.7) & (m <= 1.3)).all() and m.unique().numel() == 8
        assert env._prop_rand_base is env.model and env.config.dr.frequency == 600
        assert len(redraws) == (2 if "learning=im_amp" in args else 1)
    if "env.control_mode=pd" in args or "env.control_mode=force" in args:
        assert env.config.control_mode == args[1].split("=")[1] and not env._kernel_surface()


# --------------------------------------------------------------------------- #
# PULSE stage 3: the task envs and their latent-action (Z) forms
# --------------------------------------------------------------------------- #

Z_TASK = ["learning=pulse_z_task", "learning.amp_batch_size=8", "learning.amp_buffer_size=64",
          "learning.disc_units=[32]", *TINY]


@pytest.fixture(scope="module")
def distilled(trained, tmp_path_factory):
    """The checkpoint directory of a one-epoch tiny distillation from the
    env=im run's policy."""
    out = tmp_path_factory.mktemp("distilled")
    run.main([*DISTILL, f"learning.teacher_checkpoint={trained[0] / 'im' / 'ckpt'}", "max_epochs=1",
              f"output_dir={out}", "exp_name=d"])
    return out / "d" / "ckpt"


@pytest.mark.parametrize("env_name, task, obs_dim", [
    ("speed_z", "HumanoidSpeedEnv", 361), ("reach_z", "HumanoidReachEnv", 361), ("traj_z", "HumanoidTrajEnv", 378),
    ("im_z", "HumanoidImEnv", 934),
])
def test_cli_trains_z_tasks_on_a_distill_checkpoint(distilled, env_name, task, obs_dim, tmp_path, capsys):
    """Two epochs of `learning=pulse_z_task` (PPO + AMP on the task reward)
    with the policy acting in the 32-d latent space of the distillation
    run's frozen PulseVAE: the wrapped env the task names, the
    checkpoint's widths (64-unit encoder, 32 prior, 64 decoder) and
    obs_rms, the prior and decoder bit-unchanged by training, the task
    reward in [0, 1], finite losses."""
    res = run.main([f"env={env_name}", f"env.z_checkpoint={distilled}", "max_epochs=2", f"output_dir={tmp_path}",
                    *Z_TASK])
    assert f"frozen z model restored from {distilled / 'epoch_1.pt'}" in capsys.readouterr().out
    env = res.agent.env
    assert type(env).__name__ == "ZActionWrapper" and type(env.env).__name__ == task
    assert env.action_dim == 32 and env.obs_dim == obs_dim and res.train_state.ppo.network.mu.out_features == 32
    ck = torch.load(distilled / "epoch_1.pt", weights_only=True)
    net = env.frozen.network
    assert net.encoder.trunk[0].in_features == 934 and net.prior.trunk[0].out_features == 32
    sd = net.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in ck["network"].items())
    assert torch.equal(env.frozen.obs_rms.var, ck["obs_rms"]["var"]) and env.frozen.obs_rms.frozen
    assert len(res.metrics) == 2
    for m in res.metrics:
        assert all(np.isfinite(m[k]) for k in ("a_loss", "c_loss", "disc_loss", "reward_mean"))
        assert 0.0 <= m["task_reward_mean"] <= 1.0


def test_z_without_checkpoint_draws_a_fresh_decoder(tmp_path):
    res = run.main(["env=speed_z", "max_epochs=1", f"output_dir={tmp_path}", *Z_TASK])
    net = res.agent.env.frozen.network
    from pulse_tpu_torch.learning.networks import PulseVAE

    fresh = PulseVAE(361, 69, latent_dim=32, self_obs_dim=358, device="cpu", seed=0).state_dict()
    assert all(torch.equal(v, fresh[k]) for k, v in net.state_dict().items())
    assert torch.equal(res.agent.env.frozen.obs_rms.var, torch.ones(361))


@pytest.mark.parametrize("env_name", ["speed_z", "im_z"])
def test_z_test_true_prints_the_eval_result(distilled, env_name, tmp_path, capsys, monkeypatch):
    """test=true on a task env prints task_eval's TaskEvalResult over one
    episode length; on env=im_z the wrapper reaches im_eval's motion sweep
    (reset_to through the wrapper, early termination off by with_config)
    and prints an EvalResult."""
    _one_second_clips(monkeypatch)
    args = [f"env={env_name}", f"env.z_checkpoint={distilled}", f"output_dir={tmp_path}", "max_epochs=1", *Z_TASK,
            *(["env.episode_length=12"] if env_name == "speed_z" else [])]
    run.main(args)
    capsys.readouterr()
    run.main([*args, "test=true", "epoch=-1"])
    out = capsys.readouterr().out
    assert "restored" in out and "epoch=" not in out
    res = json.loads(out[out.index("{"):])
    if env_name == "speed_z":
        assert set(res) == {"episodes", "return_mean", "return_std", "length_mean", "terminate_rate",
                            "reward_per_step"}
        assert res["episodes"] >= 8 and 0.0 <= res["terminate_rate"] <= 1.0 and 0 < res["length_mean"] <= 12
        assert all(np.isfinite(v) for v in res.values())
    else:
        assert len(res["failed_motions"]) == 4 and res["per_motion_steps"] == [29.0] * 4


def test_task_eval_statistics_on_a_scripted_env():
    """Returns banked at done, the terminate rate over episodes done, the
    reward per step the mean of the steps' means, the env's generator
    re-seeded."""
    from types import SimpleNamespace

    from pulse_tpu_torch.eval import task_eval

    rewards = torch.tensor([[1.0, 0.5], [2.0, 0.5], [3.0, 0.5], [4.0, 0.5], [5.0, 0.5], [6.0, 0.5]])
    dones = torch.tensor([[0, 0], [0, 0], [1, 0], [0, 1], [0, 0], [1, 0]], dtype=torch.bool)
    terms = torch.tensor([[0, 0], [0, 0], [1, 0], [0, 0], [0, 0], [0, 0]], dtype=torch.bool)

    class Scripted:
        config = SimpleNamespace(episode_length=6)

        def __init__(self):
            self.generator, self.t, self.seen = torch.Generator().manual_seed(99), 0, []

        def reset(self, n):
            self.first_draw = float(torch.rand(1, generator=self.generator))
            return SimpleNamespace(obs=torch.zeros(n, 3), reward=torch.zeros(n))

        def step(self, st, action):
            self.seen.append(action)
            t, self.t = self.t, self.t + 1
            return SimpleNamespace(obs=st.obs + 1, reward=rewards[t], done=dones[t], terminate=terms[t])

    env = Scripted()
    res = task_eval(env, lambda obs: obs[:, :1], batch_size=2, seed=4)
    assert env.t == 6 and [float(a[0, 0]) for a in env.seen] == [0, 1, 2, 3, 4, 5]
    assert env.first_draw == float(torch.rand(1, generator=torch.Generator().manual_seed(4)))
    returns, lengths = np.array([6.0, 15.0, 2.0]), np.array([3, 3, 4])
    assert res.episodes == 3 and res.terminate_rate == pytest.approx(1 / 3)
    assert res.return_mean == pytest.approx(returns.mean()) and res.return_std == pytest.approx(returns.std(), rel=1e-5)
    assert res.length_mean == pytest.approx(lengths.mean())
    assert res.reward_per_step == pytest.approx(float(rewards.mean(dim=1).mean()))


def test_use_wandb_raises(tmp_path):
    with pytest.raises(ValueError, match="wandb"):
        run.main(["use_wandb=true", "device=cpu", f"output_dir={tmp_path}"])


def test_eval_frequency_skips_a_task_env(tmp_path, monkeypatch):
    """The JAX package's eval_frequency evaluates only envs with reset_to:
    a task env trains on, unevaluated."""
    evals = []
    monkeypatch.setattr(run, "run_eval", lambda *a: evals.append(a))
    res = run.main(["env=speed", "eval_frequency=1", "max_epochs=3", f"output_dir={tmp_path}", *Z_TASK])
    assert len(res.metrics) == 3 and evals == []
