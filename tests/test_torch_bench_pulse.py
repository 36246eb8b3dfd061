"""`python -m pulse_tpu_torch.bench_pulse` against the JAX package's
`tools/bench_pulse.py` on the CPU:

  * the harness at a tiny size (8 envs, one epoch of horizon 4 a stage,
    32-24 networks, 8-step task episodes, 4 prior steps), first stopped
    after the teacher, then resumed from its snapshot to the end: it writes
    the keys of `quality/pulse_stages_r5.json` (every section's too) plus
    the port's, and `targets` names the seven committed targets;
  * the target check on the r5 file's own numbers (all met), and with one
    value moved past its bound (that one fails);
  * the prior-sampling action against the tool's `prior_step` body on a
    narrow float32 PulseVAE carried over by `pulse_vae_from_jax`, the same
    running stats, obs and noise: within 1e-5 (float32, sums in another
    order);
  * `upright_frac` and `finite` on hand-made states.
"""

import copy
import json
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pulse_tpu.learning.networks import PulseVAE as JaxPulseVAE
from pulse_tpu.learning.running_norm import RunningMeanStd as JaxRMS

from pulse_tpu_torch import bench_pulse
from pulse_tpu_torch.learning.networks import pulse_vae_from_jax
from pulse_tpu_torch.learning.running_norm import RunningMeanStd

ROOT = Path(__file__).resolve().parent.parent
R5 = json.loads((ROOT / "quality" / "pulse_stages_r5.json").read_text())
TINY = ["--device", "cpu", "--teacher_epochs", "1", "--distill_epochs", "1", "--task_epochs", "1", "--envs", "8",
        "--horizon", "4", "--minibatch", "16", "--units", "32,24", "--task_episode_length", "8", "--prior_steps", "4"]


def test_bench_pulse_writes_the_jax_tools_keys_and_resumes(tmp_path, capsys):
    first = bench_pulse.main([*TINY, "--out", str(tmp_path), "--stop_after", "teacher"])
    assert "teacher" in first and "student" not in first and (tmp_path / "teacher.pt").exists()
    assert not (tmp_path / "student.pt").exists()
    capsys.readouterr()

    res = bench_pulse.main([*TINY, "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[teacher] restored" in out and "[student] restored" not in out
    assert json.loads((tmp_path / "pulse_stages.json").read_text()) == res
    assert set(res) == set(R5) | {"port", "gpu", "timing", "curves", "targets"}
    for section, keys in R5.items():
        if isinstance(keys, dict):
            assert set(res[section]) == set(keys), section
    assert res["port"] == "cpu" and res["gpu"] is None and res["committed_targets"] == R5["committed_targets"]
    assert res["epochs"] == {"teacher": 1, "distill": 1, "task": 1} and res["num_clips"] == 8
    assert res["protocol"]["tool"] == "pulse_tpu_torch/bench_pulse.py" and "CPU" in res["protocol"]["suite"]
    assert set(res["targets"]) == set(R5["committed_targets"])
    for name, t in res["targets"].items():
        assert t["bound"] == R5["committed_targets"][name] and isinstance(t["pass"], bool), name
    # the restored teacher keeps the time and curve of the run that trained it
    assert res["timing"]["teacher"] == first["timing"]["teacher"] | {"eval_s": res["timing"]["teacher"]["eval_s"]}
    assert res["teacher"] == first["teacher"]
    assert set(res["timing"]) == {"teacher", "student", "prior_sampling", "speed_z", "reach_z"}
    for stage in ("teacher", "student", "speed_z", "reach_z"):
        assert res["timing"][stage]["train_env_steps_per_s"] > 0 and res["curves"][stage][0]["epoch"] == 0
    assert {"bc_loss", "kld"} <= set(res["curves"]["student"][0])
    assert res["prior_sampling"]["envs"] == 256 and res["prior_sampling"]["steps"] == 4
    assert 0.0 <= res["prior_sampling"]["upright_frac"] <= 1.0
    assert all(np.isfinite(res[s]["return_mean"]) for s in ("speed_z", "reach_z"))
    student = torch.load(tmp_path / "student.pt", weights_only=True)
    assert student["full_precision"] is True and not any(k.startswith("critic") for k in student["network"])
    assert {p.name for p in tmp_path.glob("*.pt")} == {"teacher.pt", "student.pt", "speed_z.pt", "reach_z.pt"}


def test_targets_pass_on_the_r5_numbers_and_name_a_miss():
    report = copy.deepcopy(R5)
    got = bench_pulse.check_targets(report, R5["committed_targets"])
    assert set(got) == set(R5["committed_targets"]) and all(t["pass"] for t in got.values())
    assert got["prior_upright_frac_min"]["value"] == R5["prior_sampling"]["upright_frac"]
    report["reach_z"]["terminate_rate"] = 0.03
    got = bench_pulse.check_targets(report, R5["committed_targets"])
    assert [k for k, t in got.items() if not t["pass"]] == ["reach_z_terminate_rate_max"]
    report["reach_z"]["terminate_rate"] = R5["reach_z"]["terminate_rate"]
    report["speed_z"]["return_mean"] = float("nan")
    del report["student"]
    got = bench_pulse.check_targets(report, R5["committed_targets"])
    assert sorted(k for k, t in got.items() if not t["pass"]) == [
        "speed_z_return_mean_min", "student_mpjpe_pa_gap_mm_max", "student_success_gap_vs_teacher_max"]


def test_prior_action_matches_the_tools_prior_step():
    O, S, L, A, N = 40, 12, 8, 5, 16
    vae = JaxPulseVAE(action_dim=A, latent_dim=L, self_obs_dim=S, encoder_units=(64,), prior_units=(32,),
                      decoder_units=(64,), critic_units=(32,))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(vae.init)(jax.random.PRNGKey(0), jnp.zeros((1, O)),
                                                                  jnp.zeros((1, L)))["params"])
    params["decoder"]["Dense_0"]["bias"] = np.linspace(-2, 2, A).astype(np.float32)   # some actions past the clip
    rng = np.random.default_rng(0)
    obs = (2.0 * rng.standard_normal((N, O)) + 0.5).astype(np.float32)
    eps = rng.standard_normal((N, L)).astype(np.float32)
    mean, var = (0.3 * rng.standard_normal(O)).astype(np.float32), rng.uniform(0.5, 2.0, O).astype(np.float32)
    s_rms = JaxRMS(mean=jnp.asarray(mean), var=jnp.asarray(var), count=jnp.asarray(100.0))

    # the body of tools/bench_pulse.py's prior_step, up to the env step
    obs_n = s_rms.normalize(jnp.asarray(obs))
    self_obs = obs_n[..., : vae.self_obs_dim]
    prior_mu, prior_logvar = vae.apply({"params": params}, self_obs, method=JaxPulseVAE.prior_params)
    z = prior_mu + jnp.exp(0.5 * prior_logvar) * jnp.asarray(eps)
    want = np.asarray(jnp.clip(vae.apply({"params": params}, self_obs, z, method=JaxPulseVAE.decode), -1.0, 1.0))

    net = pulse_vae_from_jax(params, full_precision=True, device="cpu")
    rms = RunningMeanStd(mean=torch.tensor(mean), var=torch.tensor(var), count=torch.tensor(100.0)).freeze()
    got = bench_pulse.prior_action(net, rms, torch.tensor(obs), torch.tensor(eps)).numpy()
    assert (np.abs(want) == 1.0).any() and (np.abs(want) < 1.0).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("root_z, poison, frac, finite", [
    ([0.9, 0.31, 0.3, 0.1], None, 0.5, True),              # 0.3 itself is down
    ([0.9, float("nan"), 0.8, 0.7], "root", 0.75, False),  # a NaN root is down, and not finite
    ([0.9, 0.9, 0.9, 0.9], "body", 1.0, False),            # an inf body elsewhere: upright, not finite
    ([float("inf"), 0.2, 0.2, 0.2], None, 0.0, True),      # an inf root is not upright
])
def test_upright_stats_on_hand_made_states(root_z, poison, frac, finite):
    root = torch.tensor(root_z)
    body = torch.zeros(4, 24, 3)
    body[:, 0, 2] = torch.nan_to_num(root, posinf=0.0)
    if poison == "root":
        body[1, 0, 2] = float("nan")
    if poison == "body":
        body[2, 7, 0] = float("inf")
    assert bench_pulse.upright_stats(root, body) == (frac, finite)
