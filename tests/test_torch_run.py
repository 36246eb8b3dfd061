"""The port's training CLI on the CPU at a tiny size:

    python -m pulse_tpu_torch.run env=im_getup device=cpu num_envs=8 ...

with a narrow network, 8 fall states settled for 2 steps and a horizon of
4. It must write the config, a metrics JSONL line per epoch and a
checkpoint, and a second run with `epoch=-1` must restore that checkpoint
and go on from its epoch. Options the slice does not port raise
NotImplementedError before anything is built.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pulse_tpu_torch import _build, run

ROOT = Path(__file__).resolve().parent.parent
TINY = ["device=cpu", "num_envs=8", "learning.horizon_length=4", "learning.minibatch_size=16",
        "learning.mini_epochs=2", "learning.actor_units=[32,24]", "learning.critic_units=[32,24]", "log_frequency=1"]
GETUP = ["env=im_getup", "env.num_fall_states=8", "env.fall_settle_steps=2"]


def _cli(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "pulse_tpu_torch.run", *args, f"output_dir={tmp_path}"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_cli_trains_logs_checkpoints_and_resumes(tmp_path):
    first = _cli([*GETUP, "max_epochs=1", "exp_name=g", *TINY], tmp_path)
    exp = tmp_path / "g"
    assert json.loads((exp / "config.json").read_text())["env"]["task"] == "HumanoidImGetup"
    rows = [json.loads(l) for l in (exp / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0] and "epoch=0" in first
    for k in ("a_loss", "c_loss", "b_loss", "reward_mean", "rollout_s", "gae_s", "update_s"):
        assert k in rows[0] and rows[0][k] == rows[0][k], k
    ck = torch.load(exp / "ckpt" / "epoch_1.pt", weights_only=True)
    assert ck["epoch"] == 1 and float(ck["obs_rms"]["count"]) > 8 * 4

    second = _cli([*GETUP, "max_epochs=2", "exp_name=g", "epoch=-1", *TINY], tmp_path)
    assert "restored" in second and "epoch=1" in second and "epoch=0" not in second
    assert torch.load(exp / "ckpt" / "epoch_2.pt", weights_only=True)["epoch"] == 2


def test_main_runs_env_im_in_process(tmp_path):
    before = dict(_build.launches)
    res = run.main(["env=im", "max_epochs=2", f"output_dir={tmp_path}", *TINY])
    assert _build.launches == before   # the CPU runs the plain versions: no kernel launched
    assert len(res.metrics) == 2 and res.train_state.epoch == 2
    assert res.agent.env._fused_step_ok()
    assert float(res.train_state.obs_rms.count) == pytest.approx(2 * 8 * 4, abs=1e-3)


@pytest.mark.parametrize("args", [
    ["test=true"], ["eval_frequency=5"], ["env.task=HumanoidImDistillGetup"], ["env.task=HumanoidImMCP"],
    ["env.task=HumanoidSpeedZ"], ["learning.agent=amp"], ["learning.agent=distill"],
    ["env.randomize=true"], ["env=im_getup", "env.shape_variation=true"], ["env.control_mode=pd"],
    ["env.motion_file=x.pkl"],
])
def test_unported_options_raise(args, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run.main(["device=cpu", f"output_dir={tmp_path}", *args])
