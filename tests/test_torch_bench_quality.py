"""`python -m pulse_tpu_torch.bench_quality` on the CPU at a tiny size (8
envs, 1 epoch of horizon 4, a narrow network): it trains, evaluates the 6
hard clips and writes the keys of the JAX package's quality tool
(quality/ab_*_r5.json), with the device in place of `pallas`."""

import json
from pathlib import Path

from pulse_tpu_torch import bench_quality

ROOT = Path(__file__).resolve().parent.parent


def test_bench_quality_writes_the_jax_tools_keys(tmp_path):
    out = tmp_path / "q.json"
    res = bench_quality.main(["--device", "cpu", "--epochs", "1", "--envs", "8", "--horizon", "4",
                              "--units", "32,24", "--out", str(out)])
    assert json.loads(out.read_text()) == res
    jax_keys = set(json.loads((ROOT / "quality" / "ab_pallas_r5.json").read_text())) - {"pallas"}
    assert jax_keys | {"port", "gpu", "eval_time_s", "curve"} == set(res)
    assert res["port"] == "cpu" and res["gpu"] is None and res["train_steps"] == 8 * 4
    assert list(res["per_clip"]) == ["fast_run", "spin", "jump", "getup_supine", "sharp_turns", "crouch_walk"]
    assert res["curve"][0]["epoch"] == 0 and 0.0 <= res["success_rate"] <= 1.0
