"""The port's config loader against the JAX package's, on the CPU.

The port parses its YAML without PyYAML; its copies of the config files the
training slice reads must give exactly what PyYAML gives for the JAX
package's files (the root gains only `device`, env/im.yaml only
`shape_resampling_interval: 0`, so that the AMP agent's re-draw of domain
randomization's props can be set on env=im), and `load_config` must
compose the same tree for the same group selections and dotted overrides,
and reject the same unknown keys.
"""

from pathlib import Path

import pytest
import yaml

from pulse_tpu.utils import config as jax_config

from pulse_tpu_torch.utils import config as port_config

ROOT = Path(__file__).resolve().parent.parent
COPIES = ("env/im.yaml", "env/im_getup.yaml", "learning/im_ppo.yaml", "robot/smpl_humanoid.yaml", "sim/default.yaml",
          "env/im_vae.yaml", "learning/im_z_fit.yaml", "env/im_vr.yaml", "env/amp.yaml", "env/amp_getup.yaml",
          "learning/im_amp.yaml", "env/im_mcp.yaml", "env/im_mcp_getup.yaml", "env/speed.yaml", "env/speed_z.yaml",
          "env/reach.yaml", "env/reach_z.yaml", "env/traj.yaml", "env/traj_z.yaml", "env/im_z.yaml",
          "learning/pulse_z_task.yaml")
# keys the port's copies add to the JAX package's files, with their values
PORT_ONLY = {"config.yaml": {"device": "cuda"}, "env/im.yaml": {"shape_resampling_interval": 0}}


@pytest.mark.parametrize("name", COPIES + ("config.yaml",))
def test_config_copies_parse_as_pyyaml_reads_the_originals(name):
    want = yaml.safe_load((ROOT / "pulse_tpu" / "configs" / name).read_text())
    got = port_config.parse_yaml((ROOT / "pulse_tpu_torch" / "configs" / name).read_text())
    for k, v in PORT_ONLY.get(name, {}).items():
        assert got.pop(k) == v
    assert got == want


@pytest.mark.parametrize("path", sorted((ROOT / "pulse_tpu" / "configs").rglob("*.yaml")), ids=lambda p: p.name)
def test_parser_reads_every_config_of_the_repo_as_pyyaml(path):
    assert port_config.parse_yaml(path.read_text()) == (yaml.safe_load(path.read_text()) or {})


@pytest.mark.parametrize("text", ["8", "1e-4", "2.0e-5", "-0.5", "1.", "-3", "0", "0.0166667", "true", "FALSE",
                                  "null", "~", "", "abc", "'q'", '"d"', "'it''s'", "R_Ankle", "[32, 24]", "[a, [1, 2.5]]",
                                  "{a: 1, b: [x]}"])
def test_override_values_resolve_as_pyyaml(text):
    assert port_config.parse_value(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["+.inf", ".nan", "1_000", "0x1F", "017", "Off", "yes"])
def test_yaml_1_1_scalars_outside_the_subset_raise(text):
    """PyYAML reads these as numbers or bools; the port's parser refuses
    them rather than read a different value."""
    assert not isinstance(yaml.safe_load(text), str)
    with pytest.raises(ValueError, match="unsupported"):
        port_config.parse_value(text)


@pytest.mark.parametrize("overrides", [
    ["env=im"],
    ["env=im", "learning=im_ppo", "num_envs=3072", "learning.minibatch_size=512", "env.termination_distance=0.5"],
    ["env=im_getup"],
    ["env=im_getup", "num_envs=8", "max_epochs=1", "learning.horizon_length=4", "learning.actor_units=[32,24]",
     "env.num_fall_states=8", "env.fall_settle_steps=2", "learning.learning_rate=1e-4", "exp_name=x"],
    ["env=amp_getup", "learning=im_amp", "env.getup_update_epoch=1", "learning.disc_units=[32]",
     "learning.amp_batch_size=8"],
    ["env=speed_z", "learning=pulse_z_task", "env.z_checkpoint=output/d/ckpt", "env.tar_speed_max=3.0"],
    ["env=im_z", "learning=pulse_z_task", "env.use_pallas_physics=false"],
])
def test_load_config_matches_jax(overrides):
    got = port_config.load_config(overrides)
    assert got.pop("device") == "cuda"
    if got["env"]["_name"] == "im":
        assert got["env"].pop("shape_resampling_interval") == 0
    assert got == jax_config.load_config(overrides)


@pytest.mark.parametrize("bad", ["env.no_such_key=1", "learning.horizon=4", "nope=1", "env.reward_specs.k_foo=1"])
def test_load_config_rejects_unknown_keys(bad):
    with pytest.raises(KeyError):
        port_config.load_config(["env=im_getup", bad])
    with pytest.raises(KeyError):
        jax_config.load_config(["env=im_getup", bad])


def test_device_override():
    assert port_config.load_config(["device=cpu"])["device"] == "cpu"
