"""The port's reference `.pth` importers (`pulse_tpu_torch/utils/checkpoint.py`)
against the JAX package's (`pulse_tpu/utils/checkpoint.py`) on the CPU.

One state dict is built as the reference's rl-games builders lay it out
(torch modules saved under the reference's key names, as
tests/test_torch_import.py builds it for the JAX importer): a PulseVAE
(`z_mlp` with its unactivated 5 x latent bottleneck, `z_prior*`,
`actor_mlp` / `mu`, `critic_mlp` / `value`), a PNN of 3 columns with its lateral stacks, a PNN without
laterals, a composer and the running stats. Each importer's module runs on
the same numpy inputs as the flax module the JAX importer fills and as the
torch module the weights were saved from: 1e-5 apart (float32 GEMMs in
another order). The PNN's stacked [N, in, out] weights are the one place
a weight is transposed: the lateral case fails on a transpose too many or
too few.

Then one epoch of `run.main` at a tiny size on each option that raised
before this port (ROADMAP item 11b): `env=im_mcp` and `env=im_mcp_getup`
with `env.pnn_checkpoint`, distillation from a PNN and composer teacher
(`learning.teacher_pnn_checkpoint` + `teacher_composer_checkpoint`, or the
composer from the PNN's file), `env=speed_z` with `env.z_checkpoint=<x>.pth`
(each held against the torch modules the checkpoint was saved from), and
the strike and pedestrian-terrain tasks in their Z forms; the port's own
`epoch_N.pt` keeps loading as before (tests/test_torch_run.py).
"""

import argparse
import os
import pickle
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn as nn

from pulse_tpu.learning.networks import PulseVAE as JaxPulseVAE
from pulse_tpu.learning.pnn import PNN as JaxPNN, MCPComposer as JaxComposer
from pulse_tpu.utils import checkpoint as jck

from test_torch_import import RefTorchPNN, mlp_seq, sd_numpy

from pulse_tpu_torch import run
from pulse_tpu_torch.learning.pnn import make_pnn_mcp_teacher
from pulse_tpu_torch.utils import checkpoint as ck

OBS, SELF_OBS, EMB, ACT = 20, 12, 8, 10
UNITS, PRIOR_UNITS = (32, 16), (24, 12)
TOL = 1e-5
TINY = ["device=cpu", "num_envs=4", "learning.horizon_length=4", "learning.minibatch_size=16",
        "learning.mini_epochs=1", "log_frequency=1"]


def _vae_modules(obs, self_obs, emb, act, units=UNITS, prior_units=PRIOR_UNITS, seed=0):
    torch.manual_seed(seed)
    return {
        "z_mlp": mlp_seq(obs, units, final=emb * 5), "z_mu": nn.Linear(emb * 5, emb),
        "z_logvar": nn.Linear(emb * 5, emb), "z_prior": mlp_seq(self_obs, prior_units),
        "z_prior_mu": nn.Linear(prior_units[-1], emb), "z_prior_logvar": nn.Linear(prior_units[-1], emb),
        "actor_mlp": mlp_seq(self_obs + emb, units), "mu": nn.Linear(units[-1], act),
        "critic_mlp": mlp_seq(obs, units), "value": nn.Linear(units[-1], 1),
    }


def _rms_sd(dim, seed):
    rng = np.random.RandomState(seed)
    return {"running_mean_std.running_mean": rng.rand(dim).astype(np.float64),
            "running_mean_std.running_var": (1 + rng.rand(dim)).astype(np.float64),
            "running_mean_std.count": np.asarray(12345.0)}


def _sd(mods, prefix="a2c_network"):
    out = {}
    for name, m in mods.items():
        out.update(sd_numpy(f"{prefix}.{name}", m))
    return out


def _save(path, sd):
    torch.save({"model": {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}, "epoch": 7}, path)
    return str(path)


@pytest.fixture(scope="module")
def built():
    vae = _vae_modules(OBS, SELF_OBS, EMB, ACT)
    sd = {**_sd(vae), **_rms_sd(OBS, 13)}
    torch.manual_seed(7)
    ref_pnn = RefTorchPNN(OBS, (32, 16), ACT, 3)
    torch.manual_seed(9)
    plain_cols = [mlp_seq(OBS, UNITS, act=nn.SiLU, final=ACT) for _ in range(2)]
    plain_sd = {}
    for c, a in enumerate(plain_cols):
        plain_sd.update(sd_numpy(f"a2c_network.pnn.actors.{c}", a))
    torch.manual_seed(11)
    comp = mlp_seq(OBS, (24,), act=nn.ReLU, final=3)
    x = np.random.RandomState(1).randn(5, OBS).astype(np.float32)
    noise = np.random.RandomState(2).randn(5, EMB).astype(np.float32)
    return dict(vae=vae, sd=sd, ref_pnn=ref_pnn, pnn_sd=sd_numpy("a2c_network.pnn", ref_pnn),
                plain_cols=plain_cols, plain_sd=plain_sd, comp=comp, comp_sd=sd_numpy("a2c_network.composer", comp),
                x=x, noise=noise)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got), np.asarray(want), rtol=0,
                               atol=tol)


def test_load_torch_checkpoint_and_format(tmp_path, built):
    path = _save(tmp_path / "Humanoid_00000007.pth", built["sd"])
    got, want = ck.load_torch_checkpoint(path), jck.load_torch_checkpoint(path)
    assert got["epoch"] == want["epoch"] == 7 and set(got["model"]) == set(want["model"])
    assert all(np.array_equal(got["model"][k].numpy(), want["model"][k]) for k in want["model"])
    assert ck.is_reference_checkpoint(got)
    assert not ck.is_reference_checkpoint({"network": {"encoder.z_mu.weight": torch.zeros(1)}, "epoch": 1})


def test_only_a_reference_file_loads_its_whole_pickle(tmp_path, built, capsys):
    """A file that holds more than tensors is read whole only where a
    reference file is expected (`env.z_checkpoint`, the importers), and
    that is printed; the port's own checkpoints (resume, teacher_checkpoint)
    stay on `weights_only` and refuse it."""
    path = str(tmp_path / "Humanoid_00000007.pth")
    torch.save({"model": {k: torch.as_tensor(np.asarray(v)) for k, v in built["sd"].items()}, "epoch": 7,
                "env_info": argparse.Namespace(num_envs=4)}, path)
    assert ck.load_torch_checkpoint(path)["env_info"].num_envs == 4
    assert "its whole pickle was loaded" in capsys.readouterr().out
    with pytest.raises(pickle.UnpicklingError):
        run._load_run_checkpoint(path, "cpu")
    assert ck.is_reference_checkpoint(run._load_run_checkpoint(path, "cpu", reference_ok=True)[1])
    # a run's ckpt/ directory holds the port's own files: never read whole
    os.makedirs(tmp_path / "ckpt")
    shutil.copy(path, tmp_path / "ckpt" / "epoch_1.pt")
    with pytest.raises(pickle.UnpicklingError):
        run._load_run_checkpoint(str(tmp_path / "ckpt"), "cpu", reference_ok=True)


def test_pulse_vae_spec_matches_jax(built):
    spec = ck.pulse_vae_spec_from_torch(built["sd"])
    want = jck.pulse_vae_spec_from_torch(built["sd"])
    assert {k: spec[k] for k in want} == want and spec["obs_dim"] == OBS
    assert spec["encoder_units"] == UNITS and spec["prior_units"] == PRIOR_UNITS and spec["latent_dim"] == EMB


def test_import_encoder_prior_decoder_match_jax_and_torch(built):
    sd, m, x = built["sd"], built["vae"], built["x"]
    jnet = JaxPulseVAE(**jck.pulse_vae_spec_from_torch(sd), activation="silu")
    params = jck.import_pulse_vae(sd)
    enc, prior, dec = (ck.import_z_encoder(sd, device="cpu"), ck.import_z_prior(sd, device="cpu"),
                       ck.import_z_decoder(sd, device="cpu"))
    xt = torch.as_tensor(x)
    with torch.no_grad():
        h = m["z_mlp"](xt)
        mu, lv = enc(xt)
        _close(mu, m["z_mu"](h))
        _close(lv, m["z_logvar"](h))
        ph = m["z_prior"](xt[:, :SELF_OBS])
        pmu, plv = prior(xt[:, :SELF_OBS])
        _close(pmu, m["z_prior_mu"](ph))
        _close(plv, torch.clamp(m["z_prior_logvar"](ph), -8.0, 2.0))
        z = torch.as_tensor(built["noise"])
        _close(dec(xt[:, :SELF_OBS], z), m["mu"](m["actor_mlp"](torch.cat([xt[:, :SELF_OBS], z], -1))))
    jmu, jlv = jnet.apply({"params": params}, jnp.asarray(x), method=lambda mdl, o: mdl.encoder(o))
    _close(mu, jmu)
    _close(lv, jlv)


def test_import_pulse_vae_matches_jax(built):
    sd, x, noise = built["sd"], built["x"], built["noise"]
    net = ck.import_pulse_vae(sd, device="cpu")
    jnet = JaxPulseVAE(**jck.pulse_vae_spec_from_torch(sd), activation="silu")
    want = jnet.apply({"params": jck.import_pulse_vae(sd)}, jnp.asarray(x), jnp.asarray(noise))
    with torch.no_grad():
        got = net(torch.as_tensor(x), torch.as_tensor(noise))
    for k in ("action_mu", "post_mu", "post_logvar", "prior_mu", "prior_logvar", "value"):
        _close(got[k], want[k])


@pytest.mark.parametrize("lateral", [True, False])
def test_import_pnn_matches_jax(built, lateral):
    sd = built["pnn_sd"] if lateral else built["plain_sd"]
    act = "relu" if lateral else "silu"
    net, info = ck.import_pnn(sd, activation=act, device="cpu")
    jparams, jinfo = jck.import_pnn(sd)
    assert info == jinfo and net.has_lateral == lateral
    jnet = JaxPNN(action_dim=ACT, num_primitives=info["num_primitives"], units=info["units"], activation=act,
                  has_lateral=lateral)
    x = built["x"]
    want = jnet.apply({"params": jparams}, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.as_tensor(x))
        if lateral:
            ref = torch.stack(built["ref_pnn"](torch.as_tensor(x)), dim=1)
        else:
            ref = torch.stack([a(torch.as_tensor(x)) for a in built["plain_cols"]], dim=1)
    _close(got, want)
    _close(got, ref)
    if lateral:   # u.{c-1}.{pc}.0 feeds column c's second layer; u.*.1 has no layer to feed
        assert sorted(net.lateral) == ["lat0to1_l1", "lat0to2_l1", "lat1to2_l1"]


@pytest.mark.parametrize("final", ["relu", "softmax"])
def test_import_composer_and_running_stats_match_jax(built, final):
    sd, x = built["comp_sd"], built["x"]
    net = ck.import_mcp_composer(sd, final=final, device="cpu")
    jnet = JaxComposer(num_primitives=3, units=(24,), activation="relu", final=final)
    want = jnet.apply({"params": jck.import_mcp_composer(sd)}, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.as_tensor(x))
        logits = built["comp"](torch.as_tensor(x))
    _close(got, want, 1e-6)
    _close(got, torch.relu(logits) if final == "relu" else torch.softmax(logits, -1), 1e-6)
    rms, jrms = ck.import_running_mean_std(built["sd"], device="cpu"), jck.import_running_mean_std(built["sd"])
    assert rms.mean.dtype == torch.float32 and float(rms.count) == 12345.0
    _close(rms.normalize(torch.as_tensor(x)), jrms.normalize(jnp.asarray(x)), 1e-6)


def test_pnn_mcp_teacher_is_the_composed_clipped_blend(built):
    """make_pnn_mcp_teacher: relu(composer) weights over the PNN columns on
    the normalized obs, clipped to [-1, 1], float32 under an autocast, both
    networks frozen."""
    pnn, _ = ck.import_pnn(built["pnn_sd"], device="cpu")
    comp = ck.import_mcp_composer(built["comp_sd"], final="relu", device="cpu")
    rms = ck.import_running_mean_std(built["sd"], device="cpu").freeze()
    teacher = make_pnn_mcp_teacher(pnn, comp, rms)
    x = torch.as_tensor(built["x"]) * 3.0
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = teacher(x)
    xn = rms.normalize(x)
    with torch.no_grad():
        prims = torch.stack(built["ref_pnn"](xn), dim=1)
        want = torch.clamp((torch.relu(built["comp"](xn))[:, :, None] * prims).sum(1), -1.0, 1.0)
    assert got.dtype == torch.float32
    _close(got, want)
    assert not any(p.requires_grad for p in [*pnn.parameters(), *comp.parameters()])


# --------------------------------------------------------------------------- #
# run.main's import paths
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def pth_files(tmp_path_factory):
    """Reference-layout files at the widths the CLI's envs need: a 2-column
    PNN (934 -> 32-16 -> 69) with laterals and stats, a composer (934 -> 16
    -> 2), and a PulseVAE for speed_z (self obs 358, obs 934)."""
    d = tmp_path_factory.mktemp("pth")
    torch.manual_seed(21)
    ref_pnn = RefTorchPNN(934, (32, 16), 69, 2)
    rms = _rms_sd(934, 3)
    pnn_path = _save(d / "pnn.pth", {**sd_numpy("a2c_network.pnn", ref_pnn), **rms})
    torch.manual_seed(22)
    comp = mlp_seq(934, (16,), act=nn.ReLU, final=2)
    comp_path = _save(d / "composer.pth", sd_numpy("a2c_network.composer", comp))
    both = _save(d / "pnn_composer.pth", {**sd_numpy("a2c_network.pnn", ref_pnn), **rms,
                                          **sd_numpy("a2c_network.composer", comp)})
    vae = _vae_modules(934, 358, 32, 69, units=(64,), prior_units=(32,), seed=23)
    vae_path = _save(d / "pulse.pth", {**_sd(vae), **_rms_sd(934, 4)})
    return dict(pnn=pnn_path, ref_pnn=ref_pnn, rms=rms, composer=comp_path, comp=comp, vae=vae_path,
                vae_mods=vae, both=both)


def _rms_norm(rms, x):
    return torch.clamp((x - torch.as_tensor(rms["running_mean_std.running_mean"]).float())
                       / torch.sqrt(torch.as_tensor(rms["running_mean_std.running_var"]).float() + 1e-5), -5, 5)


def _check_mcp(res, files):
    env = res.agent.env
    assert env.action_dim == 2 and env.pnn.has_lateral and env.pnn_obs_rms.frozen
    obs = env.reset(3).obs
    with torch.no_grad():
        _close(env.primitive_actions(obs), torch.stack(files["ref_pnn"](_rms_norm(files["rms"], obs)), dim=1))
    assert not any(p.requires_grad for p in env.pnn.parameters())


def _check_teacher(res, files):
    assert np.isfinite(res.metrics[0]["bc_loss"])
    obs = res.agent.env.reset(3).obs
    with torch.no_grad():
        x = _rms_norm(files["rms"], obs)
        prims = torch.stack(files["ref_pnn"](x), dim=1)
        want = torch.clamp((torch.relu(files["comp"](x))[:, :, None] * prims).sum(1), -1, 1)
    _close(res.agent.teacher_fn(obs), want)
    assert not any(p.requires_grad for p in res.agent.teacher_fn.composer.parameters())


def _check_z_pth(res, files):
    zenv, m = res.agent.env, files["vae_mods"]
    net = zenv.frozen.network
    assert net.full_precision and net.latent_dim == 32 and [l.out_features for l in net.decoder.trunk
                                                            if isinstance(l, nn.Linear)] == [64]
    st = zenv.env.reset(2)
    z = torch.rand(2, 32, generator=torch.Generator().manual_seed(0)) * 2 - 1
    sd = ck.load_torch_checkpoint(files["vae"])["model"]
    mean, var = sd["running_mean_std.running_mean"][:358].float(), sd["running_mean_std.running_var"][:358].float()
    with torch.no_grad():
        so = torch.clamp((st.obs[:, :358] - mean) / torch.sqrt(var + 1e-5), -5, 5)
        want = m["mu"](m["actor_mlp"](torch.cat([so, m["z_prior_mu"](m["z_prior"](so)) + z], -1)))
        _close(zenv.decode_z(st.obs[:, :358], z), want)


def _check_task(name, obs_dim):
    def check(res, files):
        zenv = res.agent.env
        assert type(zenv.env).__name__ == name and zenv.obs_dim == obs_dim and zenv.action_dim == 32
        assert zenv.env.physics_route == "plain" and np.isfinite(res.metrics[0]["reward_mean"])
    return check


Z_TASK = ["learning=pulse_z_task", "learning.amp_batch_size=8", "learning.amp_buffer_size=64",
          "learning.disc_units=[16]", "learning.actor_units=[16]", "learning.critic_units=[16]"]
DISTILL = ["env=im_vae", "learning=im_z_fit", "learning.encoder_units=[32]", "learning.prior_units=[16]",
           "learning.decoder_units=[32]", "env.num_fall_states=4", "env.fall_settle_steps=2"]
MCP = ["learning.actor_units=[32]", "learning.critic_units=[32]"]
# each option raised NotImplementedError (ROADMAP item 11b) before the
# importers, strike and terrain were ported; now it runs an epoch
CASES = {
    "strike_z": (lambda f: ["env=strike_z", *Z_TASK], _check_task("HumanoidStrikeEnv", 373)),
    "pedestrian_terrain_z": (lambda f: ["env=pedestrian_terrain", "env.task=HumanoidPedestrianTerrainZ", *Z_TASK],
                             _check_task("HumanoidPedestrianTerrainEnv", 634)),
    "z_checkpoint_pth": (lambda f: ["env=speed_z", f"env.z_checkpoint={f['vae']}", *Z_TASK], _check_z_pth),
    "teacher_composer_checkpoint": (lambda f: [*DISTILL, f"learning.teacher_pnn_checkpoint={f['pnn']}",
                                               f"learning.teacher_composer_checkpoint={f['composer']}"],
                                    _check_teacher),
    "im_mcp_pnn_checkpoint": (lambda f: ["env=im_mcp", f"env.pnn_checkpoint={f['pnn']}", *MCP], _check_mcp),
    "im_mcp_getup_pnn_checkpoint": (lambda f: ["env=im_mcp_getup", f"env.pnn_checkpoint={f['pnn']}",
                                               "env.num_fall_states=4", "env.fall_settle_steps=2", *MCP], _check_mcp),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_runs_the_options_that_raised(case, pth_files, tmp_path):
    args, check = CASES[case]
    res = run.main([*args(pth_files), "max_epochs=1", f"output_dir={tmp_path}", *TINY])
    check(res, pth_files)


def test_distill_pnn_teacher_from_one_pth(pth_files, tmp_path):
    """Without teacher_composer_checkpoint the composer comes from the PNN's
    own file, as in the JAX package."""
    res = run.main([*DISTILL, f"learning.teacher_pnn_checkpoint={pth_files['both']}", "max_epochs=1",
                    f"output_dir={tmp_path}", *TINY])
    _check_teacher(res, pth_files)
