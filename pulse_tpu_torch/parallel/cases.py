"""The data-parallel updates on given states and rollouts, one rank's part.

`dryrun --cases <file>` runs `run_cases` on every rank: the file (written
with `torch.save`) holds {"cases": [case, ...]}, each case a dict with a
`kind` and the global inputs; a rank takes its contiguous shard of the env
axis and returns what the update left, so that a caller can hold the ranks
to each other and to a single-process reference.

  ppo      config (PPOConfig), state (TrainState, env_state None), rollout
           (Rollout [T, B]), advantages, returns, seed: `PPOAgent.update`
           under the mesh (`_update_dp`), or a recurrent network's
           `update_rnn`, for which the single-process `update_rnn` on the
           whole rollout from a copy of the state runs beside it ("plain")
  distill  config (DistillConfig), state (DistillState), rollout
           (DistillRollout [T, B]), seed: `DistillAgent.update` (`_update_dp`)
  amp      env (tiny_env's keywords), config (AMPConfig), T, B, data_seed,
           seed: the global rollout [T, B, S·A] drawn from data_seed, then
           `AMPModule.update` (`_update_dp`) from a fresh `init`; with the
           fresh demos the update drew and, for a config without dropout,
           the single-process step on the ranks' batches joined ("plain")
  im_eval  env, batch_size, policy_seed, plain_rank: `im_eval` of a fixed
           linear policy split over the mesh, and on rank plain_rank
           unsplit ("plain")

A ValueError of an update is returned as {"error": its message}.
"""

from __future__ import annotations

import copy
import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from pulse_tpu_torch.parallel import mesh as pm


def tiny_env(device, clips: int = 3, seconds: float = 0.25, early_termination: bool = False):
    """A HumanoidImEnv of `clips` synthetic clips under one substep a
    control step."""
    from pulse_tpu_torch.assets import load_smpl_humanoid
    from pulse_tpu_torch.env.humanoid_im import EnvConfig, HumanoidImEnv
    from pulse_tpu_torch.motion.motion_lib import build_motion_data
    from pulse_tpu_torch.motion.synthetic import make_synthetic_clips
    from pulse_tpu_torch.physics.model import PhysicsConfig, build_model

    spec = load_smpl_humanoid()
    model = build_model(spec, PhysicsConfig(substeps=1, control_freq_inv=1), device=device)
    motion = build_motion_data(spec.skeleton, make_synthetic_clips(spec.skeleton, num_clips=clips, seconds=seconds),
                               device=device)
    return HumanoidImEnv(model, motion, EnvConfig(enable_early_termination=early_termination), device=device)


def _stub_env(mesh, obs_dim: int, action_dim: int):
    return SimpleNamespace(device=mesh.device, obs_dim=obs_dim, action_dim=action_dim, mesh=mesh)


def _rms(r) -> dict:
    return {"mean": r.mean.clone(), "var": r.var.clone(), "count": r.count.clone()}


def _params(net) -> list:
    return [p.detach().clone() for p in net.parameters()]


def _shard(mesh, tree):
    """This rank's envs of [T, B, ...] tensors (dim 1)."""
    if isinstance(tree, torch.Tensor):
        k = tree.shape[1] // mesh.size
        return tree[:, mesh.rank * k:(mesh.rank + 1) * k].contiguous()
    if isinstance(tree, tuple):
        return tuple(_shard(mesh, t) for t in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _shard(mesh, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


def _ppo(mesh, case) -> dict:
    from pulse_tpu_torch.learning.ppo import PPOAgent

    ts0 = case["state"]
    net = ts0.network
    obs_dim = case["rollout"].obs.shape[-1]
    action_dim = case["rollout"].actions.shape[-1]
    agent = PPOAgent(_stub_env(mesh, obs_dim, action_dim), case["config"], net, seed=case["seed"])
    plain_ts = copy.deepcopy(ts0) if agent.recurrent else None
    roll, adv, ret = _shard(mesh, (case["rollout"], case["advantages"], case["returns"]))
    try:
        ts, metrics = agent.update(ts0, roll, adv, ret)
    except ValueError as e:
        return {"error": str(e)}
    out = {"params": _params(ts.network), "obs_rms": _rms(ts.obs_rms), "value_rms": _rms(ts.value_rms),
           "metrics": {k: float(v) for k, v in metrics.items()}, "epoch": ts.epoch}
    if agent.recurrent:
        plain = PPOAgent(_stub_env(mesh, obs_dim, action_dim), case["config"], plain_ts.network, seed=case["seed"])
        plain.env.mesh = None
        pts, pm_ = plain.update(plain_ts, case["rollout"], case["advantages"], case["returns"])
        out["plain"] = {"params": _params(pts.network), "obs_rms": _rms(pts.obs_rms),
                        "value_rms": _rms(pts.value_rms), "metrics": {k: float(v) for k, v in pm_.items()}}
    return out


def _distill(mesh, case) -> dict:
    from pulse_tpu_torch.learning.distill import DistillAgent

    ds = case["state"]
    roll = case["rollout"]
    env = _stub_env(mesh, roll.obs.shape[-1], roll.gt_action.shape[-1])
    agent = DistillAgent(env, None, case["config"], ds.network, seed=case["seed"])
    try:
        ds, metrics = agent.update(ds, _shard(mesh, roll))
    except ValueError as e:
        return {"error": str(e)}
    return {"params": _params(ds.network), "obs_rms": _rms(ds.obs_rms),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _amp(mesh, case, env) -> dict:
    from pulse_tpu_torch.learning.amp import AMPModule

    cfg = case["config"]
    T, B = case["T"], case["B"]
    rollout = torch.tensor(np.random.default_rng(case["data_seed"]).standard_normal((T, B, env.amp_obs_dim)),
                           dtype=torch.float32, device=mesh.device)
    module = AMPModule(env, cfg, seed=case["seed"])
    state = module.init()
    g0 = module.generator.get_state()
    pm.use_mesh(env, mesh)
    try:
        state, metrics = module.update(state, _shard(mesh, rollout))
    finally:
        pm.use_mesh(env, None)
    # the fresh demos are the update's first draw from the replicated generator
    g_after = module.generator.get_state()
    module.generator.set_state(g0)
    demo_new = module.fetch_demo(cfg.amp_batch_size)
    module.generator.set_state(g_after)
    out = {"rollout": rollout, "demo_new": demo_new, "amp_rms": _rms(state.amp_rms),
           "demo_buffer": (state.demo_buffer.data.clone(), state.demo_buffer.head, state.demo_buffer.size),
           "replay_buffer": (state.replay_buffer.data.clone(), state.replay_buffer.head, state.replay_buffer.size),
           "params": _params(state.disc), "metrics": {k: float(v) for k, v in metrics.items()}}
    if not cfg.amp_dropout:
        out["plain"] = _amp_plain(env, case, rollout, mesh.size)
    return out


def _amp_plain(env, case, rollout: torch.Tensor, D: int) -> dict:
    """The single-process discriminator step that D ranks' `_update_dp`
    on the first update (replay empty, no dropout) should equal: from a
    fresh state of the same seed, the replicated draws replayed in the DP
    update's order, the demo batch whole, each rank's nl = n / D agent rows
    indexed from its own envs and joined in rank order, `amp_rms` from the
    whole rollout and the fresh demos, one loss on the joined batch."""
    from pulse_tpu_torch.learning.amp import AMPModule

    cfg = case["config"]
    n = cfg.amp_batch_size
    nl = n // D
    ref = AMPModule(env, cfg, seed=case["seed"])
    state = ref.init()
    g = ref.generator
    demo_new = ref.fetch_demo(n)
    state.demo_buffer.push(demo_new)
    demo_obs = state.demo_buffer.sample(g, n)
    state.replay_buffer.sample(g, n)    # drawn as the DP update draws it; the replay is empty
    T, B, dim = rollout.shape
    k = B // D
    idx = torch.randint(0, T * k, (nl,), generator=g, device=rollout.device)
    agent = torch.cat([rollout[:, r * k:(r + 1) * k].reshape(-1, dim)[idx] for r in range(D)])
    rows = torch.cat([rollout.reshape(-1, dim), demo_new])
    rms = state.amp_rms.update(rows)
    total, metrics = ref._disc_loss(state.disc, agent, demo_obs, rms)
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
    state.optimizer.step()
    return {"params": _params(state.disc), "amp_rms": _rms(rms),
            "metrics": {key: float(v) for key, v in metrics.items()}}


def _im_eval(mesh, case, env) -> dict:
    from pulse_tpu_torch.eval.im_eval import im_eval

    g = torch.Generator(device=mesh.device).manual_seed(case["policy_seed"])
    w = 0.05 * torch.randn(env.obs_dim, env.action_dim, generator=g, device=mesh.device)

    def policy(obs):
        return torch.tanh(obs @ w)

    def fields(r) -> dict:
        return {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in vars(r).items()}

    split = fields(im_eval(env, policy, batch_size=case["batch_size"], mesh=mesh))
    if mesh.rank == case["plain_rank"]:
        split["plain"] = fields(im_eval(env, policy, batch_size=case["batch_size"]))
    return split


def run_cases(mesh, inputs: dict) -> list:
    """Each case's outputs on this rank, in order."""
    envs = {}

    def env_of(case):
        key = tuple(sorted(case["env"].items()))
        if key not in envs:
            envs[key] = tiny_env(mesh.device, **case["env"])
        return envs[key]

    out = []
    for case in inputs["cases"]:
        kind = case["kind"]
        if kind == "ppo":
            out.append(_ppo(mesh, case))
        elif kind == "distill":
            out.append(_distill(mesh, case))
        elif kind == "amp":
            out.append(_amp(mesh, case, env_of(case)))
        elif kind == "im_eval":
            out.append(_im_eval(mesh, case, env_of(case)))
        else:
            raise ValueError(f"unknown case kind {kind!r}")
    return out
