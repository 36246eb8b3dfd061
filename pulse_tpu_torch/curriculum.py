"""PHC progressive curriculum on the hard synthetic suite (or the graded one).

The port's arm of the JAX package's `tools/curriculum.py`, with the same
flags, defaults, stages and report keys:

  1. column 0: PPO imitation on every clip (ActorCritic 2048-1536-1024,
     minibatch 16384, 6 mini-epochs, lr 2e-5);
  2. im_eval -> the failed set; column k+1 starts from column k's weights
     (the reference's forward_pmcp) with a fresh Adam and trains on the
     clips every column so far fails (hard-negative PMCP: the motion
     store's `sampling_prob`, which the env's resets draw from, collapses
     onto them), re-evaluating every 500 epochs, re-weighting onto what
     still fails and stopping early once nothing does;
  3. specialists (`--specialist_epochs`): one column per clip that no
     column passes, one-hot PMCP, warm-started from column 0 or, on the
     graded suite, from the column that owns the easier rung; with
     `--sharp_curriculum` the sharp_turns specialist climbs the graded turn
     ladder instead (60% of resets on the current level, 40% over the
     levels below, advancing when the current level passes);
  4. `--amp_getup_epochs`: an AMP column on HumanoidImGetupEnv from column
     0, style reward alone and every reset a fall state until a third of
     its epochs, then 0.5 task / 0.5 style;
  5. the composer: a frozen PNN of every column (each with the input
     normalizer it trained under, `column_inputs`), a 512-256 policy over
     composer weights on HumanoidImMCPGetupEnv (fall and recovery episodes
     0.3 each) or HumanoidImMCPEnv, optionally behaviour-cloned first to
     the oracle routing (each clip's best column), then PPO with its own
     PMCP every 250 epochs; the best gate measured is kept. It is always
     scored on the plain MCP env.

Each stage writes a snapshot under `--out` (`torch.save`: the network's
state dict and its running stats) and a stage whose snapshot exists is
restored, not retrained. `partial.json` is written after every column (the
`amp_getup` column too) and once more at the end with `"status":
"complete"`; the entries of `columns` carry their stage label (`stage`).
`pnn<N>.pt` holds the composer's frozen PNN (parameters named `col{k}_*`,
as `scripts/forward_pmcp.py` reads them). `curriculum.json` holds every key
of the JAX tool's report, and adds the device (`port`), nvidia-smi's name
and power limit (`gpu`) and a record of each stage (`stages`: its label,
kind, whether it was restored, epochs trained, seconds and whether every
loss was finite).

    python -m pulse_tpu_torch.curriculum [--epochs 1500] [--hard_epochs 1500]
        [--composer_epochs 1000] [--max_columns 3] [--specialist_epochs 0]
        [--envs 2048] [--horizon 32] [--seed 0] [--pallas on|off]
        [--minibatch 16384] [--suite hard|graded] [--max_specialists 8]
        [--sharp_curriculum] [--amp_getup_epochs 0] [--composer_env getup|im]
        [--gate_temp 4.0] [--gate_pretrain_rounds 150] [--spec_eval_every 500]
        [--out output/curriculum]

It runs on the card. Beyond the JAX tool's flags: `--device cpu`, with
`--units` for a narrow network and `--num_fall_states` /
`--fall_settle_steps` for a small fall-state bank, is for the CPU test;
`--ladder_eval_every` is the turn ladder's eval cadence (the JAX tool's
fixed 300); `--stop_after STAGE` ends the run after that stage's snapshot
(a run longer than one process resumes from the snapshots).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import numpy as np
import torch

from pulse_tpu_torch._device import resolve_device
from pulse_tpu_torch.assets import load_smpl_humanoid
from pulse_tpu_torch.bench_quality import gpu_line
from pulse_tpu_torch.env.humanoid_im import EnvConfig, HumanoidImEnv
from pulse_tpu_torch.env.humanoid_im_getup import GetupConfig, HumanoidImGetupEnv
from pulse_tpu_torch.env.humanoid_im_mcp import HumanoidImMCPEnv, HumanoidImMCPGetupEnv
from pulse_tpu_torch.eval.im_eval import im_eval
from pulse_tpu_torch.learning.amp import AMPConfig
from pulse_tpu_torch.learning.amp_agent import AMPAgent
from pulse_tpu_torch.learning.networks import ActorCritic
from pulse_tpu_torch.learning.pnn import pnn_from_jax
from pulse_tpu_torch.learning.ppo import PPOAgent, PPOConfig
from pulse_tpu_torch.learning.running_norm import RunningMeanStd
from pulse_tpu_torch.motion.motion_lib import build_motion_data, update_hard_sampling_weight
from pulse_tpu_torch.motion.synthetic import make_graded_suite, make_hard_clips
from pulse_tpu_torch.physics.model import PhysicsConfig, build_model
from pulse_tpu_torch.run import DeterministicPolicy

COLUMN_EVAL_EVERY = 500     # a hard column's in-training eval cadence (the tool's run_stage default)
COMPOSER_EVAL_EVERY = 250   # the composer's PMCP cadence
COMPOSER_UNITS = (512, 256)
GATE_HORIZON = 32           # steps a gate-pretrain round collects
GATE_LR = 1e-3
LOG_EVERY = 100


def pnn_params_from_actors(actor_states: list, n_units: int) -> dict:
    """Frozen PNN column parameters from ActorCritic state dicts: the actor
    trunk's Linear li and the mu head of column c as `col{c}_dense{li}` and
    `col{c}_out`, each {"kernel": [in, out], "bias": [out]} (the flax PNN's
    layout, no laterals), as CPU tensors."""
    def dense(sd, name):
        return {"kernel": sd[f"{name}.weight"].detach().t().contiguous().cpu(),
                "bias": sd[f"{name}.bias"].detach().clone().cpu()}

    out = {}
    for c, sd in enumerate(actor_states):
        for li in range(n_units):
            out[f"col{c}_dense{li}"] = dense(sd, f"actor.{2 * li}")
        out[f"col{c}_out"] = dense(sd, "mu")
    return out


def ladder_prob(level: int, num_levels: int) -> np.ndarray:
    """The turn ladder's sampling weights: 0.6 on the current level and 0.4
    spread over it and the levels below, 1e-6 above, normalized."""
    p = np.full(num_levels, 1e-6)
    p[: level + 1] = 0.4 / (level + 1)
    p[level] += 0.6
    return p / p.sum()


def ladder_level(level: int, passed) -> int:
    """The hardest contiguous level reached from `level`: advance while the
    current level passes, never retreat."""
    while level < len(passed) - 1 and passed[level]:
        level += 1
    return level


def specialist_order(union_failed, families=None) -> list:
    """The clip ids no column passes, in the order specialists train: by id,
    or on the graded suite by (family, level) so that each rung can
    warm-start from the previous one's owner."""
    ids = [int(i) for i in np.flatnonzero(union_failed)]
    if families is not None:
        rank = {i: (f, k) for f, idx in families.items() for k, i in enumerate(idx)}
        ids.sort(key=lambda i: rank[i])
    return ids


def union_success(failed_masks) -> int:
    """Clips that at least one column passes."""
    fails = np.stack([np.asarray(f, bool) for f in failed_masks])
    return int(fails.shape[1] - np.logical_and.reduce(fails).sum())


def final_index(evals) -> int:
    """The best single column: fewest failed clips, then the lowest
    MPJPE-pa; the first such one."""
    return min(range(len(evals)), key=lambda i: (int(np.asarray(evals[i].failed_motions).sum()), evals[i].mpjpe_pa))


def _host_rms(rms):
    return RunningMeanStd(mean=rms.mean.detach().cpu().clone(), var=rms.var.detach().cpu().clone(),
                          count=rms.count.detach().cpu().clone())


def _rms_on(rms, device):
    return RunningMeanStd(mean=rms.mean.to(device), var=rms.var.to(device), count=rms.count.to(device))


def _host_state(net) -> dict:
    return {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}


class _Stop(Exception):
    """`--stop_after` reached."""


class Curriculum:
    """The tool's stages over one model, suite and motion store. `stages`
    records each stage as it ends; `_stage` runs one (a hook for a caller
    that measures stage by stage)."""

    def __init__(self, args):
        self.args = a = args
        self.device = dev = resolve_device(args.device)
        self.sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        self.spec = load_smpl_humanoid()
        self.model = build_model(self.spec, PhysicsConfig(), device=dev)
        if a.suite == "graded":
            clips, self.names, self.families = make_graded_suite(self.spec.skeleton)
            self.suite_label = "graded_v1"
        else:
            clips, self.names = make_hard_clips(self.spec.skeleton)
            self.families = None
            self.suite_label = "hard_synthetic_v2"
        self.motion = build_motion_data(self.spec.skeleton, clips, device=dev)
        self.M = len(self.names)
        self.env = HumanoidImEnv(self.model, self.motion, EnvConfig(use_pallas_physics=(a.pallas == "on")),
                                 device=dev, seed=a.seed)
        self.eval_env = self.env.with_config(dataclasses.replace(self.env.config, enable_early_termination=False))
        self.units = tuple(int(u) for u in a.units.split(","))
        self.net = self._actor_critic(self.env.obs_dim, self.env.action_dim, self.units, a.seed)
        self.eval_net = self._actor_critic(self.env.obs_dim, self.env.action_dim, self.units, a.seed)
        self.ppo_config = PPOConfig(num_envs=a.envs, horizon_length=a.horizon, minibatch_size=a.minibatch,
                                    mini_epochs=6, learning_rate=2e-5)
        self.agent = PPOAgent(self.env, self.ppo_config, self.net, seed=a.seed + 1)
        self.steps_per_epoch = a.envs * a.horizon
        self._ts = None          # the column train state, made when a stage first trains
        self._rms = None         # the policy's stats before then
        self.col_actors, self.col_rms, self.col_evals, self.col_stages = [], [], [], []
        self.spec_names, self.stages = [], []
        self.composer_result = self.amp_getup_eval = None
        self._finite = True

    def _actor_critic(self, obs_dim, action_dim, units, seed):
        return ActorCritic(obs_dim, action_dim, actor_units=units, critic_units=units, device=self.device, seed=seed)

    # ------------------------------------------------------------------ #

    def _stage(self, label: str, kind: str, body):
        """Run one stage's `body() -> (restored, epochs trained, extra record
        fields)` and record it; after `--stop_after` it ends the run."""
        self._finite = True
        self.sync()
        t0 = time.time()
        restored, epochs, extra = body()
        self.sync()
        self.stages.append({"stage": label, "kind": kind, "restored": bool(restored), "epochs": int(epochs),
                            "seconds": round(time.time() - t0, 3), "finite_losses": self._finite, **extra})
        if self.args.stop_after == label:
            raise _Stop(label)

    def _note(self, metrics) -> None:
        self._finite &= all(math.isfinite(float(v)) for k, v in metrics.items() if k.endswith("loss"))

    def _set_prob(self, prob) -> None:
        """The live PMCP weights every env on this store resets from (the
        JAX tool's train-state `motion_prob`)."""
        prob = prob if isinstance(prob, torch.Tensor) else torch.as_tensor(np.asarray(prob))
        self.motion.sampling_prob.copy_(prob.to(torch.float32))

    def _hard_prob(self, mask) -> torch.Tensor:
        return update_hard_sampling_weight(self.motion, torch.as_tensor(np.asarray(mask, bool))).sampling_prob

    def _uniform(self) -> None:
        self._set_prob(np.full(self.M, 1.0 / self.M, np.float32))

    def _train_state(self):
        """The column train state (agent.init: the env's reset, a fresh Adam
        and fresh stats), made on first use with any restored stats."""
        if self._ts is None:
            self._ts = self.agent.init()
            if self._rms is not None:
                self._ts.obs_rms = self._rms
        return self._ts

    def _policy_rms(self):
        return self._ts.obs_rms if self._ts is not None else self._rms

    def _set_policy(self, state: dict, rms) -> None:
        """≙ ts.replace(params=..., obs_rms=...)."""
        self.net.load_state_dict(state)
        self._rms = _rms_on(rms, self.device)
        if self._ts is not None:
            self._ts.obs_rms = self._rms

    def _fresh_optimizer(self, ts) -> None:
        ts.optimizer = torch.optim.Adam(ts.network.parameters(), lr=self.ppo_config.learning_rate)
        ts.epoch = 0

    def _save(self, path: str, net, rms) -> None:
        torch.save({"network": _host_state(net), "obs_rms": {k: getattr(rms, k).detach().cpu()
                                                              for k in ("mean", "var", "count")}}, path)

    def _load(self, path: str) -> tuple:
        saved = torch.load(path, map_location="cpu", weights_only=True)
        print(f"[{os.path.basename(path)}] restored snapshot {path}", flush=True)
        return saved["network"], RunningMeanStd(**saved["obs_rms"])

    def _snap(self, name: str) -> str:
        return os.path.join(self.args.out, name)

    # ------------------------------------------------------------------ #

    def eval_policy(self, net, rms, tag: str):
        r = im_eval(self.eval_env, DeterministicPolicy(net, rms), batch_size=self.M)
        per = {n: ("ok" if not r.failed_motions[i] else "FAIL") + f" g={r.per_motion_mpjpe_g[i]:.0f}mm"
               for i, n in enumerate(self.names)}
        print(f"[{tag}] success {int(self.M - r.failed_motions.sum())}/{self.M} pa={r.mpjpe_pa:.1f}mm {per}",
              flush=True)
        return r

    def eval_column(self, state: dict, rms, tag: str):
        """im_eval of a column's host copy (`eval_net` holds it)."""
        self.eval_net.load_state_dict(state)
        return self.eval_policy(self.eval_net, _rms_on(rms, self.device), tag)

    def result_json(self, r, stage: str) -> dict:
        return {
            "success": int(self.M - r.failed_motions.sum()),
            "mpjpe_g_mm": round(r.mpjpe_g, 2),
            "mpjpe_l_mm": round(r.mpjpe_l, 2),
            "mpjpe_pa_mm": round(r.mpjpe_pa, 2),
            "per_clip": {n: {"success": bool(~r.failed_motions[i]),
                             "mpjpe_g_mm": round(float(r.per_motion_mpjpe_g[i]), 2)}
                         for i, n in enumerate(self.names)},
            "stage": stage,
        }

    def dump_partial(self, status: str = "partial") -> None:
        """The stage results so far (`out/partial.json`)."""
        if not self.col_evals:
            return
        partial = {
            "suite": self.suite_label,
            "status": status,
            "columns": [self.result_json(r, s) for r, s in zip(self.col_evals, self.col_stages)],
            "specialists": list(self.spec_names),
            "composer": None if self.composer_result is None else self.result_json(self.composer_result, "composer"),
            "column_union_success": union_success([r.failed_motions for r in self.col_evals]),
        }
        with open(os.path.join(self.args.out, "partial.json"), "w") as fh:
            json.dump(partial, fh, indent=2)

    def _add_column(self, label: str, state: dict, rms, net=None):
        """Keep a column's host copy, evaluate it, write partial.json."""
        self.col_actors.append(state)
        self.col_rms.append(_host_rms(rms))
        r = self.eval_column(state, rms, label) if net is None else self.eval_policy(net, rms, label)
        self.col_evals.append(r)
        self.col_stages.append(label)
        self.dump_partial()
        return r

    # ------------------------------------------------------------------ #

    def run_stage(self, ts, epochs: int, tag: str, hard_mask=None, eval_every: int = COLUMN_EVAL_EVERY):
        """`epochs` of PPO; for a hard column (hard_mask set) the in-training
        eval every `eval_every` epochs re-weights the resets onto the masked
        clips still failing, and the stage stops once none does. Returns
        (ts, epochs trained)."""
        t0 = time.time()
        done = 0
        for epoch in range(epochs):
            ts, metrics = self.agent.train_epoch(ts)
            self._note(metrics)
            done += 1
            if epoch % LOG_EVERY == 0:
                fps = self.steps_per_epoch * (epoch + 1) / (time.time() - t0)
                print(f"[{tag}] epoch={epoch} reward={float(metrics['reward_mean']):.4f} fps={fps:,.0f}", flush=True)
            if hard_mask is not None and epoch > 0 and epoch % eval_every == 0:
                r_mid = self.eval_policy(self.net, ts.obs_rms, f"{tag}@{epoch}")
                still = r_mid.failed_motions & hard_mask
                if not still.any():
                    print(f"[{tag}] all hard clips pass at epoch {epoch} — early stop", flush=True)
                    break
                self._set_prob(self._hard_prob(still))
        self.sync()
        print(f"[{tag}] {done} epochs in {time.time() - t0:.0f}s", flush=True)
        return ts, done

    def columns(self) -> None:
        """Column 0 on every clip, then each next column from the last one's
        weights on what every column so far fails."""
        a = self.args
        failed = np.ones(self.M, bool)
        for col in range(a.max_columns):
            label = f"col{col}"
            snap = self._snap(f"col{col}.pt")
            epochs = a.epochs if col == 0 else a.hard_epochs
            hard_mask = None if col == 0 else failed.copy()

            def body():
                if os.path.exists(snap):
                    self._set_policy(*self._load(snap))
                    restored, n = True, 0
                else:
                    ts = self._train_state()
                    if col > 0:
                        # forward_pmcp: the previous column's weights are the
                        # init, and the resets sample the failed set only
                        self._set_prob(self._hard_prob(failed))
                        self._fresh_optimizer(ts)
                    ts, n = self.run_stage(ts, epochs, label, hard_mask=hard_mask)
                    self._save(snap, self.net, ts.obs_rms)
                    restored = False
                self._add_column(label, _host_state(self.net), self._policy_rms())
                return restored, n, {}

            self._stage(label, "column", body)
            new_failed = self.col_evals[-1].failed_motions.copy()
            # the next column attacks what EVERY column so far still fails
            failed = new_failed if col == 0 else failed & new_failed
            if not failed.any():
                print(f"[col{col}] no remaining failures — stopping columns", flush=True)
                break

    # ------------------------------------------------------------------ #

    def train_sharp_ladder(self, ts):
        """The sharp-turn specialist on the graded turn ladder (heading blend
        0.8 s -> 0.25 s at 1.6 m/s; the hardest level is v2's sharp_turns):
        `ladder_prob` resets, advancing when the current level's im_eval
        passes and stopping when the hardest does. Its own env and store;
        the network is the column's. Returns (the ladder's train state,
        epochs trained, [(epoch, level)] after each eval)."""
        a = self.args
        t_clips, t_names, t_fams = make_graded_suite(self.spec.skeleton)
        ladder_ids = t_fams["turn"]
        ladder = build_motion_data(self.spec.skeleton, [t_clips[j] for j in ladder_ids], device=self.device)
        L = ladder.num_motions
        env_t = HumanoidImEnv(self.model, ladder, self.env.config, device=self.device, seed=a.seed + 5)
        eval_env_t = env_t.with_config(dataclasses.replace(env_t.config, enable_early_termination=False))
        agent_t = PPOAgent(env_t, self.ppo_config, self.net, seed=a.seed + 5)
        tts = agent_t.init()
        tts.obs_rms = ts.obs_rms

        def set_level(level):
            ladder.sampling_prob.copy_(torch.as_tensor(ladder_prob(level, L), dtype=torch.float32))

        def ladder_eval(tag):
            r = im_eval(eval_env_t, DeterministicPolicy(self.net, tts.obs_rms), batch_size=L)
            stat = " ".join(f"{t_names[ladder_ids[j]]}:" + ("ok" if not r.failed_motions[j] else "FAIL")
                            for j in range(L))
            print(f"[{tag}] {stat}", flush=True)
            return r

        level, levels, done = 0, [], 0
        set_level(level)
        t0 = time.time()
        for epoch in range(a.specialist_epochs):
            tts, metrics = agent_t.train_epoch(tts)
            self._note(metrics)
            done += 1
            if epoch % LOG_EVERY == 0:
                print(f"[spec_sharp_ladder] epoch={epoch} level={level} reward={float(metrics['reward_mean']):.4f} "
                      f"fps={self.steps_per_epoch * (epoch + 1) / (time.time() - t0):,.0f}", flush=True)
            if epoch > 0 and epoch % a.ladder_eval_every == 0:
                passed = ~np.asarray(ladder_eval(f"spec_sharp_ladder@{epoch}").failed_motions)
                if passed[L - 1]:
                    print(f"[spec_sharp_ladder] hardest level passes at epoch {epoch} — early stop", flush=True)
                    levels.append((epoch, level))
                    break
                level = ladder_level(level, passed)
                levels.append((epoch, level))
                set_level(level)
        self.sync()
        ladder_eval("spec_sharp_ladder/final")
        return tts, done, levels

    def spec_init_source(self, i: int) -> int:
        """The column to warm-start clip i's specialist from: on the graded
        suite the one with the lowest drift on the next easier rung of i's
        family (preferring one that passes it); column 0 otherwise."""
        if self.families is None:
            return 0
        fam = next(f for f, idx in self.families.items() if i in idx)
        idx = self.families[fam]
        easier = idx[: idx.index(i)]
        if not easier:
            return 0
        j = easier[-1]
        return min(range(len(self.col_evals)),
                   key=lambda c: (bool(np.asarray(self.col_evals[c].failed_motions)[j]),
                                  float(np.asarray(self.col_evals[c].per_motion_mpjpe_g)[j])))

    def specialists(self) -> None:
        """One column per clip that no column passes yet (one-hot PMCP),
        at most `--max_specialists`."""
        a = self.args
        union_failed = np.logical_and.reduce([np.asarray(r.failed_motions) for r in self.col_evals])
        n_spec = 0
        for i in specialist_order(union_failed, self.families):
            if n_spec >= a.max_specialists:
                break
            name = self.names[i]
            # a specialist trained on an easier rung often cracks its
            # neighbours: retest coverage before paying for another stage
            if not all(np.asarray(r.failed_motions)[i] for r in self.col_evals):
                print(f"[spec_{name}] already covered by an earlier column/specialist — skipping", flush=True)
                continue
            n_spec += 1
            use_ladder = a.sharp_curriculum and name == "sharp_turns"
            label = f"spec_{name}{'_ladder' if use_ladder else ''}"
            snap = self._snap(f"{label}.pt")
            mask = np.zeros(self.M, bool)
            mask[i] = True

            def body():
                extra = {}
                if os.path.exists(snap):
                    self._set_policy(*self._load(snap))
                    restored, n = True, 0
                else:
                    src = self.spec_init_source(i)
                    if src:
                        print(f"[spec_{name}] warm-start from column {src} (owns the easier rung)", flush=True)
                    self._set_policy(self.col_actors[src], self.col_rms[src])
                    ts = self._train_state()
                    self._fresh_optimizer(ts)
                    if use_ladder:
                        tts, n, levels = self.train_sharp_ladder(ts)
                        ts.obs_rms = tts.obs_rms
                        extra["ladder_levels"] = levels
                    else:
                        self._set_prob(self._hard_prob(mask))
                        ts, n = self.run_stage(ts, a.specialist_epochs, f"spec_{name}", hard_mask=mask,
                                               eval_every=a.spec_eval_every)
                    self._save(snap, self.net, ts.obs_rms)
                    restored = False
                self._add_column(label, _host_state(self.net), self._policy_rms())
                self.spec_names.append(name)
                return restored, n, extra

            self._stage(label, "specialist", body)

    # ------------------------------------------------------------------ #

    def _getup_config(self, **kw):
        return GetupConfig(**dataclasses.asdict(self.env.config), num_fall_states=self.args.num_fall_states,
                           fall_settle_steps=self.args.fall_settle_steps, **kw)

    def amp_getup(self) -> None:
        """AMPAgent on HumanoidImGetupEnv from column 0: task and style
        weights 0.5 each after the getup schedule of a third of the epochs
        (style alone and fall-state resets before it)."""
        a = self.args
        snap = self._snap("amp_getup.pt")

        def body():
            if os.path.exists(snap):
                state, rms = self._load(snap)
                self._add_column("amp_getup", state, rms)
                return True, 0, {}
            self._uniform()
            getup_env = HumanoidImGetupEnv(self.model, self.motion, self._getup_config(), device=self.device,
                                           seed=a.seed + 11)
            a_net = self._actor_critic(getup_env.obs_dim, getup_env.action_dim, self.units, a.seed + 11)
            a_net.load_state_dict(self.col_actors[0])
            amp_agent = AMPAgent(getup_env, self.ppo_config, AMPConfig(task_reward_w=0.5, disc_reward_w=0.5), a_net,
                                 getup_update_epoch=max(a.amp_getup_epochs // 3, 1), seed=a.seed + 11)
            ats = amp_agent.init()
            ats.ppo.obs_rms = _rms_on(self.col_rms[0], self.device)
            t0 = time.time()
            for epoch in range(a.amp_getup_epochs):
                ats = amp_agent.pre_epoch(ats, epoch)
                ats, metrics = amp_agent.train_epoch(ats)
                self._note(metrics)
                if epoch % LOG_EVERY == 0:
                    print(f"[amp_getup] epoch={epoch} reward={float(metrics['reward_mean']):.4f} "
                          f"task={float(metrics['task_reward_mean']):.4f} "
                          f"disc={float(metrics['disc_reward_mean']):.4f} "
                          f"fps={self.steps_per_epoch * (epoch + 1) / (time.time() - t0):,.0f}", flush=True)
            self.sync()
            self._save(snap, a_net, ats.ppo.obs_rms)
            self._add_column("amp_getup", _host_state(a_net), ats.ppo.obs_rms, net=a_net)
            return False, a.amp_getup_epochs, {}

        self._stage("amp_getup", "amp_getup", body)
        self.amp_getup_eval = self.col_evals[-1]

    # ------------------------------------------------------------------ #

    def composer(self) -> None:
        """A composer policy over the frozen columns."""
        a, dev, M = self.args, self.device, self.M
        n_cols = len(self.col_actors)
        params = pnn_params_from_actors(self.col_actors, len(self.units))
        pnn = pnn_from_jax(params, "silu", column_inputs=True, device=dev)
        # every frozen column keeps the input normalizer it trained under
        frozen_rms = RunningMeanStd(mean=torch.stack([r.mean for r in self.col_rms]).to(dev),
                                    var=torch.stack([r.var for r in self.col_rms]).to(dev),
                                    count=self.col_rms[-1].count.to(dev), frozen=True)
        torch.save({"params": params, "obs_rms": {"mean": frozen_rms.mean.cpu(), "var": frozen_rms.var.cpu(),
                                                  "count": frozen_rms.count.cpu()},
                    "activation": "silu", "column_inputs": True}, self._snap(f"pnn{n_cols}.pt"))
        mcp_kw = dict(pnn=pnn, obs_rms=frozen_rms, gate_temp=a.gate_temp)
        # scoring is always on the plain MCP env (a deterministic clip sweep,
        # no fall inits), comparable across --composer_env and to the columns
        mcp_eval_env = HumanoidImMCPEnv(self.model, self.motion,
                                        dataclasses.replace(self.env.config, enable_early_termination=False),
                                        device=dev, seed=a.seed, **mcp_kw)
        comp_net = self._actor_critic(mcp_eval_env.obs_dim, n_cols, COMPOSER_UNITS, a.seed + 1)
        passable = ~np.logical_and.reduce([np.asarray(r.failed_motions) for r in self.col_evals])

        def eval_composer(rms, tag):
            r = im_eval(mcp_eval_env, DeterministicPolicy(comp_net, rms), batch_size=M)
            print(f"[{tag}] success {int(M - r.failed_motions.sum())}/{M} pa={r.mpjpe_pa:.1f}mm", flush=True)
            return r

        def gate_pretrain(cts):
            """BC of the gate to the oracle routing (each clip's best column,
            near-one-hot logits 2 onehot - 1) on states the oracle visits."""
            fails = np.stack([np.asarray(r.failed_motions) for r in self.col_evals])
            drift = np.stack([np.asarray(r.per_motion_mpjpe_g) for r in self.col_evals])
            best_col = np.argmin(drift + 1e9 * fails, axis=0)
            print("[gate_pretrain] oracle routing: "
                  + ", ".join(f"{self.names[i]}->col{best_col[i]}" for i in range(M)), flush=True)
            target_table = torch.as_tensor(2.0 * np.eye(n_cols)[best_col] - 1.0, dtype=torch.float32, device=dev)
            opt = torch.optim.Adam(comp_net.parameters(), lr=GATE_LR)
            states = mcp_eval_env.reset(a.envs)
            rms = cts.obs_rms
            t0 = time.time()
            for i in range(a.gate_pretrain_rounds):
                obs, tgt = [], []
                with torch.no_grad():
                    for _ in range(GATE_HORIZON):
                        act = target_table[states.motion_id]
                        obs.append(states.obs)
                        tgt.append(act)
                        states = mcp_eval_env.step(states, act)
                obs, tgt = torch.cat(obs), torch.cat(tgt)
                rms = rms.update(obs)
                opt.zero_grad(set_to_none=True)
                loss = torch.mean((comp_net.mean_action(rms.normalize(obs)) - tgt) ** 2)
                loss.backward()
                opt.step()
                self._note({"bc_loss": loss.detach()})
                if i % 25 == 0 or i == a.gate_pretrain_rounds - 1:
                    print(f"[gate_pretrain] round={i} bc_loss={float(loss.detach()):.4f} ({time.time() - t0:.0f}s)",
                          flush=True)
            cts.obs_rms = rms
            return cts

        comp_v = "v4" if a.composer_env == "getup" else "v4im"
        snap = self._snap(f"composer{n_cols}{comp_v}.pt")

        def body():
            if os.path.exists(snap):
                state, rms = self._load(snap)
                comp_net.load_state_dict(state)
                self.composer_result = eval_composer(_rms_on(rms, dev), "composer")
                return True, 0, {}
            self._uniform()
            if a.composer_env == "getup":
                # fall and recovery states in the composer's training
                # distribution, so that it learns when to hand control to
                # its getup column
                mcp_env = HumanoidImMCPGetupEnv(self.model, self.motion,
                                                self._getup_config(fall_init_prob=0.3, recovery_episode_prob=0.3),
                                                device=dev, seed=a.seed + 1, **mcp_kw)
            else:
                mcp_env = HumanoidImMCPEnv(self.model, self.motion, self.env.config, device=dev, seed=a.seed + 1,
                                           **mcp_kw)
            comp_agent = PPOAgent(mcp_env, self.ppo_config, comp_net, seed=a.seed + 1)
            cts = comp_agent.init()
            # keep the best-by-eval gate across pretrain, mid and end: the PPO
            # fine-tune starts from a fresh value head and can degrade it
            best = {"key": None}

            def consider(r, rms):
                key = (int(np.asarray(r.failed_motions).sum()), float(r.mpjpe_pa))
                if best["key"] is None or key < best["key"]:
                    best.update(key=key, state=_host_state(comp_net), rms=_host_rms(rms))

            skip_ppo = False
            if a.gate_pretrain_rounds > 0:
                cts = gate_pretrain(cts)
                r0 = eval_composer(cts.obs_rms, "composer/pretrained")
                consider(r0, cts.obs_rms)
                skip_ppo = not (np.asarray(r0.failed_motions) & passable).any()
                if skip_ppo:
                    print("[composer] pretrained gate reaches the column union — skipping PPO fine-tune", flush=True)
            t0 = time.time()
            done = 0
            for epoch in range(0 if skip_ppo else a.composer_epochs):
                cts, metrics = comp_agent.train_epoch(cts)
                self._note(metrics)
                done += 1
                if epoch % LOG_EVERY == 0:
                    fps = self.steps_per_epoch * (epoch + 1) / (time.time() - t0)
                    print(f"[composer] epoch={epoch} reward={float(metrics['reward_mean']):.4f} fps={fps:,.0f}",
                          flush=True)
                # the composer's PMCP: concentrate on clips where the blend
                # still fails one that some column solves
                if epoch > 0 and epoch % COMPOSER_EVAL_EVERY == 0:
                    r_mid = eval_composer(cts.obs_rms, f"composer@{epoch}")
                    consider(r_mid, cts.obs_rms)
                    gap = np.asarray(r_mid.failed_motions) & passable
                    if not gap.any():
                        print(f"[composer] reaches the column union at epoch {epoch} — early stop", flush=True)
                        break
                    # 50/50 hard/uniform: the composer must keep every clip working
                    self._set_prob(0.5 * self._hard_prob(gap).cpu().numpy() + 0.5 / M)
            if not skip_ppo and a.composer_epochs > 0:
                consider(eval_composer(cts.obs_rms, "composer/end"), cts.obs_rms)
            if best["key"] is not None:
                comp_net.load_state_dict(best["state"])
                cts.obs_rms = _rms_on(best["rms"], dev)
                print(f"[composer] shipping best measured gate: {M - best['key'][0]}/{M} pa={best['key'][1]:.1f}mm",
                      flush=True)
            self.sync()
            self._save(snap, comp_net, cts.obs_rms)
            self.composer_result = eval_composer(cts.obs_rms, "composer")
            return False, done, {"gate_pretrain_rounds": a.gate_pretrain_rounds, "ppo_skipped": skip_ppo}

        self._stage("composer", "composer", body)

    # ------------------------------------------------------------------ #

    def report(self) -> dict:
        a = self.args
        evals = self.col_evals
        if self.composer_result is not None:
            final = self.result_json(self.composer_result, "composer")
        else:
            k = final_index(evals)
            final = self.result_json(evals[k], self.col_stages[k])
        out = {
            "suite": self.suite_label,
            "pallas": a.pallas,
            "envs": a.envs,
            "seed": a.seed,
            "epochs": {"col0": a.epochs, "hard": a.hard_epochs, "composer": a.composer_epochs,
                       "amp_getup": a.amp_getup_epochs},
            "composer_env": a.composer_env,
            "sharp_curriculum": bool(a.sharp_curriculum),
            "specialists": list(self.spec_names),
            "amp_getup": None if self.amp_getup_eval is None else self.result_json(self.amp_getup_eval, "amp_getup"),
            "columns": [self.result_json(r, s) for r, s in zip(evals, self.col_stages)],
            "composer": None if self.composer_result is None else self.result_json(self.composer_result, "composer"),
            # the best single final artifact: the composed policy when
            # trained, else the best column (not the last entry)
            "final": final,
            # what the composer has to reach
            "column_union_success": union_success([r.failed_motions for r in evals]),
            "port": self.device.type,
            "gpu": gpu_line() if self.device.type == "cuda" else None,
            "stages": self.stages,
        }
        if self.families is not None:
            fr = out["final"]["per_clip"]
            out["per_family"] = {
                fam: {"passed": sum(fr[self.names[i]]["success"] for i in idx),
                      "levels": {self.names[i]: fr[self.names[i]]["success"] for i in idx}}
                for fam, idx in self.families.items()
            }
        return out

    def run(self) -> dict:
        a = self.args
        try:
            self.columns()
            if a.specialist_epochs > 0:
                self.specialists()
            if a.amp_getup_epochs > 0:
                self.amp_getup()
            if len(self.col_actors) > 1 and a.composer_epochs > 0:
                self.composer()
        except _Stop as stop:
            print(f"[curriculum] stopped after {stop}", flush=True)
            self.dump_partial()
            return {"stopped_after": str(stop), "stages": self.stages}
        self.dump_partial("complete")
        out = self.report()
        print(json.dumps(out, indent=2))
        with open(os.path.join(a.out, "curriculum.json"), "w") as fh:
            json.dump(out, fh, indent=2)
        return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=1500, help="primitive-0 epochs")
    ap.add_argument("--hard_epochs", type=int, default=1500, help="per hard column")
    ap.add_argument("--composer_epochs", type=int, default=1000)
    ap.add_argument("--max_columns", type=int, default=3)
    ap.add_argument("--specialist_epochs", type=int, default=0,
                    help="if >0: after the shared columns, one column per clip no column passes yet")
    ap.add_argument("--envs", type=int, default=2048)
    ap.add_argument("--horizon", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pallas", choices=["on", "off"], default="on",
                    help="on: the hand-written kernels (use_pallas_physics); off: their plain versions")
    ap.add_argument("--minibatch", type=int, default=16384, help="reference default; lower only for CPU smokes")
    ap.add_argument("--suite", choices=["hard", "graded"], default="hard",
                    help="hard: the 6-clip v2 stress set; graded: the 30-clip family benchmark")
    ap.add_argument("--max_specialists", type=int, default=8, help="cap on one-hot specialist columns")
    ap.add_argument("--sharp_curriculum", action="store_true",
                    help="train the sharp_turns specialist on the graded turn ladder (hard suite only)")
    ap.add_argument("--amp_getup_epochs", type=int, default=0,
                    help="if >0: a getup/AMP column on HumanoidImGetupEnv")
    ap.add_argument("--composer_env", choices=["getup", "im"], default="getup",
                    help="composer training env; its eval is always on the plain im MCP env")
    ap.add_argument("--gate_temp", type=float, default=4.0, help="composer gate softmax temperature")
    ap.add_argument("--gate_pretrain_rounds", type=int, default=150,
                    help="if >0: behaviour-clone the gate to the oracle routing before PPO")
    ap.add_argument("--spec_eval_every", type=int, default=500, help="specialist in-training eval cadence")
    ap.add_argument("--out", default="output/curriculum")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--units", default="2048,1536,1024", help="the columns' actor and critic hidden widths")
    ap.add_argument("--num_fall_states", type=int, default=256, help="the getup envs' fall-state bank")
    ap.add_argument("--fall_settle_steps", type=int, default=60, help="its settle's control steps")
    ap.add_argument("--ladder_eval_every", type=int, default=300, help="the turn ladder's eval cadence")
    ap.add_argument("--stop_after", default="", help="end the run after this stage (e.g. col0, amp_getup)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    return Curriculum(args).run()


if __name__ == "__main__":
    main()
