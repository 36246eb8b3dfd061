"""Data-parallel dry run of the port: N ranks, each stepping its own shard of
the envs, built by run's config functions as a training run builds them.

    python -m pulse_tpu_torch.parallel.dryrun --nproc N [--backend nccl|gloo]
        [--device cuda|cpu] [--num_envs E] [--out DIR]

Counterpart of `__graft_entry__.py`'s `dryrun_multichip` and
`_sharded_pallas_check`. The parent builds the kernels (on the card), then
starts N rank processes (`python -m pulse_tpu_torch.parallel.dryrun
--rank r ...`: this module imports only torch and the port) that meet
through a file store in a fresh temporary directory. Each rank, its envs
E / N of `num_envs` global ones:

  amp      one epoch of `env=im learning=im_amp` (PPO on the mixed reward,
           then the discriminator), every update its `_update_dp`
  ppo_one_minibatch
           from the same state and this rank's next rollout, one update of
           one mini-epoch and one minibatch of all rows over the ranks,
           against one process's `update` on the gathered rollout
  distill  one epoch of `env=im_vae learning=im_z_fit` (the PULSE student
           on the fresh 2048-1536-1024 teacher)
  joint    one epoch of `JointAMPDistillAgent` on one rollout of `env=im`
  im_eval  one sharded batch of every clip, each rank its contiguous ids
  k3_shard K3 on this rank's rows of a full batch against K3 on the full
           batch, bit for bit (the plain physics step on the CPU)

After each stage a rank records a digest of every replicated tensor
(parameters, Adam moments, normalizers, demo and replay buffers), its
seconds, its kernel launches (exact on the card: horizon K1 and K2 an AMP
or joint epoch, horizon K3, RA and K2 a distillation epoch, max_steps K1
and max_steps + 1 K2 the eval batch) and the collectives' seconds and
count. The parent fails unless every rank exits 0 and every stage's
digests agree across the ranks, and prints one JSON line of the ranks'
records. On the CPU, give a small `--num_envs` (the configs keep their
widths).

NCCL refuses two ranks on one device: ranks that share a card take gloo.
Nothing switches backend or device by itself.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from pulse_tpu_torch.parallel import mesh as pm

K3_SEED = 5              # the shard check's full batch, drawn alike on every rank
# ppo_one_minibatch's bars, on update_diff's measures: the parameters within
# 2e-5 (one step of the learning rate), the moments and metrics within 1e-5
# and 1e-4 of their scale
ONE_MB_TOL = {"params": 2e-5, "moments": 1e-5, "metrics": 1e-4}
RANK_TIMEOUT_S = 1500
PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# --------------------------------------------------------------------------- #
# records
# --------------------------------------------------------------------------- #

def replicated_digest(obj, skip=("env_state", "hidden")) -> str:
    """sha256 of the bytes of every replicated tensor and number of a train
    state (pm.replicate's walk, rank-local fields skipped)."""
    tensors, scalars = pm.collect_replicated(obj, skip)
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    h.update(repr([getattr(o, n) for o, n in scalars]).encode())
    return h.hexdigest()


def _launches() -> dict:
    from pulse_tpu_torch import _build

    return dict(_build.launches)


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _expect(label: str, got: dict, want: dict, device: torch.device) -> None:
    """Kernel launches are counted on the card only (the CPU runs the plain
    versions)."""
    want = {k: want.get(k, 0) for k in got} if device.type == "cuda" else {k: 0 for k in got}
    if got != want:
        raise RuntimeError(f"{label}: launches {got}, expected {want}")


# --------------------------------------------------------------------------- #
# the stages
# --------------------------------------------------------------------------- #

def build(args: list, device: torch.device):
    """(cfg, env, agent) of a config through run's build_*_from_cfg."""
    from pulse_tpu_torch import run
    from pulse_tpu_torch.utils.config import load_config

    cfg = load_config([*args, f"device={device}"])
    spec, model = run.build_model_from_cfg(cfg, device)
    env = run.build_env_from_cfg(cfg, model, run.build_motion_from_cfg(cfg, spec, device), device)
    return cfg, env, run.build_agent_from_cfg(cfg, env)


def _timed_stage(mesh, label: str, fn) -> dict:
    """Run fn() -> (state, record); the record gains the stage's seconds,
    launches, collectives and the state's digest."""
    _sync(mesh.device)
    before, c0, n0 = _launches(), mesh.collective_s, mesh.collective_calls
    t0 = time.perf_counter()
    state, rec = fn()
    _sync(mesh.device)
    rec.update(stage=label, seconds=time.perf_counter() - t0, launches=_since(before),
               collective_s=mesh.collective_s - c0, collectives=mesh.collective_calls - n0,
               digest=replicated_digest(state) if state is not None else None)
    return rec


def _floats(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def update_diff(net_a, net_b, rms_pairs: list, metrics_a: dict, metrics_b: dict, start: list | None = None) -> dict:
    """How far update a lies from update b: the largest absolute parameter
    difference (and, given the parameters both started from, the L2 norm
    of the difference over that of b's update, `update_rel_l2`); the
    moments' largest difference over their scale (mean: 1 + |mean|; var:
    1 + var + mean², the scale at which E[x²] − m² and var round apart;
    count: 1 + count); the metrics' over 1 + |b's|."""
    pa, pb = [p.detach() for p in net_a.parameters()], [p.detach() for p in net_b.parameters()]
    params = max(float((a - b).abs().max()) for a, b in zip(pa, pb))
    out = {}
    if start is not None:
        num = sum(float(((a - b).double() ** 2).sum()) for a, b in zip(pa, pb))
        den = sum(float(((b - s0).double() ** 2).sum()) for b, s0 in zip(pb, start))
        out["update_rel_l2"] = math.sqrt(num / max(den, 1e-300))
    moments = 0.0
    for ra, rb in rms_pairs:
        scales = {"mean": 1 + rb.mean.abs(), "var": 1 + rb.var + rb.mean ** 2, "count": 1 + rb.count.abs()}
        for f, scale in scales.items():
            moments = max(moments, float(((getattr(ra, f) - getattr(rb, f)).abs() / scale).max()))
    metrics = max(abs(float(metrics_a[k]) - float(metrics_b[k])) / (1 + abs(float(metrics_b[k]))) for k in metrics_b
                  if not k.endswith("_s"))
    return {"params": params, **out, "moments": moments, "metrics": metrics}


def gradient_steps(cfg, horizon: int, mesh) -> int:
    """The minibatch steps of one DP update of cfg (PPO's or distillation's
    minibatching) over horizon steps of this rank's cfg.num_envs / D envs;
    each all-reduces the gradients once."""
    rows = horizon * (cfg.num_envs // mesh.size)
    mb = min(cfg.minibatch_size, rows * mesh.size) // mesh.size
    return cfg.mini_epochs * (rows // mb)


def ppo_one_minibatch(mesh, ppo, ts) -> dict:
    """From copies of ts and one more rollout of this rank's envs: the DP
    update of one mini-epoch and one minibatch of every row of every rank,
    against one process's update on the gathered rollout, advantages and
    returns (the same rows in one minibatch: equal up to the sums' order).
    Returns update_diff's measures; raises beyond ONE_MB_TOL."""
    from types import SimpleNamespace

    from pulse_tpu_torch.learning.ppo import PPOAgent, compute_gae

    ts, roll, last_value = ppo.rollout(ts)
    adv, ret = compute_gae(ppo.config, roll, last_value)
    T, B = roll.rewards.shape
    one = dataclasses.replace(ppo.config, mini_epochs=1, minibatch_size=T * B * mesh.size)
    dp_ts = copy.deepcopy(dataclasses.replace(ts, env_state=None))
    plain_ts = copy.deepcopy(dp_ts)
    dp_ts, dp_m = PPOAgent(ppo.env, one, dp_ts.network, seed=ppo.seed).update(dp_ts, roll, adv, ret)
    no_mesh = SimpleNamespace(device=ppo.device, obs_dim=ppo.env.obs_dim, action_dim=ppo.env.action_dim, mesh=None)
    plain = PPOAgent(no_mesh, one, plain_ts.network, seed=ppo.seed)
    plain_ts, plain_m = plain.update(plain_ts, *pm.gather_env_axis((roll, adv, ret), mesh, dim=1))
    diff = update_diff(dp_ts.network, plain_ts.network,
                       [(dp_ts.obs_rms, plain_ts.obs_rms), (dp_ts.value_rms, plain_ts.value_rms)], dp_m, plain_m)
    bad = {k: v for k, v in diff.items() if not v <= ONE_MB_TOL[k]}
    if bad:
        raise RuntimeError(f"ppo_one_minibatch: DP against the gathered update beyond {ONE_MB_TOL}: {bad}")
    return diff


def k3_shard(mesh, env, num_envs: int) -> dict:
    """K3 on this rank's rows of a full batch (drawn alike on every rank)
    against K3 on the full batch: equal bit for bit."""
    from pulse_tpu_torch.physics.substep_cuda import physics_step_cuda

    dev = mesh.device
    g = torch.Generator(device=dev).manual_seed(K3_SEED)
    ids = torch.randint(0, env.motion.num_motions, (num_envs,), generator=g, device=dev)
    times = torch.rand(num_envs, generator=g, device=dev) * env.motion.motion_lengths[ids]
    with torch.no_grad():
        phys = env.reset_to(ids, times).physics
        pd = env.action_to_pd_target(0.3 * torch.randn(num_envs, env.action_dim, generator=g, device=dev))
        before = _launches()
        full = physics_step_cuda(env.model, phys, pd)
        mine = physics_step_cuda(env.model, pm.shard_env_axis(mesh, phys), pm.shard_env_axis(mesh, pd))
        launches = _since(before)
    rows = pm.shard_env_axis(mesh, full)
    unequal = [f.name for f in dataclasses.fields(mine) if not torch.equal(getattr(mine, f.name),
                                                                           getattr(rows, f.name))]
    if unequal:
        raise RuntimeError(f"k3_shard: the rank's rows differ from the full batch's in {unequal}")
    _expect("k3_shard", launches, {"physics_step": 2}, dev)
    return {"envs": num_envs, "rank_envs": num_envs // mesh.size, "fields_equal": True}


def run_stages(mesh, num_envs: int) -> list:
    """The dry run's stages on this rank; a list of records."""
    from pulse_tpu_torch import run
    from pulse_tpu_torch.eval.im_eval import im_eval
    from pulse_tpu_torch.learning.amp_agent import JointAMPDistillAgent

    dev = mesh.device
    amp_args = ["env=im", "learning=im_amp", f"num_envs={num_envs}"]
    dist_args = ["env=im_vae", "learning=im_z_fit", f"num_envs={num_envs}"]
    records = []

    cfg, env, agent = build(amp_args, dev)
    pm.use_mesh(env, mesh)
    H = int(cfg["learning"]["horizon_length"])
    ts = pm.shard_train_state(mesh, agent.init())

    def amp():
        nonlocal ts
        ts = agent.pre_epoch(ts, 0)
        ts, m = agent.train_epoch(ts)
        return ts, {"metrics": _floats(m), "gradient_steps": gradient_steps(agent.ppo.config, H, mesh) + 1}

    records.append(_timed_stage(mesh, "amp", amp))
    _expect("amp", records[-1]["launches"], {"step_reward_amp": H, "observe": H}, dev)
    records.append(_timed_stage(mesh, "ppo_one_minibatch", lambda: (None, ppo_one_minibatch(mesh, agent.ppo, ts.ppo))))
    _expect("ppo_one_minibatch", records[-1]["launches"], {"step_reward_amp": H, "observe": H}, dev)

    dcfg, denv, dagent = build(dist_args, dev)
    pm.use_mesh(denv, mesh)
    DH = int(dcfg["learning"]["horizon_length"])
    ds = pm.shard_train_state(mesh, dagent.init())

    def distill():
        nonlocal ds
        ds, m = dagent.train_epoch(ds)
        return ds, {"metrics": _floats(m), "gradient_steps": gradient_steps(dagent.config, DH - 1, mesh)}

    records.append(_timed_stage(mesh, "distill", distill))
    _expect("distill", records[-1]["launches"], {"physics_step": DH, "reward_amp": DH, "observe": DH}, dev)

    joint = JointAMPDistillAgent(run.build_agent_from_cfg(cfg, env), run.build_agent_from_cfg(dcfg, env))
    js = pm.shard_train_state(mesh, joint.init())

    def joint_epoch():
        nonlocal js
        js, m = joint.train_epoch(js)
        return js, {"metrics": _floats(m)}

    records.append(_timed_stage(mesh, "joint", joint_epoch))
    _expect("joint", records[-1]["launches"], {"step_reward_amp": H, "observe": H}, dev)

    eval_env = env.with_config(dataclasses.replace(env.config, enable_early_termination=False))
    M = env.motion.num_motions
    batch = -(-M // mesh.size) * mesh.size
    max_steps = math.ceil(float(env.motion.motion_lengths.max()) / env.model.config.control_dt)

    def sharded_eval():
        res = im_eval(eval_env, run.DeterministicPolicy(ts.ppo.network, ts.ppo.obs_rms), batch_size=batch,
                      collect_pa=False, mesh=mesh)
        rec = {"clips": M, "batch": batch, "max_steps": max_steps, "success_rate": res.success_rate,
               "mpjpe_g": res.mpjpe_g, "failed": res.failed_motions.tolist(),
               "per_motion_steps": res.per_motion_steps.tolist()}
        return None, dict(rec, result_digest=hashlib.sha256(json.dumps(rec, sort_keys=True).encode()).hexdigest())

    records.append(_timed_stage(mesh, "im_eval", sharded_eval))
    _expect("im_eval", records[-1]["launches"], {"step_reward_amp": max_steps, "observe": max_steps + 1}, dev)
    records.append(_timed_stage(mesh, "k3_shard", lambda: (None, k3_shard(mesh, env, num_envs))))
    return records


# --------------------------------------------------------------------------- #
# ranks and the parent
# --------------------------------------------------------------------------- #

def _rank_device(device: str, rank: int) -> torch.device:
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def rank_main(a) -> int:
    dev = _rank_device(a.device, a.rank)
    if dev.type == "cpu":   # the ranks share the host's cores
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // a.world))
    pm.init_process_group(a.backend, a.rank, a.world, a.store, device=dev)
    try:
        mesh = pm.make_mesh(dev)
        mesh.timed = True
        if a.cases:
            from pulse_tpu_torch.parallel import cases

            out = cases.run_cases(mesh, torch.load(a.cases, weights_only=False))
            torch.save(out, os.path.join(a.out, f"rank{a.rank}.pt"))
        else:
            records = run_stages(mesh, a.num_envs)
            with open(os.path.join(a.out, f"rank{a.rank}.json"), "w") as fh:
                json.dump({"rank": a.rank, "device": str(dev), "backend": a.backend, "records": records}, fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def start_ranks(nproc: int, backend: str, device: str, out: str, extra: list) -> list:
    """Start nproc rank processes of this module, run from the directory
    that holds this package, that meet in a fresh file store under `out`;
    their Popen handles."""
    out = os.path.abspath(out)
    store = os.path.join(tempfile.mkdtemp(prefix="dp_store_", dir=out), "store")
    return [subprocess.Popen([sys.executable, "-m", "pulse_tpu_torch.parallel.dryrun", "--rank", str(r),
                              "--world", str(nproc), "--store", store, "--backend", backend, "--device", device,
                              "--out", out, *extra], cwd=PACKAGE_PARENT) for r in range(nproc)]


def wait_ranks(procs: list, timeout_s: float = RANK_TIMEOUT_S) -> None:
    """Wait for the ranks; raise, after stopping the others, if one fails
    or they outlast timeout_s."""
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
            elif time.monotonic() > deadline:
                failed = f"the ranks outlasted {timeout_s} s"
            else:
                time.sleep(0.1)
        bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if failed is None and bad:
            failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError(f"data-parallel run failed: {failed}")


def check_ranks(results: list) -> dict:
    """Every stage's digests (and the eval's result) the same on every rank;
    the ranks' records by stage."""
    stages = {}
    for res in results:
        for rec in res["records"]:
            stages.setdefault(rec["stage"], []).append(rec)
    for stage, recs in stages.items():
        for key in ("digest", "result_digest"):
            vals = {r.get(key) for r in recs}
            if len(vals) > 1:
                raise RuntimeError(f"{stage}: the ranks' {key}s differ: {sorted(map(str, vals))}")
    return stages


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="default: nccl on the card, gloo on the CPU")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--num_envs", type=int, default=3072, help="global envs, split over the ranks")
    p.add_argument("--out", default=None, help="where the ranks' records go (default: a temporary directory)")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--store", default=None, help=argparse.SUPPRESS)
    p.add_argument("--cases", default=None, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.rank is not None:
        return rank_main(a)
    backend = a.backend or ("nccl" if a.device == "cuda" else "gloo")
    if a.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu --backend gloo")
        if backend == "nccl" and a.nproc > torch.cuda.device_count():
            raise ValueError(f"NCCL refuses two ranks on one device: {a.nproc} ranks, "
                             f"{torch.cuda.device_count()} cards; pass --backend gloo")
        from pulse_tpu_torch import _build

        _build.load()   # built once here, before the ranks load it
    elif backend == "nccl":
        raise ValueError("NCCL runs on the card; pass --backend gloo with --device cpu")
    out = os.path.abspath(a.out or tempfile.mkdtemp(prefix="dp_dryrun_"))
    os.makedirs(out, exist_ok=True)
    extra = ["--num_envs", str(a.num_envs)]
    t0 = time.perf_counter()
    wait_ranks(start_ranks(a.nproc, backend, a.device, out, extra))
    results = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(a.nproc)]
    stages = check_ranks(results)
    print(json.dumps({"dryrun": "ok", "nproc": a.nproc, "backend": backend, "device": a.device,
                      "num_envs": a.num_envs, "seconds": time.perf_counter() - t0,
                      "stages": {s: [{k: v for k, v in r.items() if k != "digest"} for r in recs]
                                 for s, recs in stages.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
