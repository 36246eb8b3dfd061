#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pulse_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  device   the card, its power limit (the raw nvidia-smi line is printed too)
  build    nvcc of pulse_tpu_torch/csrc/*.cu for sm_90a: seconds, registers
           and spill bytes per kernel from -Xptxas -v
  kernels  K1 (step_reward_amp) and K2 (observe) against their plain PyTorch
           versions at 3072 envs, on states from a reference-state reset of
           synthetic clips plus a few plain physics steps (feet in contact)
  slice    HumanoidImEnv (default EnvConfig/PhysicsConfig, 4 synthetic
           clips, 3072 envs) acting for 32 steps under the 2048-1536-1024
           ActorCritic in bf16 autocast; each kernel must launch exactly 32
           times, obs/reward finite, reward in [0, 1], some auto-reset
  timing   env steps/s with the policy acting and with random actions; each
           kernel's and plain version's ms (CUDA events), bound and launches
Then the kernels' JSON line, the card's nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed check exits non-zero before the
last line. Exits non-zero without CUDA or without the package beside it.
"""

import json
import os
import subprocess
import sys
import time

N_ENVS = 3072
HORIZON = 32
WINDOWS = 4                     # timed windows of HORIZON steps per regime
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12     # fp32 outside the tensor cores, H100 SXM

# Kernel-vs-plain tolerances. K1's physics: those the TPU kernel is held to
# against the XLA step (tests/test_pallas_substep.py); the compliant contact
# flips on float noise, so up to OUTLIER_FRAC of the envs may exceed them.
# Reward 1e-4 and AMP 1e-3 as for the TPU kernels. K2: 1e-3 (same atan2
# heading in kernel and plain version, so only rounding separates them).
K1_TOL = {"root_pos": 2e-4, "root_rot": 2e-4, "joint_rot": 2e-4, "root_vel6": 5e-3, "joint_omega": 5e-3,
          "body_pos": 3e-4, "body_rot": 2e-4, "body_vel": 5e-3, "body_ang_vel": 5e-3, "contact_force": 1.0,
          "reward": 1e-4, "reward_raw": 1e-4, "dist_mean": 3e-4, "dist_max": 3e-4, "amp": 1e-3}
K2_TOL = 1e-3
OUTLIER_FRAC = 0.01


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# --------------------------------------------------------------------------- #
# operation counts, by hand from pulse_tpu_torch/csrc (every add, mul, div,
# min/max, sqrt and transcendental counts 1; loads, stores and negations 0)
# --------------------------------------------------------------------------- #

OPS = {
    "cross": 9, "dot": 5, "v3": 3, "qmul": 28, "qunit": 13, "qrot": 38, "normalize_angle": 5,
    "expmap_to_quat": 21, "quat_to_expmap": 20, "quat_angle": 14, "heading": 39, "zrot": 4,
    "m3_mul": 45, "m3_vec": 15, "m3_add": 9, "inv3": 42, "quat_to_matrix_conj": 30,
}
OPS["qmul_norm"] = OPS["qmul"] + OPS["qunit"]
OPS["tan_norm"] = 2 * OPS["qrot"]
OPS["cross_motion"] = 3 * OPS["cross"] + 3
OPS["cross_force"] = 3 * OPS["cross"] + 3
OPS["motion_to_child"] = 2 * OPS["qrot"] + OPS["cross"] + 3
OPS["force_to_parent"] = 2 * OPS["qrot"] + OPS["cross"] + 3
OPS["mul_inertia"] = 4 * OPS["m3_vec"] + 6
OPS["solve6_sym"] = 2 * OPS["inv3"] + 2 * OPS["m3_mul"] + OPS["m3_add"] + 3 * OPS["m3_vec"] + 6
OPS["inertia_to_parent"] = OPS["quat_to_matrix_conj"] + 8 * OPS["m3_mul"] + 3 * OPS["m3_add"] + 9


def k1_ops_per_env(J: int, P: int, n_sub: int, n_reset: int, n_key: int, amp_v: int) -> int:
    o = OPS
    fk = o["qmul_norm"] + o["qrot"] + 3 + o["motion_to_child"] + 6
    contact = 3 * o["qrot"] + o["cross"] * 2 + 3 * 6 + 6 + 5 + 2 + 3 + 2 + 3 * 3
    torque = o["qmul_norm"] + 2 * o["quat_to_expmap"] + 11 + 3 * 14
    bias = 1 + 3 * o["qrot"] + o["cross"] + 6 + o["mul_inertia"] + o["cross_force"] + 6
    pass2 = (6 + o["inv3"] + 3 + 6 * o["m3_mul"] + 3 * o["m3_add"] + 3 * o["m3_vec"] + o["mul_inertia"] + 12
             + o["inertia_to_parent"] + 3 * o["m3_add"] + o["force_to_parent"] + 6)
    pass3 = o["motion_to_child"] + 6 + 4 * o["m3_vec"] + 12 + 12 + o["qmul_norm"] + o["expmap_to_quat"] + 3
    root = 24 + o["qrot"] + 6 + o["qmul_norm"] + o["expmap_to_quat"] + 3
    substep = ((J - 1) * (fk + o["cross_motion"] + torque + pass2 + pass3) + P * contact + J * bias
               + o["solve6_sym"] + root)
    final_fk = (J - 1) * (o["qmul_norm"] + 2 * o["qrot"] + 3 + 3 + o["cross"] + 3 + 3) + 2 * o["qrot"]
    reward = J * (3 * 9 + o["qmul"] + o["quat_angle"] + 2) + 20
    dist = n_reset * 11
    amp = (o["heading"] + o["zrot"] + o["qmul"] + o["tan_norm"] + 2 * o["qrot"]
           + (J - 1) * (o["quat_to_expmap"] + o["expmap_to_quat"] + o["tan_norm"])
           + n_key * (3 + o["qrot"]) * (2 if amp_v == 2 else 1))
    return (J - 1) * o["expmap_to_quat"] + n_sub * substep + 3 * J + final_fk + reward + dist + amp


def k2_ops_per_env(J: int) -> int:
    o = OPS
    per_body = (3 + o["qrot"] + o["qmul"] + o["tan_norm"] + 2 * o["qrot"] + 4 * 3 + 4 * o["qrot"]
                + 3 * o["qmul"] + o["tan_norm"] + o["qmul"] + o["tan_norm"])
    return o["heading"] + 2 * o["zrot"] + J * per_body


def bound_ms(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / H100_BYTES_PER_S
    t_ops = ops / H100_FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------- #


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms per call over `reps` calls, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(got, want, tol: float, n_envs: int) -> dict:
    """Max / median abs error over [B, ...] tensors and the count of envs
    whose error exceeds tol anywhere."""
    err = (got.float() - want.float()).abs().reshape(n_envs, -1)
    per_env = err.amax(dim=1)
    return {
        "max": float(err.max()),
        "median": float(err.median()),
        "outlier_envs": int((per_env > tol).sum()),
        "tol": tol,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pulse_tpu_torch import _build
    from pulse_tpu_torch.assets import load_smpl_humanoid
    from pulse_tpu_torch.env import cuda_obs
    from pulse_tpu_torch.env.humanoid_im import EnvConfig, HumanoidImEnv
    from pulse_tpu_torch.learning.networks import ActorCritic
    from pulse_tpu_torch.learning.ppo import policy_step
    from pulse_tpu_torch.learning.running_norm import RunningMeanStd
    from pulse_tpu_torch.motion.motion_lib import build_motion_data, get_motion_state
    from pulse_tpu_torch.motion.synthetic import make_synthetic_clips
    from pulse_tpu_torch.physics.model import PhysicsConfig, build_model
    from pulse_tpu_torch.physics.step import physics_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- device ------------------------------------------------------------ #
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "not measured"
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(), "nvidia_smi": card,
          "capability": list(torch.cuda.get_device_capability(0)), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- build ---------------------------------------------------------------- #
    t0 = time.perf_counter()
    _build.load()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 2), **_build.build_report})

    # ---- set-up: model, motion, env, states ---------------------------------- #
    spec = load_smpl_humanoid()
    model = build_model(spec, PhysicsConfig(), device=dev)
    motion = build_motion_data(spec.skeleton, make_synthetic_clips(spec.skeleton, 4, seed=0), device=dev)
    env = HumanoidImEnv(model, motion, EnvConfig(), device=dev, seed=0)
    e = env.consts
    g = torch.Generator(device=dev).manual_seed(1)

    state = env.reset(N_ENVS)
    for _ in range(3):   # a few plain steps so that feet and falls touch the ground
        pd = env.action_to_pd_target(0.3 * torch.randn(N_ENVS, env.action_dim, generator=g, device=dev))
        state = state.replace(physics=physics_step(model, state.physics, pd))
    pd = env.action_to_pd_target(0.3 * torch.randn(N_ENVS, env.action_dim, generator=g, device=dev))
    t = env._motion_time(state.start_time, state.progress + 1)
    ref = get_motion_state(motion, state.motion_id, t)

    # ---- kernels vs plain ----------------------------------------------------- #
    with torch.no_grad():
        k1 = cuda_obs.step_reward_amp(model, e, state.physics, pd, ref)
        p1 = cuda_obs.step_reward_amp_plain(model, e, state.physics, pd, ref)
        # the epilogue alone: plain reward/AMP on the kernel's own stepped state
        ep = cuda_obs.reward_amp_plain(e, k1[0], ref)
        ref_next = get_motion_state(motion, state.motion_id, t + model.config.control_dt)
        k2 = cuda_obs.observe(e, k1[0], ref_next)
        p2 = cuda_obs.observe_plain(e, k1[0], ref_next)
    torch.cuda.synchronize()
    names = ("reward", "reward_raw", "dist_mean", "dist_max", "amp")
    k1_cmp = {f: compare(getattr(k1[0], f), getattr(p1[0], f), K1_TOL[f], N_ENVS) for f in
              ("root_pos", "root_rot", "joint_rot", "root_vel6", "joint_omega", "body_pos", "body_rot",
               "body_vel", "body_ang_vel", "contact_force")}
    k1_cmp.update({n: compare(a, b, K1_TOL[n], N_ENVS) for n, a, b in zip(names, k1[1:], p1[1:])})
    epi_cmp = {n: compare(a, b, K1_TOL[n], N_ENVS) for n, a, b in zip(names, k1[1:], ep)}
    k2_cmp = compare(k2, p2, K2_TOL, N_ENVS)
    in_contact = int((k1[0].contact_force.abs().amax(dim=(1, 2)) > 1.0).sum())
    k1_max_err = max(c["max"] for c in k1_cmp.values())
    emit({"phase": "kernels", "envs": N_ENVS, "envs_in_contact": in_contact, "K1_vs_plain": k1_cmp,
          "K1_epilogue_on_kernel_state": epi_cmp, "K2_vs_plain": k2_cmp})
    allowed = int(OUTLIER_FRAC * N_ENVS)
    for name, c in k1_cmp.items():
        if not c["outlier_envs"] <= allowed:
            fail(f"K1 {name}: {c['outlier_envs']} envs beyond {c['tol']} (max {c['max']})")
    for name, c in epi_cmp.items():
        if c["outlier_envs"]:
            fail(f"K1 epilogue {name}: {c['outlier_envs']} envs beyond {c['tol']} (max {c['max']})")
    if k2_cmp["outlier_envs"]:
        fail(f"K2: {k2_cmp['outlier_envs']} envs beyond {K2_TOL} (max {k2_cmp['max']})")
    if in_contact == 0:
        fail("no env in ground contact: the contact path was not exercised")

    # ---- the slice: 32 policy-acting steps ------------------------------------ #
    net = ActorCritic(env.obs_dim, env.action_dim, device=dev, seed=0)
    obs_rms = RunningMeanStd.create(env.obs_dim, device=dev)
    state = env.reset(N_ENVS)

    def act(st):
        action = policy_step(net, st.obs, g, obs_rms=obs_rms)[0]
        return env.step(st, torch.clamp(action, -1.0, 1.0))

    with torch.no_grad():
        state = act(act(state))   # warm-up: cuBLAS, allocator
        torch.cuda.synchronize()
        cuda_obs.reset_launch_counts()
        resets, rewards = 0, []
        t0 = time.perf_counter()
        for _ in range(HORIZON):
            state = act(state)
            resets += state.done.sum()
            rewards.append(state.reward)
        torch.cuda.synchronize()
        policy_s = time.perf_counter() - t0
        launches = dict(cuda_obs.launches)
    rewards = torch.stack(rewards)
    resets = int(resets)
    slice_info = {"phase": "slice", "envs": N_ENVS, "steps": HORIZON, "launches": launches,
                  "auto_resets": resets, "reward_mean": float(rewards.mean()),
                  "reward_min": float(rewards.min()), "reward_max": float(rewards.max()),
                  "obs_dim": env.obs_dim, "amp_obs_dim": env.amp_obs_dim,
                  "obs_finite": bool(torch.isfinite(state.obs).all()),
                  "reward_finite": bool(torch.isfinite(rewards).all())}
    emit(slice_info)
    for name, n in launches.items():
        if n != HORIZON:
            fail(f"kernel {name} launched {n} times in {HORIZON} env steps")
    if not (slice_info["obs_finite"] and slice_info["reward_finite"]):
        fail("non-finite obs or reward")
    if not (0.0 <= slice_info["reward_min"] and slice_info["reward_max"] <= 1.0):
        fail("reward outside [0, 1]")
    if resets == 0:
        fail("no auto-reset in the slice run")
    if state.obs.shape != (N_ENVS, env.obs_dim) or state.amp_obs.shape != (N_ENVS, env.amp_obs_dim):
        fail("unexpected obs or AMP shape")

    # ---- timing ---------------------------------------------------------------- #
    def window(step, st):
        """Seconds for HORIZON steps, ended by a synchronize."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HORIZON):
            st = step(st)
        torch.cuda.synchronize()
        return st, time.perf_counter() - t0

    def random_step(st):   # bench.py's random-action regime
        return env.step(st, 0.1 * torch.randn(N_ENVS, env.action_dim, generator=g, device=dev))

    # host-clock step times vary on a shared host: alternate WINDOWS more
    # windows of each regime after the slice run and keep them all
    with torch.no_grad():
        st_p, st_r = state, random_step(env.reset(N_ENVS))
        policy_windows, random_windows = [policy_s], []
        for _ in range(WINDOWS):
            st_r, s = window(random_step, st_r)
            random_windows.append(s)
            st_p, s = window(act, st_p)
            policy_windows.append(s)

        # raw kernel launches on prepared [rows, B] buffers (the wrappers'
        # counts are untouched: these are measurement launches)
        lib = _build.load()
        stream = torch.cuda.current_stream().cuda_stream
        ph = state.physics
        J, Jm1 = model.num_bodies, model.num_joints
        x1 = cuda_obs._rows([ph.root_pos, ph.root_rot, ph.joint_rot, ph.root_vel6, ph.joint_omega, pd]
                            + cuda_obs._bodies(ref), N_ENVS, 174 + 69 + 13 * J)
        n_amp = cuda_obs.amp_obs_dim(J, len(e.key_ids), e.amp_v, e.root_height_obs)
        o1 = torch.empty(174 + 16 * J + 7 + n_amp, N_ENVS, device=dev)
        x2 = cuda_obs._rows([ph.body_pos, ph.body_rot, ph.body_vel, ph.body_ang_vel] + cuda_obs._bodies(ref),
                            N_ENVS, 26 * J)
        o2 = torch.empty(env.obs_dim, N_ENVS, device=dev)
        k1_ms = cuda_ms(lambda: _build.check(lib.k1_step_reward_amp(
            x1.data_ptr(), o1.data_ptr(), N_ENVS, cuda_obs.K1_BLOCK, stream), "K1"), 20)
        k2_ms = cuda_ms(lambda: _build.check(lib.k2_observe(
            x2.data_ptr(), o2.data_ptr(), N_ENVS, J, int(e.local_root_obs), int(e.root_height_obs),
            cuda_obs.K2_BLOCK, stream), "K2"), 100)
        # two warps a block put 3072 envs on 48 SMs instead of 96
        k1_ms_block64 = cuda_ms(lambda: _build.check(lib.k1_step_reward_amp(
            x1.data_ptr(), o1.data_ptr(), N_ENVS, 64, stream), "K1"), 20)
        k1_plain_ms = cuda_ms(lambda: cuda_obs.step_reward_amp_plain(model, e, ph, pd, ref), 3)
        k2_plain_ms = cuda_ms(lambda: cuda_obs.observe_plain(e, ph, ref), 10)
        k1_wrap_ms = cuda_ms(lambda: cuda_obs.step_reward_amp(model, e, ph, pd, ref), 20)
        k2_wrap_ms = cuda_ms(lambda: cuda_obs.observe(e, ph, ref), 20)

        # device kernels per policy-acting step, from a profiler trace
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                st_p = act(st_p)
            torch.cuda.synchronize()
        kern = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
        device_ms_per_step = sum(ev.time_range.elapsed_us() for ev in kern) / 4e3
        kernels_per_step = len(kern) / 4

    def steps_per_s(windows):
        return sorted(N_ENVS * HORIZON / s for s in windows)

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    step_ms_policy = 1e3 * median(policy_windows) / HORIZON
    k1_bound, k1_by = bound_ms(
        4.0 * N_ENVS * (x1.shape[0] + o1.shape[0]),
        N_ENVS * k1_ops_per_env(J, int(model.cp_body.shape[0]), model.config.steps_per_control,
                                len(e.reset_ids), len(e.key_ids), e.amp_v))
    k2_bound, k2_by = bound_ms(4.0 * N_ENVS * (x2.shape[0] + o2.shape[0]), N_ENVS * k2_ops_per_env(J))
    emit({"phase": "timing", "card": card, "envs": N_ENVS,
          "env_steps_per_s_policy": median(steps_per_s(policy_windows)),
          "env_steps_per_s_random_actions": median(steps_per_s(random_windows)),
          "env_steps_per_s_policy_windows": steps_per_s(policy_windows),
          "env_steps_per_s_random_windows": steps_per_s(random_windows),
          "step_ms_policy": step_ms_policy, "step_ms_random_actions": 1e3 * median(random_windows) / HORIZON,
          "K1_ms": k1_ms, "K1_ms_block64": k1_ms_block64, "K2_ms": k2_ms,
          "K1_wrapper_ms": k1_wrap_ms, "K2_wrapper_ms": k2_wrap_ms,
          "device_kernels_per_step": kernels_per_step, "device_busy_ms_per_step": device_ms_per_step,
          "device_idle_share": (1.0 - device_ms_per_step / step_ms_policy) if device_ms_per_step else None,
          "K1_plain_ms": k1_plain_ms, "K2_plain_ms": k2_plain_ms,
          "kernels_share_of_policy_step": (k1_ms + k2_ms) / step_ms_policy,
          "K1_ops_per_env": k1_ops_per_env(J, int(model.cp_body.shape[0]), model.config.steps_per_control,
                                           len(e.reset_ids), len(e.key_ids), e.amp_v),
          "K2_ops_per_env": k2_ops_per_env(J)})

    src = "pulse_tpu_torch/csrc/"
    emit({"kernels": [
        {"name": "step_reward_amp", "route": "cuda", "source": src + "step_reward_amp.cu",
         "replaces": "pulse_tpu/env/pallas_obs.py:376", "launches": launches["step_reward_amp"],
         "max_abs_err": k1_max_err, "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "observe", "route": "cuda", "source": src + "observe.cu",
         "replaces": "pulse_tpu/env/pallas_obs.py:558", "launches": launches["observe"],
         "max_abs_err": k2_cmp["max"], "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
