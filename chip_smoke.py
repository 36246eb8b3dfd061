#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pulse_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  device       the card, its power limit (the raw nvidia-smi line is printed
               too)
  build        nvcc of pulse_tpu_torch/csrc/*.cu for sm_90a, one process per
               source: seconds, registers, stack and spill bytes per kernel
               instantiation; the physics kernels' launch geometry per
               group size G (lanes an env): shared bytes an env and a
               block, envs a block, resident blocks an SM; K2's and RA's
               at 3072 envs: blocks, threads and shared bytes a block,
               resident blocks an SM
  kernels      K1 (step_reward_amp), K2 (observe), K3 (physics_step), K3-rows
               (physics_step_rows) and RA (reward_amp) against their plain
               PyTorch versions at 3072 envs, on states from a
               reference-state reset of synthetic clips plus a few plain
               physics steps (feet in contact); K3 -> RA against K1 on the
               same inputs; K3-rows on a vary_model_scales(0.9, 1.1) model
               against physics_step on it, and on the shared model's rows
               against K3; K1, K3, K3-rows, RA and K2 on a ragged batch of
               13 envs against the full batch's first 13, bit for bit, and
               K1, K3, RA and K2 writing nothing past the batch
  slice       HumanoidImEnv (default EnvConfig/PhysicsConfig, 4 synthetic
               clips, 3072 envs) acting for 32 steps under the 2048-1536-1024
               ActorCritic in bf16 autocast; K1 and K2 must launch exactly 32
               times, obs/reward finite, reward in [0, 1], some auto-reset
  timing       env steps/s with the policy acting and with random actions;
               K1's and K2's ms and their plain versions' (CUDA events); K1
               at the chosen G and at G = 1 in turns (1, G, G, 1), and the
               max abs difference of their outputs
  general      on env=im's config, from one state at 3072 envs with the
               env's generator re-seeded before each, one step through
               `_step_general` (K3, then plain PyTorch) and one through `step`
               (K1, then K2): reward, raws and AMP history within 1e-5 and the
               observation within 1e-4 in every env, the same resets, done and
               terminate alike but where the mean reset-body distance lies
               within 1e-5 of the threshold; exact launches. Then 8 acting
               steps each of obs v7, v8, v9 with 3 future frames, self obs v2
               and v3, the far-goal mode with a quarter of the envs moved
               10 m, occlusion 0.5, noise 0.05, state init Start and Hybrid:
               the obs width, finite obs, exact launches (K3 alone on the
               general path; K1 and K2 where an option rides them), and each
               option's own effect
  train_im     `python -m pulse_tpu_torch.run env=im learning=im_ppo
               num_envs=3072` for 2 epochs through run.main: finite losses,
               changed parameters, obs_rms.count grown by 32 * 3072 an epoch,
               32 launches of K1 and of K2 an epoch and none of K3 or RA
  eval         im_eval of train_im's policy on the 6 hard clips at a batch
               of 6, early termination off, then run.main's test=true on
               train_im's checkpoint and 4 clips (a batch of 3072): finite
               metrics, each clip's scored steps #{i : (i+1) dt < length},
               and per batch exactly max_steps launches of K1 and max_steps
               + 1 of K2 (one at reset_to; test=true one more at the
               agent's reset), none of K3 or RA; the eval's seconds and K1's
               and K2's ms at 6 envs
  distill      `python -m pulse_tpu_torch.run env=im_vae learning=im_z_fit
               num_envs=3072` for 3 epochs through run.main, the teacher
               train_im's checkpoint: PULSE's online distillation into the
               reference-width PulseVAE on the getup curriculum with the
               cycled reference (episode_length 300) and the power reward.
               60 K3 launches (the fall-state settle) while the env is
               built, one K2 at the reset, then 32 of K3, RA and K2 an epoch
               and none of K1; finite losses (bc_loss per epoch), the
               encoder, prior and decoder changed, the critic and the
               teacher bit-unchanged, obs_rms.count grown by 32 * 3072 an
               epoch; some env crossed its clip's end without a reset, and
               there its reference root moved less than 0.1 m (the cycle
               offset applied); no reward above the kernel's imitation
               reward (the power penalty is <= 0); then RA and K2 against
               their plain versions on a reference a clip or more ahead
               (every env's shifted); rollout and update times, device busy
               ms, kernels and idle share
  getup_tables K3 against physics_step on the fall-state settle's ragdoll
               model (kp 0, kd 5) at 256 envs, on the settle's first input;
               then, with no cache cleared, K3 on the real model against the
               kernels phase's plain step (the constant table must be
               uploaded again); in mid-settle, where the step is
               ill-conditioned, K3's and plain float32's envs beyond the
               tolerances against a float64 step (measured, not checked)
  train_getup  the same with env=im_getup at its full settings: 60 K3
               launches (the fall-state settle) while the env is built, then
               32 of K3, RA and K2 an epoch and none of K1; some resets drew
               fall states and some terminations were held back by the grace
               window; reward in [0, 1], finite obs; then K3 on the run's own
               model against physics_step on the run's last state
  train_shape  the same with env=im_shape (per-env isotropic scales in
               [0.9, 1.1], shape/limb channels): 32 of K3-rows, RA and K2 an
               epoch and none of K1 or K3; the observation 955 wide with
               columns 358-378 the env's shape rows; then resample_shapes
               and K3-rows on the env's rows against physics_step on the new
               batched model (a stale rows cache would fail: the old and
               new models' steps differ)
  shape_betas  the env=im_shape env built through run's builders with
               env.smpl_model_path at a synthetic SMPL pickle (written by
               smpl/synthetic.py), 3072 SMPL-beta skeletons: 8 policy-acting
               steps (8 launches each of K3-rows, RA and K2), then K3-rows
               against physics_step on the env's state
  train_vr     the same training as train_im with env=im_vr (VR three-point
               tracking: Head, L_Hand, R_Hand): 32 K3 launches an epoch and
               none of K1, RA or K2; the observation 430 wide
  train_amp_im `python -m pulse_tpu_torch.run env=im learning=im_amp
               num_envs=3072` for 2 epochs: PPO on the 0.5/0.5 mix of the
               imitation reward and the 1024-512 discriminator's style
               reward on the 2320-wide AMP window. 32 launches of K1 and K2
               an epoch (K2 once more at the reset), none of K3 or RA; the
               discriminator changed; replay 512 and demo 4096 + 512 rows
               more an epoch; amp_rms.count grown by 32 * 3072 + 512 an
               epoch; the recorded AMP window of each epoch's last step the
               env's amp_hist; the mix to 1e-6; the style reward finite and
               >= 0, the accuracies in [0, 1]; rollout, GAE, update and the
               discriminator's reward and update ms, device busy ms, kernels
               and idle share of each (the style reward's device ms from
               CUDA events, beside its bound and one trace's kernels)
  train_rnn    RNNActorCritic (trunk 1024-512, LSTM 256) in a PPOAgent of
               env=im learning=im_ppo's configs (built through run's
               builders; no config builds it) at 3072 envs for 2 epochs,
               seq_len 4 (4096 sequences a minibatch): 32 K1 and 32 K2 an
               epoch, finite losses, each epoch from the last one's carry;
               before the first optimizer step every stored sequence
               replayed through the cell at the rollout's parameters in
               update_rnn's layout, its neg-log-probs and values against
               the rollout's (RNN_REPLAY_TOL); a done env's output that of
               a zero carry, bit for bit; its env steps/s, rollout and
               update ms beside train_im's, device busy ms of a rollout and
               an update
  train_amp_rnn  the same network in env=im learning=im_amp's AMPAgent:
               train_amp_im's launches and AMP rows an epoch, a
               discriminator step an epoch, the carried hidden
  train_sept   SeptActorCritic (self / task / actor 1024-512, critic
               2048-1024, float32) in im_ppo's PPOAgent on env=im: the
               launches, finite metrics, device busy ms
  z_embedding  ZEmbedding of each z type (16384 rows of a 1024-wide
               feature, latent 32, a codebook of 512) on the card against
               the same module on the CPU: float32 tolerance (Z_TOL), equal
               indexes but where two codes tie (Z_TIE); quantize and
               ema_update
  train_amp    the same with env=amp (HumanoidAMPEnv, the self obs only, 358
               wide; task reward exactly 1): 32 launches of K3 and RA an
               epoch, no K1 and no K2, not even at the reset; RA's AMP row
               on the run's last state against cuda_obs.amp_row_plain (0
               outlier envs); terminations counted
  train_amp_getup  env=amp_getup env.getup_update_epoch=1 for 3 epochs: 60
               K3 launches at 256 envs (the settle), then 32 of K3 and RA an
               epoch; in epochs 0-1 the style reward alone on fall resets
               (fall_init_prob 1, recovery 0), in epoch 2 the 0.5/0.5 mix
               and the configured probabilities
  train_mcp    env=im_mcp learning=im_ppo for 2 epochs: the 2048-1536-1024
               policy outputs 3 composer weights over 3 frozen 512-512 PNN
               columns (seed + 13); 32 launches of K1 and K2 an epoch (K2
               once more at the reset), none of K3 or RA; the PNN
               bit-unchanged; the env's blend (under a bf16 autocast)
               float32 and equal to compose_actions of the PNN run apart;
               the blend's ms; ms and device-busy ms a step
  train_mcp_getup  env=im_mcp_getup for 2 epochs: 60 K3 launches (the
               settle), then 32 of K3, RA and K2 an epoch
  train_getup_shape  env=im_getup env.shape_variation=true for 2 epochs:
               the fall-state bank settled under the shared model (60 K3
               launches, no more), then 32 of K3-rows, RA and K2 an epoch;
               fall resets; the model rows as distinct as the envs' models;
               one step of K3-rows, RA and K2 against their plain versions on
               identical inputs (<= 1% outlier envs)
  getup_shape_tasks  env=amp_getup (K3-rows -> RA, no K2), env=im_mcp_getup
               and env=im_vae learning=im_z_fit, each with
               env.shape_variation=true for 1 epoch: the route, exact
               launches, finite losses
  curriculum   `python -m pulse_tpu_torch.curriculum` at 2048 envs, 2
               epochs a stage, with the specialists, the sharp-turn ladder,
               amp_getup and the getup composer with its gate pretrain; two
               eval outcomes forced (column 0 passes fast_run, the ladder's
               first eval passes level 0) so that the composer trains and the
               ladder advances: the stage order the tool's rules give on its
               evals, exact launches of every epoch (K1 -> K2 for the
               columns, K3 -> RA -> K2 for amp_getup and the composer), eval
               (K1 -> K2) and env build, finite losses, each column's first
               weights the previous column's (column 0's for the others),
               the JSON's keys a superset of quality/curriculum_r5.json's
  curriculum_resume  the same command into the same --out: every stage
               restored, no epoch, only the evals' launches, the same results
  forward_pmcp column 0 copied onto column 1 of the curriculum's frozen PNN,
               bit for bit
  train_dr     env=im learning=im_amp env.randomize=true
               env.shape_resampling_interval=2 for 4 epochs: 32 launches of
               K3-rows, RA and K2 an epoch, none of K1 or K3; the friction
               rows of each epoch's K3-rows model rows in [0.7, 1.3] x the
               base and distinct across envs, re-drawn before epoch 3 only
               (the rows change); K3-rows on the re-drawn rows against
               physics_step on the env's batched model (<= 1% outlier envs;
               the pre-re-draw model's step differs in more envs than
               that); one more step's obs equal to the DR noise recomputed
               from the held and fresh draws on K2's clean obs
  demo         scripts/demo_server.demo_loop at 1 env on train_im's
               checkpoint for 64 steps, a PoseServer on 127.0.0.1 (port 0)
               and an in-process PoseClient (socket timeout): 64 frames
               received, body_pos [24, 3] finite, reward in [0, 1]; a clip
               switch after frame 16 puts the env on that clip (id mod the
               clip count) at that time with progress 0, a driving pose
               after frame 40 sets root pos, root rot and dof within 1e-5
               before the next step; K1 one launch a step, K2 one a step
               and one more at each reset (the loop's, the switch's), none
               of K3 or RA; ms a step (utils/benchmarking.Timer)
  demo_tasks   run.main test=true with env.task=HumanoidImDemo on
               train_im's checkpoint and HumanoidImMCPDemo on train_mcp's:
               each builds HumanoidImEnv / HumanoidImMCPEnv, and its
               launches and metrics equal those of HumanoidIm's (the eval
               phase's run) and HumanoidImMCP's on the same seed
  legacy_cli   pulse_tpu_torch.legacy_cli.main --task HumanoidIm --num_envs
               3072 --max_iterations 1 in process: env=im learning=im_ppo,
               32 launches of K1, 33 of K2 (one at the reset), none else
  record_sample  record_rollout (train_im's checkpoint, 4 envs) and
               sample_pulse (the distill phase's PulseVAE, 2 envs, early
               termination off) through their mains at 300 steps: 300 K1
               and 301 K2 launches each, the .npz keys and shapes of the
               JAX scripts, finite; the sampler terminates no env and ends
               each episode only at episode_length
  control_modes  8 steps each of isaac_pd, pd and force from the standing
               reference state (velocities zeroed; the pose-holding action,
               zero torque under force): isaac_pd K1 and K2 8 each, pd and
               force no launch; isaac_pd keeps the mean body height within
               5 mm, force loses more than 5 mm; the root and body height
               changes (pd's too: the reference's explicit PD is unstable),
               ms, device-busy ms and device kernels a step
  train_speed_z  `python -m pulse_tpu_torch.run env=speed_z
               learning=pulse_z_task num_envs=3072
               env.z_checkpoint=<distill's ckpt/>` for 2 epochs: PPO
               (1024-512) over 32-d latents that the distill phase's frozen
               PulseVAE decodes (float32), the 1024-512 discriminator; 32
               K3 launches an epoch and nothing else; the VAE bit-unchanged,
               the policy and discriminator changed, the task reward in
               [0, 1], some terminations; K3 on the run's last state against
               physics_step (<= 1% outlier envs); then test=true on the run's
               checkpoint: task_eval over one episode cut to 100 steps at
               3072 envs (100 K3 launches), finite return, length,
               terminate rate; ms,
               device-busy ms and device kernels a step, the idle share, the
               training env steps/s and the decode's ms alone
  train_reach_z  the same with env=reach_z (R_Hand)
  z_im_traj    8 policy-acting steps of env=im_z (K1 and K2 8 each) and of
               env=traj_z (K3 8; obs 378) on the same checkpoint
  pulse_stages `python -m pulse_tpu_torch.bench_pulse` (bench_pulse.main) at
               2048 envs and full widths, 2 epochs a stage: the teacher, the
               float32 student, 300 prior-sampling steps at 256 envs,
               speed_z and reach_z, their im_evals and task_evals; exact
               launches in each stage (K1 and K2 in the teacher, the
               student, the evals and prior sampling, K3 only in the Z
               stages, no RA or K3-rows); every key of
               quality/pulse_stages_r5.json, seven targets, finite metrics
               (the targets' verdicts are recorded, not gated); the
               student's action within 1e-4 of a float64 copy (its bf16
               form misses that); the frozen PulseVAE bit-unchanged after
               the Z training; each stage's seconds and env steps/s; then
               K1 -> K2 on the student's last rollout state (2048 envs) and
               on prior sampling's last state (256, cycled reference), and
               K3 on each Z task's last training state, against their plain
               versions within K1's / K2's tolerances in all but 1% of the
               envs
  plain_arm    one env=im step with env.use_pallas_physics false (no launch)
               and true (K1, K2) from one reset: physics within K1's
               tolerances in all but 1% of the envs, elsewhere the same
               flags, reward within 1e-4 and obs within 5e-3 (the stepped
               velocities' tolerance: the obs reads them)
  import_pth   reference-layout .pth files built in a temporary directory
               (torch modules laid out as the rl-games builders lay them
               out): a PNN of 3 columns of 512-512 over the 934-wide obs
               with laterals and running stats, a 512-256 composer, a
               PulseVAE at im_z_fit's widths with running stats; each
               imported network against the module it was saved from
               (max abs <= 1e-5, TF32 off); then 2 epochs each of env=im_mcp
               env.pnn_checkpoint=<pnn> (K1 -> K2, as train_mcp),
               env=im_vae learning=im_z_fit with the PNN and composer
               teacher (60 settle K3, then K3 -> RA -> K2 32 each an epoch)
               and env=speed_z env.z_checkpoint=<pulse>.pth (K3): exact
               launches, finite losses, the imported networks bit-unchanged,
               the kernels on each run's last state against their plain
               versions (<= 1% outlier envs)
  train_strike 1 epoch of env=strike learning=pulse_z_task (PPO 1024-512
               with the discriminator): the physics route "plain" and no
               launch (the box's coupled step), reward in [0, 1], some box
               tipped or pushed; one step of 64 envs on the card against the
               CPU (the physics within K1's tolerances, the reward within
               K1's, the obs function on the card's stepped state within
               K2's; <= 1% outlier envs); then 8 steps of env=strike_z on the
               imported PulseVAE; ms and device kernels a step
  train_terrain  the same with env=pedestrian_terrain on the default 8 x 8
               tiles of 8 m (a 256 x 256 heightfield), obs 634: spawns on
               walkable cells with the lowest foot within FOOT_TOL of the
               ground under it in FOOT_FRAC of the envs; 8 steps of
               HumanoidPedestrianTerrainZ
  train_terrain_cnn  CNNActorCritic (conv 16-32 on the 16 x 16 height
               map, then 1024-512 towers) in train_terrain's AMPAgent, 1
               epoch at 3072 envs on the plain route: no launch, finite
               metrics, the conv features of every env moved by a shifted
               height map and the flat ones not
  self_collision  8 steps of HumanoidImEnv on a self-collision model at
               3072 envs: the plain route, no launch, finite states, one
               step of 64 envs on the card against the CPU
  motion_file  ~10,000 clips of 30-600 frames at 30 fps (~3.15M frames, AMASS's
               size), cut as windows from 64 synthetic 20 s clips, written
               with write_archive into a directory under output/ (1.25 GB),
               read back (1% of the clips bit for bit) and built into the
               store on the card (6 GB): seconds to write, read (GB/s) and
               build, the store's bytes; the card's store of 200 of the clips
               and get_motion_state at 4,096 (clip, t) against the CPU's
               build (positions and rotations within 1e-5, velocities within
               1e-4 of the field's largest magnitude, plus a floor only at
               the elements whose CPU side is at a cut of the reference's
               angle-axis or slerp: MF_*); then
               env=im learning=im_ppo
               env.motion_file=<the .mtn> for 2 epochs through run.main (as
               train_im: 32 launches of K1 and K2 an epoch, none of K3 or RA;
               its training env steps/s beside train_im's); then
               process_amass's raw -> db -> isaac stages on 20 generated 120
               fps AMASS-style sequences with a gendered synthetic SMPL
               triple at V = 6890 (the ground fix one batched LBS a gender
               on the card), the .pkl read into a store on the card: the
               card's LBS within 1e-5 m of a float64 CPU LBS of the same
               poses, each fixed first frame's lowest vertex at z = 0; the
               phase's seconds
  scripts_on_card  play_motion's store of 4 synthetic clips and its
               trace of the last, joint_monkey's FK sweep (20 frames a DOF)
               and render_smpl_mesh's batched skinning of 40 frames on a
               synthetic SMPL model at V = 6890, each on the card and on
               the CPU on the same inputs: positions within 1e-5 m, the
               store and its lookups within motion_file's tolerances and
               floors; the drawing writes PNGs where matplotlib is
               installed, else raises the ImportError that names it; no
               kernel launch
  dp_world1    in process, an NCCL process group of one rank on the card
               (`pulse_tpu_torch.parallel`): one epoch each of env=im
               learning=im_amp and env=im_vae learning=im_z_fit at 3072 envs
               through run's build functions, every update its data-parallel
               variant (exact launches an epoch: 32 K1 and K2; 32 K3, RA and
               K2);
               then, from one state and one more rollout, the DP update
               against the plain update (DP_WORLD1_TOL)
  dp_two_ranks `python -m pulse_tpu_torch.parallel.dryrun`'s ranks, two
               processes of 1536 envs on the one card over gloo (NCCL
               refuses two ranks on one device; the phase says so on a
               line): one epoch each of AMP, distillation and the joint
               agent, one sharded im_eval batch, K3 on each rank's rows
               against the full batch (bit for bit), and a one-minibatch
               PPO update against one process's update on the gathered
               rollout (dryrun.ONE_MB_TOL); every replicated tensor
               bit-identical across the ranks after each stage, each rank's
               launches exact; each stage's seconds and the collectives'
               ms a gradient step
  perturb     HumanoidImPerturbEnv (proj_interval 8, early termination
               off) for 24 policy-acting steps: every projectile relaunched
               exactly where the pre-step progress is 7 mod 8 (some at 7,
               15 and 23), some envs hit, no kernel launch; ms, device-busy
               ms and kernels a step; physics_step_with_prop with the prop
               out of reach against K3 on the same state (<= 1% outlier
               envs, no contact)
  The training phases time rollout, GAE and update (epochs after the first)
  and the training env steps/s; then K3's (3072 and 256 envs), K3-rows' and
  RA's ms and their plain versions', K3 and K3-rows at the chosen G and at
  G = 1 in turns with the max abs difference of their outputs, and every
  built G's time for K1, K3 and K3-rows (group_sweep). Every kernel's ms
  is one timer, `cuda_ms`: CUDA events around raw launches back to back,
  their arguments built once. The roofline line gives each kernel's launch
  geometry, achieved GB/s and fraction of its bound; for K2 and RA also
  ms, profiled device ms and device GB/s, warm and on L2-cold inputs
  (at 3072 and 384 envs).
Then the kernels' JSON line, the card's nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed check exits non-zero before the
last line. Exits non-zero without CUDA or without the package beside it.
"""

import ctypes
import dataclasses
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time

N_ENVS = 3072
HORIZON = 32
WINDOWS = 4                     # timed windows of HORIZON steps per regime
TRAIN_EPOCHS = 2
DISTILL_EPOCHS = 3
PULSE_ENVS = 2048               # the PULSE harness's own batch
PULSE_EPOCHS = 2                # its epochs a stage here
CUR_EPOCHS = 2                  # the curriculum phase's epochs a stage (at PULSE_ENVS)
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12     # fp32 outside the tensor cores, H100 SXM
L2_BYTES = 50 * 2**20           # H100 SXM L2

# Kernel-vs-plain tolerances. K1's physics: those the TPU kernel is held to
# against the XLA step (tests/test_pallas_substep.py); the compliant contact
# flips on float noise, so up to OUTLIER_FRAC of the envs may exceed them.
# Reward 1e-4 and AMP 1e-3 as for the TPU kernels. K2: 1e-3 (same atan2
# heading in kernel and plain version, so only rounding separates them).
K1_TOL = {"root_pos": 2e-4, "root_rot": 2e-4, "joint_rot": 2e-4, "root_vel6": 5e-3, "joint_omega": 5e-3,
          "body_pos": 3e-4, "body_rot": 2e-4, "body_vel": 5e-3, "body_ang_vel": 5e-3, "contact_force": 1.0,
          "reward": 1e-4, "reward_raw": 1e-4, "dist_mean": 3e-4, "dist_max": 3e-4, "amp": 1e-3}
K2_TOL = 1e-3
PHYS_FIELDS = ("root_pos", "root_rot", "joint_rot", "root_vel6", "joint_omega", "body_pos", "body_rot", "body_vel",
               "body_ang_vel", "contact_force")
OUTLIER_FRAC = 0.01
RAGGED = 13                     # a batch whose last block of 8 envs holds 5
GENERAL_STEPS = 8               # acting steps of each general-path option
# the general step against the kernel path: max abs per field in every env
GENERAL_TOL = {"reward": 1e-5, "reward_raw": 1e-5, "amp_hist": 1e-5, "obs": 1e-4}
GENERAL_EDGE = 1e-5             # done/terminate may differ within this of the threshold
SETTLE_CHECK_STEP = 8           # the mid-settle step (in contact) where K3 is measured
CONTROL_STEPS = 8               # steps of each control mode
PROJ_INTERVAL = 8               # the perturb phase's steps between launches
PERTURB_STEPS = 24              # the perturb phase's acting steps
SC_STEPS = 8                    # the self_collision phase's steps
# train_terrain's spawns: the lowest foot within FOOT_TOL of the ground under
# it in at least FOOT_FRAC of the envs (the pose is lifted by the ground at
# the root; a foot over a stair edge or a pit's rim is not), and at the
# median
FOOT_TOL = 0.1
FOOT_FRAC = 0.8
# motion_file: MF_CLIPS clips of MF_MIN_T-MF_MAX_T frames at 30 fps (AMASS's
# ~10k clips, ~3.15M frames: 1.25 GB of archive, 6 GB of store) cut from
# MF_BASES synthetic 20 s clips; the card's store of MF_SUBSET of them and
# MF_QUERIES motion-state lookups against the CPU's. Positions and rotations
# within MF_POS_TOL, velocities within MF_VEL_REL of the field's largest
# magnitude, plus a floor that each element's CPU side sets: the reference's
# quaternion functions (both packages') take sqrt(1 - x * x) of a float32 x
# near 1 (a quaternion's w in quat_to_angle_axis, cos(q0, q1) in slerp),
# and the card's value of it may differ from the CPU's by MF_ULPS ulps of
# 1 - x^2 (the rounding of x * x, the last bits of x, the quaternion's
# norm). So, with s^2 = 1 - x^2 of the CPU's x:
# - an angle-axis vector v (the angular and dof velocities a frame, times
#   the fps, then carried by the store's Gaussian smoothing as its weights
#   carry the rate; dof_pos) may differ by |v| * MF_ULPS 2^-24 / (2 s^2),
#   and by the jump 2 |xyz| where s^2 is within MF_ULPS ulps of 0: there
#   one side reads w as 1 and returns 0;
# - a slerped rotation (root_rot, rb_rot, local_rot) by
#   MF_ULPS 2^-24 / (2 s^2) of its size above slerp's cut (s < 1e-3 returns
#   (q0 + q1) / 2 whatever the blend), and by |q1 - q0| a component within
#   MF_ULPS ulps of the cut or below it; dof_pos, the angle-axis of a
#   slerped local rotation, by its own floor plus |v| times the slerp's
#   relative one, and pi |q1 - q0| at slerp's cut.
# An element far from x = 1 gets a floor far under the base tolerance.
MF_CLIPS = 10_000
MF_MIN_T, MF_MAX_T = 30, 600
MF_BASES = 64
MF_SUBSET = 200
MF_QUERIES = 4096
MF_POS_TOL = 1e-5
MF_VEL_REL = 1e-4
MF_ULPS = 4
MF_AMASS_SEQS = 20
STORE_FIELDS = ("gts", "grs", "gvs", "gavs", "lrs", "dvs")   # a motion store's per-frame tables
# the entry points: the demo loop's steps at 1 env, the frames after which the
# in-process client sends a clip switch and a driving pose, the seconds any
# socket wait gives up after; record_rollout's and sample_pulse's steps (their
# scripts' defaults)
DEMO_STEPS = 64
DEMO_MOTION_AT = 16
DEMO_POSE_AT = 40
DEMO_SOCKET_S = 30.0
RS_STEPS = 300
PLAIN_EPOCHS = 1                # train_strike's and train_terrain's epochs (the plain route, ~0.4 s a step)
Z_EVAL_STEPS = 100              # train_speed_z's and train_reach_z's test=true episode
# train_rnn's replay of the stored sequences against the rollout: the trunk's
# bf16 GEMMs may round apart at another row count, the cell and heads are float32
# dp_world1: from one state and rollout, the DP update (world size 1) against
# the plain update: every parameter within half a learning rate and the
# parameter updates within 1% in L2 norm (36 PPO and 10 distillation Adam
# steps of bf16 networks, whose rounding the E[x²] - m² moments move; the H100
# read 0 and 0.025 learning rates, PERF.md), the moments within 1e-5 and the
# metrics within 1e-3 of their scale (dryrun.update_diff)
DP_WORLD1_TOL = {"params_over_lr": 0.5, "update_rel_l2": 1e-2, "moments": 1e-5, "metrics": 1e-3}
DP_RANKS = 2                    # dp_two_ranks: gloo ranks on the one card, N_ENVS / DP_RANKS envs each
DP_RANKS_TIMEOUT_S = 300
RNN_REPLAY_TOL = {"neglogp": 0.05, "value": 0.01}   # value: x (1 + the values' largest |v|)
Z_ROWS, Z_FEAT, Z_LATENT, Z_CODES = 16384, 1024, 32, 512   # z_embedding's batch, feature, latent, codebook
Z_TOL = 1e-5                    # z_embedding, card against CPU in float32: x (1 + the CPU side's largest)
Z_TIE = 1e-5                    # two codes tie within this of |z|^2 + |c|^2
PLAY_CLIPS = 4                  # scripts_on_card: play_motion plays the last of these synthetic clips
SWEEP_FRAMES = 20               # joint_monkey --sweep's frames a DOF (its default)
SKIN_FRAMES = 40                # render_smpl_mesh's frames skinned in one batch


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


def physics_ops_per_env(J: int, P: int, n_sub: int) -> int:
    """K3, and K1's physics half: the control step and the final FK."""
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
    return (J - 1) * o["expmap_to_quat"] + n_sub * substep + 3 * J + final_fk


def epilogue_ops_per_env(J: int, n_reset: int, n_key: int, amp_v: int) -> int:
    """RA, and K1's epilogue: reward, termination distances, AMP row."""
    o = OPS
    reward = J * (3 * 9 + o["qmul"] + o["quat_angle"] + 2) + 20
    dist = n_reset * 11
    amp = (o["heading"] + o["zrot"] + o["qmul"] + o["tan_norm"] + 2 * o["qrot"]
           + (J - 1) * (o["quat_to_expmap"] + o["expmap_to_quat"] + o["tan_norm"])
           + n_key * (3 + o["qrot"]) * (2 if amp_v == 2 else 1))
    return reward + dist + amp


def rows_ops_per_env(J: int, P: int, n_sub: int) -> int:
    """K3-rows: K3's operations plus the rebuild of each body's B block from
    the rows (9 products a body, in every substep's bias-force pass)."""
    return physics_ops_per_env(J, P, n_sub) + n_sub * J * 9


def k1_ops_per_env(J: int, P: int, n_sub: int, n_reset: int, n_key: int, amp_v: int) -> int:
    return physics_ops_per_env(J, P, n_sub) + epilogue_ops_per_env(J, n_reset, n_key, amp_v)


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


def in_turns(time_a, time_b) -> tuple[list, list]:
    """Two timings compared in one call, in turns a, b, b, a: ([a, a], [b, b])."""
    a1, b1 = time_a(), time_b()
    b2, a2 = time_b(), time_a()
    return [a1, a2], [b1, b2]


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


def env_slice(obj, lo: int, hi: int):
    """Views of envs [lo, hi) of a [B, ...] tensor, a PhysicsState, a dict
    of tensors, or a tuple of these."""
    if isinstance(obj, tuple):
        return tuple(env_slice(o, lo, hi) for o in obj)
    if isinstance(obj, dict):
        return {k: v[lo:hi] for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: getattr(obj, f.name)[lo:hi] for f in dataclasses.fields(obj)})
    return obj[lo:hi]


def envs_beyond(got, want, n_envs: int) -> int:
    """Envs whose error exceeds K1_TOL in any physics field."""
    import torch

    bad = torch.zeros(n_envs, dtype=torch.bool, device=got.root_pos.device)
    for f in PHYS_FIELDS:
        err = (getattr(got, f).double() - getattr(want, f).double()).abs().reshape(n_envs, -1).amax(dim=1)
        bad |= err > K1_TOL[f]
    return int(bad.sum())


def as_float64(obj):
    """A copy of a Model or PhysicsState with its float tensors in float64."""
    import torch

    return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).double() for f in dataclasses.fields(obj)
                                       if isinstance(getattr(obj, f.name), torch.Tensor)
                                       and getattr(obj, f.name).is_floating_point()})


# --------------------------------------------------------------------------- #
# the data-parallel phases: main() calls them on the card; on the CPU,
# dp_world1(torch.device("cpu"), "gloo", 8, "cpu") and dp_two_ranks("cpu", 8,
# "cpu") rehearse them at the configs' widths (no launches expected there)
# --------------------------------------------------------------------------- #

def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dp_world1(dev, backend: str, n_envs: int, card: str) -> dict:
    """One rank's process group on dev (NCCL on the card): one epoch each of
    env=im learning=im_amp and env=im_vae learning=im_z_fit at n_envs
    through run's build functions, env.mesh routing every update through its
    data-parallel variant (the collectives run, over one rank); then, from
    one state and one more rollout, the DP update against the plain update
    (DP_WORLD1_TOL). Launches exact on the card, none elsewhere. Emits and
    returns the phase's record; fail()s on a breach."""
    import copy
    import tempfile

    import torch.distributed as tdist

    from pulse_tpu_torch import _build
    from pulse_tpu_torch.learning.ppo import compute_gae
    from pulse_tpu_torch.parallel import dryrun as dpr
    from pulse_tpu_torch.parallel import mesh as pmesh

    no_launch = {k: 0 for k in _build.launches}
    t_dp = time.perf_counter()
    dp_tmp = tempfile.mkdtemp(prefix="dp_world1_")
    pmesh.init_process_group(backend, 0, 1, os.path.join(dp_tmp, "store"), device=dev)
    try:
        mesh1 = pmesh.make_mesh(dev)
        mesh1.timed = True

        def world1_epoch(label, args, kernels):
            """(env, agent, state, info) after one epoch through the DP
            path; gates its launches (horizon of each of `kernels` on the
            card) and finite metrics."""
            cfg_, env_, agent_ = dpr.build([*args, f"num_envs={n_envs}"], dev)
            horizon = int(cfg_["learning"]["horizon_length"])
            want_epoch = dict(no_launch, **{k: horizon for k in kernels}) if dev.type == "cuda" else no_launch
            pmesh.use_mesh(env_, mesh1)
            ts_ = pmesh.shard_train_state(mesh1, agent_.init())
            if hasattr(agent_, "pre_epoch"):
                ts_ = agent_.pre_epoch(ts_, 0)
            _sync(dev)
            before_, c0_ = dict(_build.launches), mesh1.collective_s
            t0_ = time.perf_counter()
            ts_, m_ = agent_.train_epoch(ts_)
            _sync(dev)
            per_ = {k: n - before_[k] for k, n in _build.launches.items()}
            info_ = {"epoch_s": time.perf_counter() - t0_, "collective_s": mesh1.collective_s - c0_,
                     "launches": per_, "metrics": {k: float(v) for k, v in m_.items()}}
            if per_ != want_epoch:
                fail(f"dp_world1 {label}: launches {per_}, expected {want_epoch}")
            if not all(math.isfinite(v) for v in info_["metrics"].values()):
                fail(f"dp_world1 {label}: non-finite metrics {info_['metrics']}")
            return env_, agent_, ts_, info_

        def dp_against_plain(env_, agent_, state_, data, rms_of, lr):
            """The DP update and the plain one from copies of state_ and the
            same generator state; update_diff of the two."""
            base_ = copy.deepcopy(dataclasses.replace(state_, env_state=None))
            start_ = [p_.detach().clone() for p_ in base_.network.parameters()]
            g_state = agent_.generator.get_state()
            dp_s, dp_m = agent_.update(copy.deepcopy(base_), *data)
            env_.mesh = None
            agent_.generator.set_state(g_state)
            try:
                pl_s, pl_m = agent_.update(copy.deepcopy(base_), *data)
            finally:
                env_.mesh = mesh1
            diff_ = dpr.update_diff(dp_s.network, pl_s.network, list(zip(rms_of(dp_s), rms_of(pl_s))), dp_m, pl_m,
                                    start=start_)
            diff_["params_over_lr"] = diff_["params"] / lr
            return diff_

        w1_reset = dict(_build.launches)
        env_w, amp_w, ts_w, amp_info = world1_epoch("amp", ["env=im", "learning=im_amp"],
                                                    ("step_reward_amp", "observe"))
        pag_w = amp_w.ppo
        pts_w, roll_w, last_w = pag_w.rollout(ts_w.ppo)
        adv_w, ret_w = compute_gae(pag_w.config, roll_w, last_w)
        amp_info["dp_vs_plain"] = dp_against_plain(env_w, pag_w, pts_w, (roll_w, adv_w, ret_w),
                                                   lambda t_: (t_.obs_rms, t_.value_rms),
                                                   pag_w.config.learning_rate)
        del env_w, amp_w, ts_w, pts_w, roll_w, pag_w
        denv_w, dag_w, ds_w, dist_info = world1_epoch("distill", ["env=im_vae", "learning=im_z_fit"],
                                                      ("physics_step", "reward_amp", "observe"))
        ds_w, droll_w = dag_w.rollout(ds_w)
        dist_info["dp_vs_plain"] = dp_against_plain(denv_w, dag_w, ds_w, (droll_w,), lambda t_: (t_.obs_rms,),
                                                    dag_w.config.kin_lr)
        del denv_w, dag_w, ds_w, droll_w
        _sync(dev)
        w1_launches = {k: n - w1_reset[k] for k, n in _build.launches.items()}
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(dp_tmp, ignore_errors=True)
    w1_info = {"phase": "dp_world1", "card": card, "envs": n_envs, "backend": backend, "world_size": 1,
               "amp": amp_info, "distill": dist_info, "launches": w1_launches, "tol": DP_WORLD1_TOL,
               "seconds": time.perf_counter() - t_dp}
    emit(w1_info)
    for label_, info_ in (("amp", amp_info), ("distill", dist_info)):
        d_ = info_["dp_vs_plain"]
        bad_ = {k: d_[k] for k in DP_WORLD1_TOL if not d_[k] <= DP_WORLD1_TOL[k]}
        if bad_:
            fail(f"dp_world1 {label_}: the DP update against the plain one beyond {DP_WORLD1_TOL}: {bad_}")
    return w1_info


def dp_two_ranks(device: str, n_envs: int, card: str) -> dict:
    """`python -m pulse_tpu_torch.parallel.dryrun`'s DP_RANKS ranks over gloo,
    n_envs / DP_RANKS envs each, on `device` ("cuda": the one card, which
    NCCL refuses to two ranks); its gates (every rank exits 0, the digests
    agree, launches exact on the card, K3's rows bit-equal, the one-minibatch
    update within dryrun.ONE_MB_TOL). Emits and returns the phase's record,
    its launches summed over the ranks; fail()s if a rank failed."""
    import tempfile

    from pulse_tpu_torch import _build
    from pulse_tpu_torch.parallel import dryrun as dpr

    print("dp_two_ranks: NCCL refuses two ranks on one device, so the two ranks share the card over gloo",
          flush=True)
    t_dp2 = time.perf_counter()
    dp2_out = tempfile.mkdtemp(prefix="dp_two_ranks_")
    try:
        dpr.wait_ranks(dpr.start_ranks(DP_RANKS, "gloo", device, dp2_out, ["--num_envs", str(n_envs)]),
                       timeout_s=DP_RANKS_TIMEOUT_S)
        dp2_results = [json.load(open(os.path.join(dp2_out, f"rank{r_}.json"))) for r_ in range(DP_RANKS)]
        dp2_stages = dpr.check_ranks(dp2_results)
    except Exception as exc:   # a rank failed, outlasted its time or the ranks disagree
        fail(f"dp_two_ranks: {exc}")
    finally:
        shutil.rmtree(dp2_out, ignore_errors=True)
    dp2_launches = {k: sum(rec["launches"][k] for recs in dp2_stages.values() for rec in recs)
                    for k in _build.launches}
    dp2_info = {"phase": "dp_two_ranks", "card": card, "backend": "gloo", "ranks": DP_RANKS, "envs": n_envs,
                "envs_per_rank": n_envs // DP_RANKS, "seconds": time.perf_counter() - t_dp2, "launches": dp2_launches,
                "replicated_state_bit_identical": True, "ppo_one_minibatch_tol": dpr.ONE_MB_TOL,
                "stages": {st_: [{k: v for k, v in rec.items() if k not in ("digest", "result_digest")}
                                 for rec in recs] for st_, recs in dp2_stages.items()}}
    for st_ in ("amp", "distill"):   # each rank's
        dp2_info[f"{st_}_collective_ms_per_gradient_step"] = [1e3 * rec["collective_s"] / rec["gradient_steps"]
                                                              for rec in dp2_stages[st_]]
    emit(dp2_info)
    return dp2_info


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
    from pulse_tpu_torch.physics import substep_cuda
    from pulse_tpu_torch.physics.model import BATCHED_LEAVES, PhysicsConfig, build_model
    from pulse_tpu_torch.physics.shape_variation import vary_model_scales
    from pulse_tpu_torch.physics.step import physics_step

    GROUP = substep_cuda.GROUP
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
    lib = _build.load()
    build_s = time.perf_counter() - t0

    def geometry(info_fn, *args) -> dict:
        info = (ctypes.c_int * 4)()
        _build.check(info_fn(*args, info), "kernel info")
        return {"threads_per_block": info[0], "envs_per_block": info[1], "shared_bytes_per_block": info[2],
                "blocks_per_sm": info[3]}

    work = int(lib.k3_work_bytes())
    emit({"phase": "build", "seconds": round(build_s, 2), **_build.build_report, "group": GROUP,
          "shared_bytes_per_env": {"K1": work, "K3": work, "K3rows": work + 4 * 13 * substep_cuda.MAX_J},
          "geometry": {g_: {"K1": geometry(lib.k1_kernel_info, g_), "K3": geometry(lib.k3_kernel_info, g_, 0),
                            "K3rows": geometry(lib.k3_kernel_info, g_, 1)} for g_ in substep_cuda.BUILT_GROUPS}})

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
    t = env._motion_time(state.motion_id, state.start_time, state.progress + 1)
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
        # K3 on the same inputs, against the plain physics (p1's) and K1's;
        # RA on K3's stepped state, against the plain epilogue and K1's
        k3 = substep_cuda.physics_step_cuda(model, state.physics, pd)
        ra = cuda_obs.reward_amp(e, k3, ref)
        pra = cuda_obs.reward_amp_plain(e, k3, ref)
        # K3-rows on a scale-varied model against the batched plain step,
        # and on the shared model's rows against K3
        bm = vary_model_scales(model, N_ENVS, (0.9, 1.1), generator=torch.Generator(device=dev).manual_seed(2))
        bm_rows = substep_cuda.build_model_rows(bm, N_ENVS)
        k3r = substep_cuda.physics_step_cuda(model, state.physics, pd, model_rows=bm_rows)
        p3r = physics_step(bm, state.physics, pd)
        k3r_shared = substep_cuda.physics_step_cuda(model, state.physics, pd,
                                                    model_rows=substep_cuda.build_model_rows(model, N_ENVS))
        # a ragged batch of RAGGED envs (the last block part-filled) against
        # the full batch's first RAGGED, bit for bit; then K1 and K3 raw into
        # buffers one block longer, whose rows past the batch must stay NaN
        st_r, ref_r = env_slice((state.physics, ref), 0, RAGGED)
        rag1 = cuda_obs.step_reward_amp(model, e, st_r, pd[:RAGGED], ref_r)
        rag3 = substep_cuda.physics_step_cuda(model, st_r, pd[:RAGGED])
        rag3r = substep_cuda.physics_step_cuda(model, st_r, pd[:RAGGED], model_rows=bm_rows[:RAGGED])
        # RA on K3's first RAGGED envs (joint_rot and joint_omega views into
        # K3's rows), K2 on K1's; then both raw into buffers one block
        # longer, whose rows past the batch must stay NaN
        k3_r, k1_r, ref_next_r = env_slice((k3, k1[0], ref_next), 0, RAGGED)
        rag_ra = cuda_obs.reward_amp(e, k3_r, ref_r)
        rag2 = cuda_obs.observe(e, k1_r, ref_next_r)
        pad_ra = cuda_obs.ra_outputs(RAGGED + 8, env.amp_obs_dim_single, dev)
        pad2 = torch.full((RAGGED + 8, env.obs_dim), float("nan"), device=dev)
        for t_ in pad_ra:
            t_.fill_(float("nan"))
        cuda_obs.launch_reward_amp(e, k3_r, ref_r, tuple(t_[:RAGGED] for t_ in pad_ra))
        cuda_obs.launch_observe(e, k1_r, ref_next_r, pad2[:RAGGED], cuda_obs.self_obs_dim(model.num_bodies,
                                                                                          e.root_height_obs))
        k3_parts = [st_r.root_pos, st_r.root_rot, st_r.joint_rot, st_r.root_vel6, st_r.joint_omega, pd[:RAGGED]]
        n_k1_out = 174 + 16 * model.num_bodies + cuda_obs.RA_ROWS + env.amp_obs_dim_single
        pad1 = torch.full((RAGGED + 8, n_k1_out), float("nan"), device=dev)
        pad3 = torch.full((RAGGED + 8, 174 + 16 * model.num_bodies), float("nan"), device=dev)
        stream0 = torch.cuda.current_stream().cuda_stream
        _build.check(lib.k1_step_reward_amp(substep_cuda.env_block(k3_parts + cuda_obs._bodies(ref_r), RAGGED, 555)
                                            .data_ptr(), pad1.data_ptr(), RAGGED, n_k1_out, GROUP, stream0), "K1")
        _build.check(lib.k3_physics_step(substep_cuda.env_block(k3_parts, RAGGED, 243).data_ptr(), pad3.data_ptr(),
                                         RAGGED, GROUP, stream0), "K3")
    torch.cuda.synchronize()
    ragged = {"K1": max(float((getattr(rag1[0], f) - getattr(k1[0], f)[:RAGGED]).abs().max()) for f in PHYS_FIELDS),
              "K1_epilogue": max(float((a - b[:RAGGED]).abs().max()) for a, b in zip(rag1[1:], k1[1:])),
              "K3": max(float((getattr(rag3, f) - getattr(k3, f)[:RAGGED]).abs().max()) for f in PHYS_FIELDS),
              "K3rows": max(float((getattr(rag3r, f) - getattr(k3r, f)[:RAGGED]).abs().max()) for f in PHYS_FIELDS),
              "RA": max(float((a - b[:RAGGED]).abs().max()) for a, b in zip(rag_ra, ra)),
              "RA_raw_launch": max(float((a[:RAGGED] - b[:RAGGED]).abs().max()) for a, b in zip(pad_ra, ra)),
              "K2": float((rag2 - k2[:RAGGED]).abs().max()),
              "K2_raw_launch": float((pad2[:RAGGED] - k2[:RAGGED]).abs().max()),
              "K1_rows_past_batch_untouched": bool(torch.isnan(pad1[RAGGED:]).all()),
              "K3_rows_past_batch_untouched": bool(torch.isnan(pad3[RAGGED:]).all()),
              "RA_rows_past_batch_untouched": all(bool(torch.isnan(t_[RAGGED:]).all()) for t_ in pad_ra),
              "K2_rows_past_batch_untouched": bool(torch.isnan(pad2[RAGGED:]).all())}
    kin_phys, kin_pd, kin_ref = state.physics, pd, ref   # K3's and RA's timing inputs
    names = ("reward", "reward_raw", "dist_mean", "dist_max", "amp")
    phys = PHYS_FIELDS
    k1_cmp = {f: compare(getattr(k1[0], f), getattr(p1[0], f), K1_TOL[f], N_ENVS) for f in phys}
    k1_cmp.update({n: compare(a, b, K1_TOL[n], N_ENVS) for n, a, b in zip(names, k1[1:], p1[1:])})
    epi_cmp = {n: compare(a, b, K1_TOL[n], N_ENVS) for n, a, b in zip(names, k1[1:], ep)}
    k2_cmp = compare(k2, p2, K2_TOL, N_ENVS)
    k3_cmp = {f: compare(getattr(k3, f), getattr(p1[0], f), K1_TOL[f], N_ENVS) for f in phys}
    ra_cmp = {n: compare(a, b, K1_TOL[n], N_ENVS) for n, a, b in zip(names, ra, pra)}
    k3ra_vs_k1 = {f: compare(getattr(k3, f), getattr(k1[0], f), K1_TOL[f], N_ENVS) for f in phys}
    k3ra_vs_k1.update({n: compare(a, b, K1_TOL[n], N_ENVS) for n, a, b in zip(names, ra, k1[1:])})
    k3r_cmp = {f: compare(getattr(k3r, f), getattr(p3r, f), K1_TOL[f], N_ENVS) for f in phys}
    k3r_shared_cmp = {f: compare(getattr(k3r_shared, f), getattr(k3, f), K1_TOL[f], N_ENVS) for f in phys}
    in_contact = int((k1[0].contact_force.abs().amax(dim=(1, 2)) > 1.0).sum())
    in_contact_rows = int((p3r.contact_force.abs().amax(dim=(1, 2)) > 1.0).sum())
    max_err = {"step_reward_amp": max(c["max"] for c in k1_cmp.values()), "observe": k2_cmp["max"],
               "physics_step": max(c["max"] for c in k3_cmp.values()),
               "physics_step_rows": max(c["max"] for c in k3r_cmp.values()),
               "reward_amp": max(c["max"] for c in ra_cmp.values())}
    emit({"phase": "kernels", "envs": N_ENVS, "envs_in_contact": in_contact, "K1_vs_plain": k1_cmp,
          "K1_epilogue_on_kernel_state": epi_cmp, "K2_vs_plain": k2_cmp, "K3_vs_plain": k3_cmp,
          "RA_vs_plain_on_K3_state": ra_cmp, "K3_RA_vs_K1": k3ra_vs_k1,
          "K3_RA_vs_K1_max_abs_diff": max(c["max"] for c in k3ra_vs_k1.values()),
          "K3rows_vs_plain_scaled_model": k3r_cmp, "envs_in_contact_scaled_model": in_contact_rows,
          "body_scale_range": [float(bm.total_mass.min() / model.total_mass) ** (1 / 3),
                               float(bm.total_mass.max() / model.total_mass) ** (1 / 3)],
          "K3rows_shared_rows_vs_K3": k3r_shared_cmp, f"ragged_{RAGGED}_envs_vs_full_batch": ragged})
    allowed = int(OUTLIER_FRAC * N_ENVS)
    for label, cmps, limit in (("K1", k1_cmp, allowed), ("K1 epilogue", epi_cmp, 0), ("K3", k3_cmp, allowed),
                               ("RA", ra_cmp, 0), ("K3 -> RA vs K1", k3ra_vs_k1, 0),
                               ("K3-rows scaled model", k3r_cmp, allowed),
                               ("K3-rows shared rows vs K3", k3r_shared_cmp, allowed)):
        for name, c in cmps.items():
            if not c["outlier_envs"] <= limit:
                fail(f"{label} {name}: {c['outlier_envs']} envs beyond {c['tol']} (max {c['max']})")
    if k2_cmp["outlier_envs"]:
        fail(f"K2: {k2_cmp['outlier_envs']} envs beyond {K2_TOL} (max {k2_cmp['max']})")
    if in_contact == 0 or in_contact_rows == 0:
        fail("no env in ground contact: the contact path was not exercised")
    untouched = all(v for k, v in ragged.items() if k.endswith("untouched"))
    if not untouched or any(v != 0.0 for k, v in ragged.items() if not k.endswith("untouched")):
        fail(f"a ragged batch differs from the full one or writes past its end: {ragged}")

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
        _build.reset_launch_counts()
        resets, rewards = 0, []
        t0 = time.perf_counter()
        for _ in range(HORIZON):
            state = act(state)
            resets += state.done.sum()
            rewards.append(state.reward)
        torch.cuda.synchronize()
        policy_s = time.perf_counter() - t0
        launches = dict(_build.launches)
    rewards = torch.stack(rewards)
    resets = int(resets)
    slice_info = {"phase": "slice", "envs": N_ENVS, "steps": HORIZON, "launches": launches,
                  "auto_resets": resets, "reward_mean": float(rewards.mean()),
                  "reward_min": float(rewards.min()), "reward_max": float(rewards.max()),
                  "obs_dim": env.obs_dim, "amp_obs_dim": env.amp_obs_dim,
                  "obs_finite": bool(torch.isfinite(state.obs).all()),
                  "reward_finite": bool(torch.isfinite(rewards).all())}
    emit(slice_info)
    want = {"step_reward_amp": HORIZON, "observe": HORIZON, "physics_step": 0, "physics_step_rows": 0,
            "reward_amp": 0}
    if launches != want:
        fail(f"launches {launches} in {HORIZON} env steps, expected {want}")
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

        # raw kernel launches on prepared buffers, K1's env-major record,
        # K2's inputs in place (the wrappers' counts are untouched: these
        # are measurement launches)
        stream = torch.cuda.current_stream().cuda_stream
        ph = state.physics
        J, Jm1 = model.num_bodies, model.num_joints
        x1 = substep_cuda.env_block([ph.root_pos, ph.root_rot, ph.joint_rot, ph.root_vel6, ph.joint_omega, pd]
                                    + cuda_obs._bodies(ref), N_ENVS, 174 + 69 + 13 * J)
        n_amp = cuda_obs.amp_obs_dim(J, len(e.key_ids), e.amp_v, e.root_height_obs)
        n_out1 = 174 + 16 * J + 7 + n_amp
        o1, o1_one = torch.empty(N_ENVS, n_out1, device=dev), torch.empty(N_ENVS, n_out1, device=dev)
        o2 = torch.empty(N_ENVS, env.obs_dim, device=dev)
        n_self = cuda_obs.self_obs_dim(J, e.root_height_obs)

        def k1_launch(group, out=o1, x=x1, n=N_ENVS):
            return lambda: _build.check(lib.k1_step_reward_amp(x.data_ptr(), out.data_ptr(), n, n_out1, group,
                                                               stream), "K1")

        k1_launch(1, o1_one)()
        k1_launch(GROUP)()
        k1_one_vs_group = float((o1 - o1_one).abs().max())
        k1_ms_one, k1_ms_group = in_turns(lambda: cuda_ms(k1_launch(1), 20), lambda: cuda_ms(k1_launch(GROUP), 20))
        k1_ms = sum(k1_ms_group) / 2
        k2_args, k2_ins = cuda_obs.observe_args(e, ph, ref, o2, n_self)
        k2_ms = cuda_ms(lambda: _build.check(lib.k2_observe(*k2_args, stream), "K2"), 100)
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
        4.0 * N_ENVS * (x1.shape[1] + o1.shape[1]),
        N_ENVS * k1_ops_per_env(J, int(model.cp_body.shape[0]), model.config.steps_per_control,
                                len(e.reset_ids), len(e.key_ids), e.amp_v))
    k2_bytes = 4.0 * N_ENVS * (26 * J + o2.shape[1])
    k2_bound, k2_by = bound_ms(k2_bytes, N_ENVS * k2_ops_per_env(J))
    emit({"phase": "timing", "card": card, "envs": N_ENVS,
          "env_steps_per_s_policy": median(steps_per_s(policy_windows)),
          "env_steps_per_s_random_actions": median(steps_per_s(random_windows)),
          "env_steps_per_s_policy_windows": steps_per_s(policy_windows),
          "env_steps_per_s_random_windows": steps_per_s(random_windows),
          "step_ms_policy": step_ms_policy, "step_ms_random_actions": 1e3 * median(random_windows) / HORIZON,
          "K1_ms": k1_ms, f"K1_ms_G{GROUP}_turns": k1_ms_group, "K1_ms_G1_turns": k1_ms_one,
          f"K1_max_abs_diff_G{GROUP}_vs_G1": k1_one_vs_group, "K2_ms": k2_ms,
          "K1_wrapper_ms": k1_wrap_ms, "K2_wrapper_ms": k2_wrap_ms,
          "device_kernels_per_step": kernels_per_step, "device_busy_ms_per_step": device_ms_per_step,
          "device_idle_share": (1.0 - device_ms_per_step / step_ms_policy) if device_ms_per_step else None,
          "K1_plain_ms": k1_plain_ms, "K2_plain_ms": k2_plain_ms,
          "kernels_share_of_policy_step": (k1_ms + k2_ms) / step_ms_policy,
          "K1_ops_per_env": k1_ops_per_env(J, int(model.cp_body.shape[0]), model.config.steps_per_control,
                                           len(e.reset_ids), len(e.key_ids), e.amp_v),
          "K2_ops_per_env": k2_ops_per_env(J)})

    # ---- general: the env's general step against the kernel path ------------ #
    # On env=im's config, from one state and with the env's generator
    # re-seeded before each, `_step_general` (K3, then the reward, the
    # distances, the AMP row and the observation in plain PyTorch) and `step`
    # (K1, then K2) must take the same step. Then every option of the general
    # path acts GENERAL_STEPS steps on a config of its own
    def one_step(step_fn, st, actions):
        """(the stepped state, the launches) of one step from the env's
        generator seeded afresh."""
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        env.generator.manual_seed(11)
        out = step_fn(st, actions)
        torch.cuda.synchronize()
        return out, dict(_build.launches)

    with torch.no_grad():
        st0 = st_p
        actions = torch.clamp(policy_step(net, st0.obs, g, obs_rms=obs_rms)[0], -1.0, 1.0)
        gen, gen_launches = one_step(env._step_general, st0, actions)
        ker, ker_launches = one_step(env.step, st0, actions)
        # the mean reset-body distance of the stepped state (a measurement launch)
        _, ref1 = env._post_step_ref(st0, st0.progress + 1)
        phys1 = substep_cuda.physics_step_cuda(model, st0.physics, env.action_to_pd_target(actions))
        rid = list(e.reset_ids)
        dmean = torch.linalg.vector_norm(phys1.body_pos[:, rid] - ref1["rg_pos"][:, rid], dim=-1).mean(dim=-1)
    on_edge = (dmean - env.config.termination_distance).abs() <= GENERAL_EDGE
    gen_cmp = {f: compare(getattr(gen, f), getattr(ker, f), tol, N_ENVS) for f, tol in GENERAL_TOL.items()}
    flags = {f: {"envs_differ": int((getattr(gen, f) != getattr(ker, f)).sum()),
                 "envs_differ_off_edge": int(((getattr(gen, f) != getattr(ker, f)) & ~on_edge).sum())}
             for f in ("done", "terminate")}
    same_resets = all(torch.equal(getattr(gen, f), getattr(ker, f)) for f in ("motion_id", "start_time", "progress"))
    general_info = {"phase": "general", "envs": N_ENVS, "vs_kernel_path": gen_cmp, "flags": flags,
                    "envs_on_edge": int(on_edge.sum()), "resets": int(ker.done.sum()),
                    "terminations": int(ker.terminate.sum()), "same_resets": same_resets,
                    "launches_general": gen_launches, "launches_kernel": ker_launches}
    want_gen = {"step_reward_amp": 0, "observe": 0, "physics_step": 1, "physics_step_rows": 0, "reward_amp": 0}
    want_ker = {"step_reward_amp": 1, "observe": 1, "physics_step": 0, "physics_step_rows": 0, "reward_amp": 0}
    if gen_launches != want_gen or ker_launches != want_ker:
        fail(f"general: launches {gen_launches} (expected {want_gen}) and {ker_launches} (expected {want_ker})")
    for name, c in gen_cmp.items():
        if c["outlier_envs"]:
            fail(f"general vs kernel path {name}: {c['outlier_envs']} envs beyond {c['tol']} (max {c['max']})")
    if any(v["envs_differ_off_edge"] for v in flags.values()) or not same_resets or not int(ker.done.sum()):
        fail(f"general vs kernel path: flags {flags}, same resets {same_resets}, {int(ker.done.sum())} resets")
    del gen, ker, st0, phys1

    # every option of the general path (and those that ride the kernels):
    # (name, EnvConfig overrides, obs width)
    general_options = [
        ("obs_v7_T3", dict(obs_v=7, num_traj_samples=3), 358 + 3 * 24 * 9),
        ("obs_v8_T3", dict(obs_v=8, num_traj_samples=3), 358 + 24 * 15 + 3 * 24 * 15),
        ("obs_v9_T3", dict(obs_v=9, num_traj_samples=3), 358 + 3 * (24 * 18 + 6)),
        ("self_obs_v2", dict(self_obs_v=2), 5 * 358 + 576),
        ("self_obs_v3", dict(self_obs_v=3), 370 + 576),
        ("zero_out_far", dict(zero_out_far=True), 934),
        ("occlusion_0.5", dict(occlusion_prob=0.5), 934),
        ("noise_0.05", dict(obs_noise_std=0.05), 934),
        ("state_init_Start", dict(state_init="Start"), 934),
        ("state_init_Hybrid", dict(state_init="Hybrid"), 934),
    ]
    n_far = N_ENVS // 4
    options_info = {}
    for name, kw, width in general_options:
        oenv = HumanoidImEnv(model, motion, EnvConfig(**kw), device=dev, seed=0)
        onet = ActorCritic(oenv.obs_dim, oenv.action_dim, device=dev, seed=0)
        orms = RunningMeanStd.create(oenv.obs_dim, device=dev)
        with torch.no_grad():
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            ost = oenv.reset(N_ENVS)
            start_at_zero = float((ost.start_time == 0).float().mean())
            if oenv.config.zero_out_far:   # the first quarter of the envs 10 m away
                shift = torch.zeros(N_ENVS, 3, device=dev)
                shift[:n_far, 0] = 10.0
                ost = ost.replace(physics=ost.physics.replace(root_pos=ost.physics.root_pos + shift,
                                                              body_pos=ost.physics.body_pos + shift[:, None]))
            rewards = []
            for i in range(GENERAL_STEPS):
                ost = oenv.step(ost, torch.clamp(policy_step(onet, ost.obs, g, obs_rms=orms)[0], -1.0, 1.0))
                rewards.append(ost.reward)
                if i == 0:
                    first = ost
            torch.cuda.synchronize()
            o_launches = dict(_build.launches)
        rewards = torch.stack(rewards)
        kernel_path = oenv._kernel_surface()
        want_o = ({"step_reward_amp": GENERAL_STEPS, "observe": GENERAL_STEPS + 1, "physics_step": 0,
                   "physics_step_rows": 0, "reward_amp": 0} if kernel_path else
                  {"step_reward_amp": 0, "observe": 0, "physics_step": GENERAL_STEPS, "physics_step_rows": 0,
                   "reward_amp": 0})
        task = ost.obs[:, oenv.self_obs_dim:]
        o = {"obs_dim": oenv.obs_dim, "kernel_path": kernel_path, "launches": o_launches,
             "obs_finite": bool(torch.isfinite(ost.obs).all()), "reward_mean": float(rewards.mean()),
             "resets": int(ost.done.sum()), "reset_start_time_zero_share": start_at_zero}
        checks = [oenv.obs_dim == width, ost.obs.shape == (N_ENVS, width), o["obs_finite"], o_launches == want_o]
        if name == "self_obs_v2":
            checks.append(torch.equal(ost.obs[:, :oenv.self_obs_dim], ost.self_obs_hist.flatten(1)))
        if name == "zero_out_far":
            kept = ~first.done[:n_far]
            far_task = first.obs[:n_far, oenv.self_obs_dim:][kept]
            o.update(far_envs_kept=int(kept.sum()), far_terminated=int(first.terminate[:n_far].sum()),
                     far_reward_max=float(first.reward[:n_far][kept].max()),
                     far_goal_m_min=float(far_task[:, :3].norm(dim=-1).min()))
            checks += [o["far_envs_kept"] > 0, o["far_terminated"] == 0, o["far_reward_max"] < 1e-3,
                       bool((far_task[:, 3:] == 0).all()), o["far_goal_m_min"] > 9.0]
        if name == "occlusion_0.5":
            width_occ = max(int(oenv.task_obs_dim * oenv.config.occlusion_frac), 1)
            o["occluded_share"] = float(((task == 0).sum(dim=1) >= width_occ).float().mean())
            checks.append(0.4 < o["occluded_share"] < 0.6)
        if name == "state_init_Start":
            checks.append(start_at_zero == 1.0)
        if name == "state_init_Hybrid":
            checks.append(0.4 < start_at_zero < 0.6)
        options_info[name] = o
        if not all(checks):
            fail(f"general option {name}: {o} (width expected {width}, launches {want_o})")
        del oenv, onet, orms, ost, first
    general_info["options"] = options_info
    emit(general_info)

    # ---- training through the CLI's entry point ------------------------------ #
    from pulse_tpu_torch import run
    from pulse_tpu_torch.env.humanoid_im_getup import GetupConfig, fall_drop_start, ragdoll
    from pulse_tpu_torch.learning.amp_agent import AMPAgent
    from pulse_tpu_torch.learning.ppo import PPOAgent, compute_gae

    def device_busy(fn) -> tuple:
        """(device-busy ms, device kernels) of fn() under the profiler."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_:
            fn()
            torch.cuda.synchronize()
        kern_ = [ev for ev in prof_.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
        return sum(ev.time_range.elapsed_us() for ev in kern_) / 1e3, len(kern_)

    out_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "output", "chip_smoke")
    per_epoch = HORIZON * N_ENVS

    def train(exp: str, env_args: list, want_epoch: dict, learning: str = "im_ppo", epochs: int = TRAIN_EPOCHS,
              on_epoch=None, trace_rollout: bool = True, device_trace: bool = True) -> tuple:
        """run.main for `epochs` epochs; returns (result, the run's launch
        counts, its info dict) after the checks every training path shares.
        `on_epoch(agent, (ts, metrics))` runs after each epoch of an AMP
        agent. For AMP the PPO checks read the train state's PPO half; the
        rewards checked in [0, 1] are the env's (the task reward). Without
        `trace_rollout` the rollout's device time is one env step's trace
        times HORIZON (for the eager plain-route steps of ~20k kernels a
        32-step trace would hold ~700k events and take minutes). Without
        `device_trace` no device time is read (a phase gated on its route
        and launches alone)."""
        epoch_launches = []
        ppo_epoch, amp_epoch = PPOAgent.train_epoch, AMPAgent.train_epoch

        def counted(real, hook):
            def counted_epoch(agent, ts):   # each epoch's launches, read around the trainer's own epoch
                before = dict(_build.launches)
                out = real(agent, ts)
                epoch_launches.append({k: n - before[k] for k, n in _build.launches.items()})
                if hook is not None:
                    hook(agent, out)
                return out
            return counted_epoch

        torch.cuda.synchronize()
        _build.reset_launch_counts()
        PPOAgent.train_epoch, AMPAgent.train_epoch = counted(ppo_epoch, None), counted(amp_epoch, on_epoch)
        t0 = time.perf_counter()
        try:
            res = run.main([*env_args, f"learning={learning}", f"num_envs={N_ENVS}", f"max_epochs={epochs}",
                            "log_frequency=1", "device=cuda", f"output_dir={out_root}", f"exp_name={exp}"])
        finally:
            PPOAgent.train_epoch, AMPAgent.train_epoch = ppo_epoch, amp_epoch
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(_build.launches)
        ms = res.metrics
        ts = getattr(res.train_state, "ppo", res.train_state)
        pagent = getattr(res.agent, "ppo", res.agent)
        # main's network before training: the same seed and widths
        units = {t: [m_.out_features for m_ in getattr(ts.network, t) if isinstance(m_, torch.nn.Linear)]
                 for t in ("actor", "critic")}
        fresh = ActorCritic(res.agent.env.obs_dim, res.agent.env.action_dim, actor_units=units["actor"],
                            critic_units=units["critic"], device=dev, seed=0).state_dict()
        changed = [k for k, v in ts.network.state_dict().items() if not torch.equal(v, fresh[k])]
        timed = ms[1:] or ms      # the first epoch's times hold the warm-up, unless it is the only one
        epoch_s = [sum(v for k, v in m.items() if k.endswith("_s")) for m in timed]
        rewards = pagent._buffers.rewards
        info = {"phase": exp, "card": card, "envs": N_ENVS, "epochs": len(ms), "seconds_all": seconds,
                "launches": counts, "launches_per_epoch": epoch_launches,
                "losses": [{k: m[k] for k in ("a_loss", "c_loss", "b_loss")} for m in ms],
                "reward_mean": [m["reward_mean"] for m in ms], "episode_done_frac": [m["episode_done_frac"] for m in ms],
                "obs_rms_count": float(ts.obs_rms.count), "params_changed": len(changed),
                "rollout_ms": [1e3 * m["rollout_s"] for m in timed], "gae_ms": [1e3 * m["gae_s"] for m in timed],
                "update_ms": [1e3 * m["update_s"] for m in timed],
                "train_env_steps_per_s": [per_epoch / s_ for s_ in epoch_s],
                "rollout_env_steps_per_s": [per_epoch / m["rollout_s"] for m in timed],
                "reward_min": float(rewards.min()), "reward_max": float(rewards.max()),
                "obs_finite": bool(torch.isfinite(ts.env_state.obs).all())}
        if not all(math.isfinite(v) for m in info["losses"] for v in m.values()):
            fail(f"{exp}: non-finite loss {info['losses']}")
        if not changed:
            fail(f"{exp}: no parameter changed in {len(ms)} epochs")
        if abs(info["obs_rms_count"] - len(ms) * per_epoch) > 1.0:
            fail(f"{exp}: obs_rms.count {info['obs_rms_count']}, expected {len(ms) * per_epoch}")
        if len(epoch_launches) != len(ms) or any(el != want_epoch for el in epoch_launches):
            fail(f"{exp}: launches per epoch {epoch_launches}, expected {want_epoch}")
        if not (0.0 <= info["reward_min"] and info["reward_max"] <= 1.0 and info["obs_finite"]):
            fail(f"{exp}: reward outside [0, 1] or non-finite obs")
        # device time of one more rollout, GAE and update, from a profiler
        # trace (after the checks; the profiler slows the host, so the idle
        # share is taken against the unprofiled phase times above)
        agent = pagent
        if not device_trace:
            return res, counts, info
        if trace_rollout:
            roll_busy, roll_kernels = device_busy(lambda: agent.rollout(ts))
        else:
            act_ = torch.zeros(N_ENVS, agent.env.action_dim, device=dev)
            with torch.no_grad():
                step_busy, step_kernels = device_busy(lambda: agent.env.step(ts.env_state, act_))
            roll_busy, roll_kernels = HORIZON * step_busy, HORIZON * step_kernels
            info.update(rollout_device_from_one_step=True, step_device_busy_ms=step_busy,
                        step_device_kernels=step_kernels)
        last_v = agent._value(ts, ts.env_state.obs).detach()
        gae_busy, gae_kernels = device_busy(lambda: compute_gae(agent.config, agent._buffers, last_v))
        adv, ret = compute_gae(agent.config, agent._buffers, last_v)
        upd_busy, upd_kernels = device_busy(lambda: agent.update(ts, agent._buffers, adv, ret))
        info.update(rollout_device_busy_ms=roll_busy, rollout_device_kernels=roll_kernels,
                    rollout_device_idle_share=1.0 - roll_busy / median(info["rollout_ms"]),
                    gae_device_busy_ms=gae_busy, gae_device_kernels=gae_kernels,
                    gae_device_idle_share=1.0 - gae_busy / median(info["gae_ms"]),
                    update_device_busy_ms=upd_busy, update_device_kernels=upd_kernels,
                    update_device_idle_share=1.0 - upd_busy / median(info["update_ms"]))
        return res, counts, info

    res, im_launches, info = train("train_im", ["env=im"], {"step_reward_amp": HORIZON, "observe": HORIZON,
                                                            "physics_step": 0, "physics_step_rows": 0,
                                                            "reward_amp": 0})
    emit(info)
    im_steps_per_s = info["train_env_steps_per_s"]
    im_rollout_ms, im_update_ms = info["rollout_ms"], info["update_ms"]

    # ---- eval: train_im's policy on the hard clips, then test=true ----------- #
    # im_eval of train_im's train state on the 6 hard clips at a batch of 6,
    # early termination off; then the CLI's test=true on train_im's own
    # checkpoint and clips. Each eval step launches K1 and K2 once, reset_to
    # one K2 (and test=true's agent.init one K2 at its reset)
    from pulse_tpu_torch.eval import im_eval
    from pulse_tpu_torch.motion.synthetic import make_hard_clips

    hard, hard_names = make_hard_clips(spec.skeleton)
    eval_env = HumanoidImEnv(model, build_motion_data(spec.skeleton, hard, device=dev),
                             EnvConfig(enable_early_termination=False), device=dev, seed=0)
    dt = model.config.control_dt

    def eval_checks(label, result, env_, batches, extra_k2) -> dict:
        lengths = env_.motion.motion_lengths.cpu()
        max_steps = math.ceil(float(lengths.max()) / dt)
        clock = torch.arange(1, max_steps + 1, dtype=torch.float32) * dt
        want_steps = (clock[None] < lengths[:, None]).sum(1).tolist()
        want_launches = {"step_reward_amp": batches * max_steps, "observe": batches * (max_steps + 1) + extra_k2,
                         "physics_step": 0, "physics_step_rows": 0, "reward_amp": 0}
        launches_ = dict(_build.launches)
        metrics = {k: getattr(result, k) for k in ("success_rate", "mpjpe_g", "mpjpe_l", "mpjpe_pa", "vel_dist",
                                                   "accel_dist")}
        if not all(math.isfinite(v) for v in metrics.values()):
            fail(f"{label}: non-finite metrics {metrics}")
        if result.per_motion_steps.tolist() != want_steps:
            fail(f"{label}: scored steps {result.per_motion_steps.tolist()}, expected {want_steps}")
        if launches_ != want_launches:
            fail(f"{label}: launches {launches_}, expected {want_launches}")
        return {"max_steps": max_steps, "launches": launches_, "per_motion_steps": want_steps, **metrics,
                "failed_motions": result.failed_motions.tolist()}

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    hard_result = im_eval(eval_env, run._policy_fn(res.train_state), batch_size=len(hard_names))
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    hard_info = eval_checks("eval hard clips", hard_result, eval_env, 1, 0)
    if run.latest_checkpoint(os.path.join(out_root, "train_im", "ckpt")) is None:
        fail("eval test=true: train_im left no checkpoint to restore")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    cli_result = run.main(["env=im", "learning=im_ppo", f"num_envs={N_ENVS}", "test=true", "epoch=-1", "device=cuda",
                           f"output_dir={out_root}", "exp_name=train_im"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_info = eval_checks("eval test=true", cli_result, res.agent.env, 1, 1)
    n_ev = len(hard_names)
    with torch.no_grad():
        ev_k2_args, _ = cuda_obs.observe_args(e, env_slice(ph, 0, n_ev), env_slice(ref, 0, n_ev), o2[:n_ev], n_self)
        ev_k1_ms = cuda_ms(k1_launch(GROUP, n=n_ev), 100)
        ev_k2_ms = cuda_ms(lambda: _build.check(lib.k2_observe(*ev_k2_args, stream), "K2"), 100)
    emit({"phase": "eval", "card": card, "clips": hard_names, "envs": n_ev, "seconds": eval_s, **hard_info,
          "per_motion_mpjpe_g": hard_result.per_motion_mpjpe_g.tolist(),
          f"K1_ms_{n_ev}_envs": ev_k1_ms, f"K2_ms_{n_ev}_envs": ev_k2_ms,
          "test_true": {"envs": N_ENVS, "clips": int(res.agent.env.motion.num_motions), "seconds": cli_s,
                        **cli_info}})
    del res, eval_env

    # ---- distill: PULSE stage 2 from train_im's checkpoint --------------------- #
    # run.main with env=im_vae learning=im_z_fit (the getup curriculum on a
    # cycled reference with the power reward; the reference-width PulseVAE;
    # train_im's policy as the frozen teacher). HumanoidImEnv.step is
    # wrapped to keep each step's (clip, start, progress) and its flags and
    # rewards, read after the run for the wrap and penalty gates
    from pulse_tpu_torch.learning.distill import DistillAgent
    from pulse_tpu_torch.learning.networks import PulseVAE

    teacher_dir = os.path.join(out_root, "train_im", "ckpt")
    teacher_sd = torch.load(run.latest_checkpoint(teacher_dir), map_location=dev, weights_only=True)["network"]
    steps_seen, epoch_launches = [], []
    env_step, distill_epoch = HumanoidImEnv.step, DistillAgent.train_epoch

    def recorded_step(self, st, actions):
        new = env_step(self, st, actions)
        steps_seen.append((st.motion_id, st.start_time, st.progress, new.done, new.reward, new.reward_raw))
        return new

    def counted_distill_epoch(agent, ds):
        before = dict(_build.launches)
        out = distill_epoch(agent, ds)
        epoch_launches.append({k: n - before[k] for k, n in _build.launches.items()})
        return out

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    HumanoidImEnv.step, DistillAgent.train_epoch = recorded_step, counted_distill_epoch
    t0 = time.perf_counter()
    try:
        res = run.main(["env=im_vae", "learning=im_z_fit", f"num_envs={N_ENVS}", f"max_epochs={DISTILL_EPOCHS}",
                        "log_frequency=1", "device=cuda", f"output_dir={out_root}", "exp_name=distill",
                        f"learning.teacher_checkpoint={teacher_dir}"])
    finally:
        HumanoidImEnv.step, DistillAgent.train_epoch = env_step, distill_epoch
    torch.cuda.synchronize()
    distill_s = time.perf_counter() - t0
    d_counts = dict(_build.launches)
    agent, ds, ms = res.agent, res.train_state, res.metrics
    denv, dcfg = agent.env, agent.env.config
    lc = agent.config
    d_mb = min(lc.minibatch_size, (HORIZON - 1) * N_ENVS)
    fresh = PulseVAE(denv.obs_dim, denv.action_dim, latent_dim=ds.network.latent_dim, self_obs_dim=denv.self_obs_dim,
                     device=dev, seed=0).state_dict()
    changed = {part: sum(not torch.equal(v, fresh[k]) for k, v in ds.network.state_dict().items()
                         if k.startswith(part + "."))
               for part in ("encoder", "prior", "decoder", "critic")}
    teacher_unchanged = all(torch.equal(v, teacher_sd[k]) for k, v in agent.teacher_fn.network.state_dict().items())
    # the wrap and penalty gates over every step of the run
    lengths, dt = denv.motion.motion_lengths, denv.model.config.control_dt
    wrapped, moved, moved_without_offset, penalty_over, penalized = 0, [], [], 0, 0
    w = torch.tensor([dcfg.w_pos, dcfg.w_rot, dcfg.w_vel, dcfg.w_ang_vel], device=dev)
    with torch.no_grad():
        for ids, start, p, done, reward, raw in steps_seen:
            L = lengths[ids]
            crossed = (torch.floor((start + (p + 1).float() * dt) / L) > torch.floor((start + p.float() * dt) / L))
            keep = crossed & ~done
            imitation = raw @ w
            penalty_over += int((reward > imitation + 1e-6).sum())
            penalized += int((reward < imitation).sum())
            if keep.any():
                wrapped += int(keep.sum())
                i_, s_, p_ = ids[keep], start[keep], p[keep]
                before = get_motion_state(denv.motion, i_, denv._motion_time(i_, s_, p_),
                                          denv._cycle_offset(i_, s_, p_))["root_pos"]
                t_after = denv._motion_time(i_, s_, p_ + 1)
                after = get_motion_state(denv.motion, i_, t_after, denv._cycle_offset(i_, s_, p_ + 1))["root_pos"]
                bare = get_motion_state(denv.motion, i_, t_after)["root_pos"]
                moved.append(float((after - before).norm(dim=-1).max()))
                moved_without_offset.append(float((bare - before).norm(dim=-1).min()))
    timed = ms[1:]
    info = {"phase": "distill", "card": card, "envs": N_ENVS, "epochs": len(ms), "seconds_all": distill_s,
            "launches": d_counts, "launches_per_epoch": epoch_launches,
            "bc_loss": [m["bc_loss"] for m in ms],
            "losses": [{k: m[k] for k in ("bc_loss", "kld", "ar1", "prior_reg", "kld_coef")} for m in ms],
            "reward_mean": [m["reward_mean"] for m in ms], "obs_rms_count": float(ds.obs_rms.count),
            "params_changed": changed, "teacher_unchanged": teacher_unchanged,
            "episode_length": dcfg.episode_length, "cycle_motion": dcfg.cycle_motion,
            "power_reward": dcfg.power_reward, "minibatch": d_mb,
            "minibatches_per_epoch": lc.mini_epochs * ((HORIZON - 1) * N_ENVS // d_mb),
            "wrapped_env_steps": wrapped, "wrap_ref_root_moved_max_m": max(moved, default=None),
            "wrap_ref_root_moved_without_offset_min_m": min(moved_without_offset, default=None),
            "reward_above_imitation_reward": penalty_over, "reward_below_imitation_reward": penalized,
            "rollout_ms": [1e3 * m["rollout_s"] for m in timed], "update_ms": [1e3 * m["update_s"] for m in timed],
            "train_env_steps_per_s": [per_epoch / (m["rollout_s"] + m["update_s"]) for m in timed],
            "obs_finite": bool(torch.isfinite(ds.env_state.obs).all())}
    settle = d_counts["physics_step"] - sum(el["physics_step"] for el in epoch_launches)
    want_d = {"step_reward_amp": 0, "observe": HORIZON, "physics_step": HORIZON, "physics_step_rows": 0,
              "reward_amp": HORIZON}
    if len(epoch_launches) != DISTILL_EPOCHS or any(el != want_d for el in epoch_launches):
        fail(f"distill: launches per epoch {epoch_launches}, expected {want_d}")
    if settle != denv.config.fall_settle_steps or d_counts["observe"] - DISTILL_EPOCHS * HORIZON != 1:
        fail(f"distill: {settle} K3 launches while building (expected {denv.config.fall_settle_steps}), "
             f"{d_counts['observe'] - DISTILL_EPOCHS * HORIZON} K2 outside the epochs (expected 1, the reset)")
    if not all(math.isfinite(v) for m in info["losses"] for v in m.values()):
        fail(f"distill: non-finite loss {info['losses']}")
    if not all(changed[part] for part in ("encoder", "prior", "decoder")) or changed["critic"]:
        fail(f"distill: parameters changed per part {changed}: expected the encoder, prior and decoder only")
    if not teacher_unchanged:
        fail("distill: the teacher's parameters changed")
    if abs(info["obs_rms_count"] - len(ms) * per_epoch) > 1.0:
        fail(f"distill: obs_rms.count {info['obs_rms_count']}, expected {len(ms) * per_epoch}")
    if not (dcfg.cycle_motion and dcfg.power_reward and isinstance(agent, DistillAgent)):
        fail("distill: not the im_vae / im_z_fit configuration")
    if wrapped == 0 or max(moved) >= 0.1:
        fail(f"distill: {wrapped} env steps wrapped a clip without a reset; reference root moved up to "
             f"{max(moved, default=None)} m on them (limit 0.1)")
    if penalty_over or not info["obs_finite"]:
        fail(f"distill: {penalty_over} env steps with a reward above the kernel's imitation reward, or non-finite obs")
    # RA and K2 against their plain versions on a cycled, offset reference:
    # the run's last state, a full clip or more ahead, so that every env's
    # reference is shifted
    with torch.no_grad():
        st = ds.env_state
        p_c = st.progress + 1 + math.ceil(float(lengths.max()) / dt)
        off_c = denv._cycle_offset(st.motion_id, st.start_time, p_c)
        ref_c = get_motion_state(denv.motion, st.motion_id, denv._motion_time(st.motion_id, st.start_time, p_c),
                                 off_c)
        pd_c = denv.action_to_pd_target(0.3 * torch.randn(N_ENVS, denv.action_dim, generator=g, device=dev))
        k3_c = substep_cuda.physics_step_cuda(denv.model, st.physics, pd_c)
        ra_c, pra_c = cuda_obs.reward_amp(denv.consts, k3_c, ref_c), cuda_obs.reward_amp_plain(denv.consts, k3_c, ref_c)
        k2_c, p2_c = cuda_obs.observe(denv.consts, k3_c, ref_c), cuda_obs.observe_plain(denv.consts, k3_c, ref_c)
    cyc_ra = {n: compare(a, b, K1_TOL[n], N_ENVS) for n, a, b in zip(names, ra_c, pra_c)}
    cyc_k2 = compare(k2_c, p2_c, K2_TOL, N_ENVS)
    info.update(cycled_ref={"envs_offset": int((off_c[:, :2].norm(dim=-1) > 0).sum()),
                            "offset_m_min": float(off_c[:, :2].norm(dim=-1).min()),
                            "RA_vs_plain": cyc_ra, "K2_vs_plain": cyc_k2})
    if info["cycled_ref"]["envs_offset"] != N_ENVS:
        fail(f"distill: only {info['cycled_ref']['envs_offset']} envs have a shifted reference")
    for name, c in list(cyc_ra.items()) + [("obs", cyc_k2)]:
        if c["outlier_envs"]:
            fail(f"distill: {'K2' if name == 'obs' else 'RA'} {name} on the cycled reference: {c['outlier_envs']} "
                 f"envs beyond {c['tol']} (max {c['max']})")
    # device time of one more rollout and update, from a profiler trace
    roll_busy, roll_kernels = device_busy(lambda: agent.rollout(ds))
    upd_busy, upd_kernels = device_busy(lambda: agent.update(ds, agent._buffers))
    info.update(rollout_device_busy_ms=roll_busy, rollout_device_kernels=roll_kernels,
                rollout_device_idle_share=1.0 - roll_busy / median(info["rollout_ms"]),
                update_device_busy_ms=upd_busy, update_device_kernels=upd_kernels,
                update_device_idle_share=1.0 - upd_busy / median(info["update_ms"]))
    emit(info)
    del res, agent, ds, denv, steps_seen, teacher_sd

    # ---- K3 on the fall-state settle's ragdoll table, then on the real model - #
    # The getup env uploads the ragdoll's table to K3's unit for its settle
    # and must upload the real model's again for its steps. K3 is held
    # against plain physics_step on the settle's first step (B =
    # num_fall_states, at rest just above the ground), then on the real
    # model with the kernels phase's inputs, with no cache cleared between.
    # In mid-settle the ragdoll step is ill-conditioned (plain float32 and
    # float64 disagree beyond the tolerances in ~10% of the envs), so there
    # K3 is only measured: its envs beyond the tolerances against plain
    # float32 and float64, beside plain float32's against float64.
    gcfg = GetupConfig()
    n_fall = gcfg.num_fall_states
    rag = ragdoll(model)
    with torch.no_grad():
        drop = [fall_drop_start(model, n_fall, gcfg.fall_drop_height, dev)]
        pd0 = torch.zeros(n_fall, model.num_dof, device=dev)
        for _ in range(SETTLE_CHECK_STEP):
            drop.append(substep_cuda.physics_step_cuda(rag, drop[-1], pd0))
        k3_first = substep_cuda.physics_step_cuda(rag, drop[0], pd0)
        plain_first = physics_step(rag, drop[0], pd0)
        rag_cmp = {f: compare(getattr(k3_first, f), getattr(plain_first, f), K1_TOL[f], n_fall) for f in phys}
        # what a skipped upload would give: the real gains on the ragdoll's input
        real_on_drop = physics_step(model, drop[0], pd0)
        teeth = {f: compare(getattr(real_on_drop, f), getattr(plain_first, f), K1_TOL[f], n_fall) for f in phys}
        back = substep_cuda.physics_step_cuda(model, kin_phys, kin_pd)
        mid = drop[SETTLE_CHECK_STEP]
        mid_k3 = substep_cuda.physics_step_cuda(rag, mid, pd0)
        mid_f32 = physics_step(rag, mid, pd0)
        mid_f64 = physics_step(as_float64(rag), as_float64(mid), pd0.double())
    torch.cuda.synchronize()
    back_cmp = {f: compare(getattr(back, f), getattr(p1[0], f), K1_TOL[f], N_ENVS) for f in phys}
    drop_in_contact = int((mid.contact_force.abs().amax(dim=(1, 2)) > 1.0).sum())
    emit({"phase": "getup_tables", "fall_states": n_fall, "K3_ragdoll_first_step_vs_plain": rag_cmp,
          "real_model_vs_ragdoll_first_step": teeth, "K3_real_model_after_ragdoll_vs_plain": back_cmp,
          f"settle_step_{SETTLE_CHECK_STEP}": {
              "envs_in_contact": drop_in_contact,
              "envs_beyond_tol": {"K3_vs_plain_f32": envs_beyond(mid_k3, mid_f32, n_fall),
                                  "K3_vs_plain_f64": envs_beyond(mid_k3, mid_f64, n_fall),
                                  "plain_f32_vs_plain_f64": envs_beyond(mid_f32, mid_f64, n_fall)}}})
    allowed_fall = int(OUTLIER_FRAC * n_fall)
    for label, cmps, limit in (("K3 ragdoll first step", rag_cmp, allowed_fall),
                               ("K3 real model after ragdoll", back_cmp, allowed)):
        for name, c in cmps.items():
            if not c["outlier_envs"] <= limit:
                fail(f"{label} {name}: {c['outlier_envs']} envs beyond {c['tol']} (max {c['max']})")
    if max(c["outlier_envs"] for c in teeth.values()) <= allowed_fall:
        fail("the ragdoll's and the real model's steps agree: the table check cannot tell them apart")
    del drop, k3_first, back, mid, mid_k3, mid_f32, mid_f64

    res, getup_launches, info = train("train_getup", ["env=im_getup"], {"step_reward_amp": 0, "observe": HORIZON,
                                                                        "physics_step": HORIZON,
                                                                        "physics_step_rows": 0,
                                                                        "reward_amp": HORIZON})
    genv = res.agent.env
    settle = getup_launches["physics_step"] - sum(el["physics_step"] for el in info["launches_per_epoch"])
    info.update(fall_settle_launches=settle, fall_resets=int(genv.fall_resets), grace_holds=int(genv.grace_holds),
                num_fall_states=genv.config.num_fall_states, fall_settle_steps=genv.config.fall_settle_steps,
                fall_root_height_median=float(genv.fall_states.root_pos[:, 2].median()))
    emit(info)
    if settle != genv.config.fall_settle_steps or getup_launches["step_reward_amp"] != 0:
        fail(f"train_getup: {settle} K3 launches while building, expected {genv.config.fall_settle_steps}; "
             f"K1 launched {getup_launches['step_reward_amp']} times")
    if info["fall_resets"] == 0 or info["grace_holds"] == 0:
        fail(f"train_getup: {info['fall_resets']} fall-state resets, {info['grace_holds']} grace holds")
    # the run's own model after its settle: K3 against plain on its last state
    with torch.no_grad():
        gphys = res.train_state.env_state.physics
        gpd = genv.action_to_pd_target(0.3 * torch.randn(N_ENVS, genv.action_dim, generator=g, device=dev))
        got = substep_cuda.physics_step_cuda(genv.model, gphys, gpd)
        want = physics_step(genv.model, gphys, gpd)
    run_cmp = {f: compare(getattr(got, f), getattr(want, f), K1_TOL[f], N_ENVS) for f in phys}
    emit({"phase": "train_getup_model_table", "K3_vs_plain_on_final_state": run_cmp})
    for name, c in run_cmp.items():
        if not c["outlier_envs"] <= allowed:
            fail(f"train_getup K3 on its model {name}: {c['outlier_envs']} envs beyond {c['tol']} (max {c['max']})")
    del res, genv

    # ---- shape-varied training: env=im_shape ------------------------------- #
    res, shape_launches, info = train("train_shape", ["env=im_shape"], {"step_reward_amp": 0, "observe": HORIZON,
                                                                        "physics_step": 0,
                                                                        "physics_step_rows": HORIZON,
                                                                        "reward_amp": HORIZON})
    senv = res.agent.env
    sobs = res.train_state.env_state.obs
    s_lo = cuda_obs.self_obs_dim(senv.num_bodies, senv.config.root_height_obs)   # 358
    s_hi = s_lo + senv.shape_obs_dim
    scale = (senv.batched_model.total_mass / senv.model.total_mass) ** (1 / 3)
    info.update(obs_dim=int(sobs.shape[1]), amp_obs_dim=senv.amp_obs_dim,
                shape_columns_equal_table=bool(torch.equal(sobs[:, s_lo:s_hi], senv._shape_obs_table)),
                body_scale_min=float(scale.min()), body_scale_max=float(scale.max()))
    emit(info)
    if info["obs_dim"] != 955 or not info["shape_columns_equal_table"] or senv.amp_obs_dim_single != 253:
        fail(f"train_shape: obs {info['obs_dim']} wide, AMP row {senv.amp_obs_dim_single}, shape columns equal "
             f"the table: {info['shape_columns_equal_table']}")
    # a resample swaps the batched model; the env's rows must follow it
    with torch.no_grad():
        old_bm = senv.batched_model
        senv.resample_shapes()
        sphys = res.train_state.env_state.physics
        spd = senv.action_to_pd_target(0.3 * torch.randn(N_ENVS, senv.action_dim, generator=g, device=dev))
        got = substep_cuda.physics_step_cuda(senv.model, sphys, spd, model_rows=senv._model_rows(N_ENVS))
        want = physics_step(senv.batched_model, sphys, spd)
        stale = physics_step(old_bm, sphys, spd)
    resample_cmp = {f: compare(getattr(got, f), getattr(want, f), K1_TOL[f], N_ENVS) for f in phys}
    stale_beyond = envs_beyond(stale, want, N_ENVS)
    emit({"phase": "train_shape_resample", "K3rows_vs_plain_after_resample": resample_cmp,
          "old_model_envs_beyond_tol": stale_beyond})
    for name, c in resample_cmp.items():
        if not c["outlier_envs"] <= allowed:
            fail(f"K3-rows after resample_shapes {name}: {c['outlier_envs']} envs beyond {c['tol']} (max {c['max']})")
    if stale_beyond <= allowed:
        fail("the old and new shapes' steps agree: the resample check cannot tell them apart")
    del res, senv, old_bm, got, want, stale

    # ---- SMPL-beta skeletons through env.smpl_model_path ------------------- #
    from pulse_tpu_torch.smpl.synthetic import write_smpl_pickle
    from pulse_tpu_torch.utils.config import load_config

    os.makedirs(out_root, exist_ok=True)
    smpl_path = write_smpl_pickle(os.path.join(out_root, "smpl_synthetic.pkl"), spec.skeleton)
    bcfg = load_config(["env=im_shape", f"env.smpl_model_path={smpl_path}", f"num_envs={N_ENVS}", "device=cuda"])
    bspec, bmodel = run.build_model_from_cfg(bcfg, dev)
    benv = run.build_env_from_cfg(bcfg, bmodel, run.build_motion_from_cfg(bcfg, bspec, dev), dev)
    bnet = ActorCritic(benv.obs_dim, benv.action_dim, device=dev, seed=0)
    brms = RunningMeanStd.create(benv.obs_dim, device=dev)
    with torch.no_grad():
        bst = benv.reset(N_ENVS)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        brewards = []
        for _ in range(8):
            bst = benv.step(bst, torch.clamp(policy_step(bnet, bst.obs, g, obs_rms=brms)[0], -1.0, 1.0))
            brewards.append(bst.reward)
        torch.cuda.synchronize()
        beta_launches = dict(_build.launches)
        bpd = benv.action_to_pd_target(0.3 * torch.randn(N_ENVS, benv.action_dim, generator=g, device=dev))
        got = substep_cuda.physics_step_cuda(benv.model, bst.physics, bpd, model_rows=benv._model_rows(N_ENVS))
        want = physics_step(benv.batched_model, bst.physics, bpd)
    brewards = torch.stack(brewards)
    beta_cmp = {f: compare(getattr(got, f), getattr(want, f), K1_TOL[f], N_ENVS) for f in phys}
    bmass = benv.batched_model.total_mass
    emit({"phase": "shape_betas", "envs": N_ENVS, "steps": 8, "launches": beta_launches,
          "total_mass_kg": [float(bmass.min()), float(bmass.median()), float(bmass.max())],
          "betas_std": float(benv._shape_obs_table[:, 1:11].std()), "reward_mean": float(brewards.mean()),
          "reward_min": float(brewards.min()), "reward_max": float(brewards.max()),
          "obs_finite": bool(torch.isfinite(bst.obs).all()), "K3rows_vs_plain": beta_cmp})
    want_b = {"step_reward_amp": 0, "observe": 8, "physics_step": 0, "physics_step_rows": 8, "reward_amp": 8}
    if beta_launches != want_b:
        fail(f"shape_betas: launches {beta_launches}, expected {want_b}")
    if not (bool(torch.isfinite(bst.obs).all()) and 0.0 <= float(brewards.min()) and float(brewards.max()) <= 1.0):
        fail("shape_betas: non-finite obs or reward outside [0, 1]")
    for name, c in beta_cmp.items():
        if not c["outlier_envs"] <= allowed:
            fail(f"shape_betas K3-rows {name}: {c['outlier_envs']} envs beyond {c['tol']} (max {c['max']})")
    del benv, bst, got, want

    # ---- VR three-point tracking: env=im_vr on the general path ------------- #
    # the reference's im_vr.yaml: task obs and reward over Head, L_Hand and
    # R_Hand, so every step is K3, then the general step in plain PyTorch
    want_vr = {"step_reward_amp": 0, "observe": 0, "physics_step": HORIZON, "physics_step_rows": 0, "reward_amp": 0}
    res, vr_launches, info = train("train_vr", ["env=im_vr"], want_vr)
    venv = res.agent.env
    info.update(obs_dim=venv.obs_dim, track_bodies=list(venv.config.track_bodies),
                kernel_path=venv._kernel_surface())
    emit(info)
    want_vr = {k: TRAIN_EPOCHS * n for k, n in want_vr.items()}
    if vr_launches != want_vr or venv.obs_dim != 358 + 3 * 24 or info["kernel_path"]:
        fail(f"train_vr: launches {vr_launches} (expected {want_vr}), obs {venv.obs_dim} wide (expected 430), "
             f"kernel path {info['kernel_path']}")
    del res, venv

    # ---- AMP: the discriminator, its reward mix and the pure-AMP envs --------- #
    # run.main with learning=im_amp (PPO + the 1024-512 discriminator on the
    # 2320-wide AMP window, amp_batch_size 512, buffers of 16384) on env=im
    # (K1 -> K2), env=amp (K3 -> RA, the self obs in PyTorch, never K2) and
    # env=amp_getup with the getup schedule flipping after epoch 1. Each
    # epoch of an AMP agent is read by `amp_epoch`: the reward weights it
    # ran with, the mix against them, the style reward's range, the env's
    # getup probabilities and counters, the rollout's terminations, and
    # whether the recorded AMP window of the last step is the env's history
    from pulse_tpu_torch.learning.networks import Discriminator

    def amp_epoch(rows):
        def hook(agent, out):
            ts_, m_ = out
            r_ = agent.last_rewards
            wt, wd = float(ts_.amp.task_reward_w), float(ts_.amp.disc_reward_w)
            cfg_ = agent.env.config
            rows.append({"task_w": wt, "disc_w": wd,
                         "last_window_is_env_amp_hist": bool(torch.equal(agent.ppo.amp_obs[-1],
                                                                         ts_.ppo.env_state.amp_hist.flatten(1))),
                         "mix_max_abs_err": float((r_["mixed"] - (wt * r_["task"] + wd * r_["disc"])).abs().max()),
                         "disc_reward_min": float(r_["disc"].min()), "disc_reward_max": float(r_["disc"].max()),
                         "disc_reward_finite": bool(torch.isfinite(r_["disc"]).all()),
                         "task_reward_min": float(r_["task"].min()), "task_reward_max": float(r_["task"].max()),
                         "terminations": int(agent.ppo._buffers.terminates.sum()),
                         "dones": int(agent.ppo._buffers.dones.sum()),
                         "fall_init_prob": getattr(cfg_, "fall_init_prob", None),
                         "recovery_episode_prob": getattr(cfg_, "recovery_episode_prob", None),
                         "fall_resets": int(getattr(agent.env, "fall_resets", 0)),
                         "grace_holds": int(getattr(agent.env, "grace_holds", 0))})
        return hook

    def train_amp(exp: str, env_args: list, want_epoch: dict, epochs: int, on_epoch=None,
                  learning: str = "im_amp", trace_rollout: bool = True, device_trace: bool = True) -> tuple:
        """`train` with learning=im_amp (or another AMP config), then the AMP
        gates every path shares:
        the discriminator changed, the buffers and amp_rms grown by exactly
        one update an epoch, the recorded AMP window of the last step the
        env's, the mix, the style reward's range and the accuracies; then the
        device time of the discriminator's reward over a rollout and of one
        of its updates. `on_epoch(agent, out)` runs after each epoch too."""
        rows = []
        hook_ = amp_epoch(rows)

        def hooks(agent, out):
            hook_(agent, out)
            if on_epoch is not None:
                on_epoch(agent, out)

        res_, counts_, info_ = train(exp, env_args, want_epoch, learning=learning, epochs=epochs, on_epoch=hooks,
                                     trace_rollout=trace_rollout, device_trace=device_trace)
        agent_, ts_ = res_.agent, res_.train_state
        a_, pa_ = ts_.amp, agent_.ppo
        acfg = agent_.amp.config
        n_ = acfg.amp_batch_size
        fresh_d = Discriminator(agent_.env.amp_obs_dim, acfg.disc_units, device=dev, seed=agent_.amp.seed).state_dict()
        d_changed = sum(not torch.equal(v, fresh_d[k]) for k, v in a_.disc.state_dict().items())
        ms_ = res_.metrics
        timed_ = ms_[1:] or ms_
        info_.update(
            amp_obs_dim=agent_.env.amp_obs_dim, obs_dim=agent_.env.obs_dim, disc_units=list(acfg.disc_units),
            amp_batch_size=n_, per_epoch=rows, disc_params_changed=d_changed,
            replay_size=a_.replay_buffer.size, demo_size=a_.demo_buffer.size, amp_rms_count=float(a_.amp_rms.count),
            **{k: [m[k] for m in ms_] for k in ("disc_loss", "disc_grad_pen", "disc_acc_agent", "disc_acc_demo",
                                                "task_reward_mean", "disc_reward_mean")},
            disc_reward_ms=[1e3 * m["disc_reward_s"] for m in timed_],
            disc_update_ms=[1e3 * m["disc_update_s"] for m in timed_])
        want_demo, want_count = acfg.amp_buffer_size // 4 + n_ * epochs, epochs * (per_epoch + n_)
        if d_changed != len(fresh_d):
            fail(f"{exp}: {d_changed} of {len(fresh_d)} discriminator tensors changed")
        if (info_["replay_size"], info_["demo_size"]) != (n_ * epochs, want_demo):
            fail(f"{exp}: replay {info_['replay_size']} / demo {info_['demo_size']} rows, expected "
                 f"{n_ * epochs} / {want_demo}")
        if abs(info_["amp_rms_count"] - want_count) > 1.0:
            fail(f"{exp}: amp_rms.count {info_['amp_rms_count']}, expected {want_count}")
        if not all(r["last_window_is_env_amp_hist"] for r in rows):
            fail(f"{exp}: the recorded AMP window of the last step is not the env's amp_hist")
        for i, row in enumerate(rows):
            if row["mix_max_abs_err"] > 1e-6 or not row["disc_reward_finite"] or row["disc_reward_min"] < 0.0:
                fail(f"{exp} epoch {i}: mix off by {row['mix_max_abs_err']} or style reward outside [0, inf): {row}")
        for k in ("disc_loss", "disc_grad_pen"):
            if not all(math.isfinite(v) for v in info_[k]):
                fail(f"{exp}: non-finite {k} {info_[k]}")
        if not all(0.0 <= v <= 1.0 for k in ("disc_acc_agent", "disc_acc_demo") for v in info_[k]):
            fail(f"{exp}: accuracies outside [0, 1]")
        if not device_trace:
            return res_, counts_, info_, rows
        # the style reward over the rollout is ~17 kernels, two of them fp32
        # GEMMs: its device time from CUDA events around 5 calls (a
        # one-call profiler trace was seen to lose its first kernels), its
        # kernels by name from one trace, against the bound of its
        # operations (2 * rows * the MLP's multiply-adds) and bytes
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_dr:
            agent_.amp.disc_reward(a_, pa_.amp_obs)
            torch.cuda.synchronize()
        dr_trace = [(ev.name[:60], ev.time_range.elapsed_us()) for ev in prof_dr.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA]
        dr_ms = cuda_ms(lambda: agent_.amp.disc_reward(a_, pa_.amp_obs), 5)
        rows_dr = pa_.amp_obs.shape[0] * pa_.amp_obs.shape[1]
        widths = [agent_.env.amp_obs_dim, *acfg.disc_units, 1]
        dr_flop = 2.0 * rows_dr * sum(i * o for i, o in zip(widths[:-1], widths[1:]))
        dr_bound, dr_by = bound_ms(4.0 * rows_dr * (agent_.env.amp_obs_dim + 1), dr_flop)
        du_busy, du_kernels = device_busy(lambda: agent_.amp.update(a_, pa_.amp_obs))
        info_.update(disc_reward_device_ms=dr_ms, disc_reward_trace_us=dr_trace, disc_reward_flop=dr_flop,
                     disc_reward_bound_ms=dr_bound, disc_reward_bound_by=dr_by,
                     disc_reward_device_idle_share=1.0 - dr_ms / median(info_["disc_reward_ms"]),
                     disc_update_device_busy_ms=du_busy, disc_update_device_kernels=du_kernels,
                     disc_update_device_idle_share=1.0 - du_busy / median(info_["disc_update_ms"]))
        return res_, counts_, info_, rows

    want_ai = {"step_reward_amp": HORIZON, "observe": HORIZON, "physics_step": 0, "physics_step_rows": 0,
               "reward_amp": 0}
    res, amp_im_launches, info, rows = train_amp("train_amp_im", ["env=im"], want_ai, TRAIN_EPOCHS)
    emit(info)
    want_total = dict(want_ai, step_reward_amp=TRAIN_EPOCHS * HORIZON, observe=TRAIN_EPOCHS * HORIZON + 1)
    if amp_im_launches != want_total or any((r["task_w"], r["disc_w"]) != (0.5, 0.5) for r in rows):
        fail(f"train_amp_im: launches {amp_im_launches} (expected {want_total}), weights {rows}")
    del res

    # ---- the learning layer's other networks: recurrent, Sept, Z ------------ #
    # No config or CLI of either package builds these networks, so each phase
    # builds its env and agent through run's builders from the config named,
    # then an agent of the same class and configs around the new network.
    # Each phase's launches are read around its epochs (the init's reset
    # launches K2 once more), its gates after them
    from pulse_tpu_torch.learning import vq_quantizer as vq
    from pulse_tpu_torch.learning.networks import CNNActorCritic, RNNActorCritic, SeptActorCritic, ZEmbedding
    from pulse_tpu_torch.learning.ppo import gaussian_neglogp
    from pulse_tpu_torch.utils.config import load_config

    def built(args: list, learning: str) -> tuple:
        """(env, the agent run.main builds) of a config at N_ENVS."""
        cfg_ = load_config([*args, f"learning={learning}", f"num_envs={N_ENVS}", "device=cuda"])
        spec_, model_ = run.build_model_from_cfg(cfg_, dev)
        env_ = run.build_env_from_cfg(cfg_, model_, run.build_motion_from_cfg(cfg_, spec_, dev), dev)
        return env_, run.build_agent_from_cfg(cfg_, env_)

    def with_network(agent_, net_):
        """An agent of agent_'s class and configs around net_."""
        if isinstance(agent_, AMPAgent):
            return AMPAgent(agent_.env, agent_.ppo.config, agent_.amp.config, net_, seed=1)
        return PPOAgent(agent_.env, agent_.config, net_, seed=1)

    def lib_train(label: str, agent_, epochs: int, want_epoch: dict, device_trace: bool = False) -> tuple:
        """agent_.init() and `epochs` train_epochs: (train state, the
        phase's launches, its info). Gates the launches of every epoch,
        finite PPO losses and changed parameters; a recurrent agent's every
        epoch starts from the carry the last one left. With `device_trace`,
        after the gates, the device-busy ms and kernels of one more rollout
        and of one update on it (the profiler)."""
        pag = getattr(agent_, "ppo", agent_)
        fresh_ = {k: v.clone() for k, v in pag.network.state_dict().items()}
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0_ = time.perf_counter()
        ts_ = agent_.init()
        per_, ms_, carried = [], [], []
        for _ in range(epochs):
            pts = getattr(ts_, "ppo", ts_)
            carry_in = tuple(h.clone() for h in pts.hidden) if pag.recurrent else None
            before = dict(_build.launches)
            ts_, m_ = agent_.train_epoch(ts_)
            per_.append({k: n - before[k] for k, n in _build.launches.items()})
            ms_.append({k: float(v) for k, v in m_.items()})
            if pag.recurrent:
                carried.append(all(torch.equal(a[0], b) for a, b in zip(pag._buffers.hiddens, carry_in)))
        torch.cuda.synchronize()
        launches_ = dict(_build.launches)
        pts = getattr(ts_, "ppo", ts_)
        changed_ = sum(not torch.equal(v, fresh_[k]) for k, v in pts.network.state_dict().items())
        timed_ = ms_[1:] or ms_
        epoch_s = [sum(v for k, v in m.items() if k.endswith("_s")) for m in timed_]
        info_ = {"phase": label, "card": card, "envs": N_ENVS, "epochs": epochs, "network": type(pag.network).__name__,
                 "parameters": sum(p_.numel() for p_ in pag.network.parameters()),
                 "seconds_all": time.perf_counter() - t0_, "launches": launches_, "launches_per_epoch": per_,
                 "losses": [{k: m[k] for k in ("a_loss", "c_loss", "b_loss")} for m in ms_],
                 "reward_mean": [m["reward_mean"] for m in ms_], "params_changed": changed_,
                 "rollout_ms": [1e3 * m["rollout_s"] for m in timed_],
                 "update_ms": [1e3 * m["update_s"] for m in timed_],
                 "train_env_steps_per_s": [per_epoch / s_ for s_ in epoch_s],
                 "obs_finite": bool(torch.isfinite(pts.env_state.obs).all())}
        info_.update({k: [m[k] for m in ms_] for k in ("disc_loss", "disc_grad_pen") if k in ms_[0]})
        if pag.recurrent:
            info_["epoch_started_from_last_carry"] = carried
        losses_ = [v for m in info_["losses"] for v in m.values()] + info_.get("disc_loss", [])
        if not all(math.isfinite(v) for v in losses_ + info_["reward_mean"]) or not info_["obs_finite"]:
            fail(f"{label}: non-finite loss, reward or obs: {info_}")
        if any(pe != want_epoch for pe in per_):
            fail(f"{label}: launches per epoch {per_}, expected {want_epoch}")
        if not changed_:
            fail(f"{label}: no parameter changed")
        if pag.recurrent and not all(carried):
            fail(f"{label}: an epoch did not start from the last one's carry: {carried}")
        if device_trace:
            roll_busy, roll_kernels = device_busy(lambda: pag.rollout(pts))
            with torch.no_grad():
                last_v = pag._value(pts, pts.env_state.obs, pts.env_state.done)
            adv_, ret_ = compute_gae(pag.config, pag._buffers, last_v)
            upd_busy, upd_kernels = device_busy(lambda: pag.update(pts, pag._buffers, adv_, ret_))
            info_.update(rollout_device_busy_ms=roll_busy, rollout_device_kernels=roll_kernels,
                         rollout_device_idle_share=1.0 - roll_busy / median(info_["rollout_ms"]),
                         update_device_busy_ms=upd_busy, update_device_kernels=upd_kernels,
                         update_device_idle_share=1.0 - upd_busy / median(info_["update_ms"]))
        return ts_, launches_, info_

    def bptt_replay(pag, ts_, roll) -> dict:
        """Every stored sequence of a recurrent rollout replayed through the
        cell at the rollout's parameters, in update_rnn's layout and
        minibatches (L steps from the carry stored at the sequence's first
        step, reset by the stored entry done flags): its neg-log-probs and
        values against the rollout's."""
        T_, B_ = roll.rewards.shape
        L_ = pag.config.seq_len
        n_seq = (T_ // L_) * B_

        def to_seq(x):
            return x.reshape(T_ // L_, L_, B_, *x.shape[2:]).transpose(1, 2).reshape(n_seq, L_, *x.shape[2:])

        obs_n, dones, acts = to_seq(ts_.obs_rms.normalize(roll.obs)), to_seq(roll.prev_dones), to_seq(roll.actions)
        hid = tuple(h.reshape(T_ // L_, L_, B_, -1)[:, 0].reshape(n_seq, -1) for h in roll.hiddens)
        mb_ = max(min(pag.config.minibatch_size // L_, n_seq), 1)
        nl, val = torch.empty(n_seq, L_, device=dev), torch.empty(n_seq, L_, device=dev)
        with torch.no_grad():
            for i in range(0, n_seq, mb_):
                carry = tuple(h[i:i + mb_] for h in hid)
                for s_ in range(L_):
                    carry, (mu_, ls_, v_) = ts_.network(carry, obs_n[i:i + mb_, s_], dones[i:i + mb_, s_])
                    nl[i:i + mb_, s_] = gaussian_neglogp(mu_, ls_, acts[i:i + mb_, s_])
                    val[i:i + mb_, s_] = ts_.value_rms.denormalize(v_[:, None])[:, 0]
        dn, dv = (nl - to_seq(roll.neglogp)).abs(), (val - to_seq(roll.values)).abs()
        return {"sequences": n_seq, "seq_len": L_, "minibatch_sequences": mb_,
                "resets_inside_sequences": int(dones[:, 1:].sum()),
                "neglogp_max_abs_err": float(dn.max()), "neglogp_median_abs_err": float(dn.median()),
                "neglogp_scale": float(to_seq(roll.neglogp).abs().max()),
                "value_max_abs_err": float(dv.max()), "value_median_abs_err": float(dv.median()),
                "value_scale": float(to_seq(roll.values).abs().max()),
                "ratio_max_abs_dev": float((torch.exp(to_seq(roll.neglogp) - nl) - 1.0).abs().max())}

    def replayed_first(pag, out: dict):
        """Wrap pag.update_rnn so that its first call first runs bptt_replay
        on the rollout it is handed, before any optimizer step."""
        real = pag.update_rnn

        def update_rnn(ts_, roll, adv, ret):
            if not out:
                out.update(bptt_replay(pag, ts_, roll))
            return real(ts_, roll, adv, ret)

        pag.update_rnn = update_rnn

    want_k12 = {"step_reward_amp": HORIZON, "observe": HORIZON, "physics_step": 0, "physics_step_rows": 0,
                "reward_amp": 0}
    lib_launches = {}

    # train_rnn: RNNActorCritic (trunk 1024-512, LSTM 256) under im_ppo's PPO
    # (horizon 32, minibatch 16384 = 4096 sequences of 4, 6 mini-epochs) on
    # env=im, K1 -> K2; the replay gate in bf16: the trunk's bf16 GEMMs at
    # 4096 rows may round apart from the rollout's at 3072 (RNN_REPLAY_TOL;
    # on an H100 they have given the same bits)
    rnn_env, im_agent = built(["env=im"], "im_ppo")
    rnn_net = RNNActorCritic(rnn_env.obs_dim, rnn_env.action_dim, device=dev, seed=0)
    rnn_agent = with_network(im_agent, rnn_net)
    replay = {}
    replayed_first(rnn_agent, replay)
    rts, lib_launches["train_rnn"], info = lib_train("train_rnn", rnn_agent, TRAIN_EPOCHS, want_k12,
                                                     device_trace=True)
    with torch.no_grad():
        st_ = rts.env_state
        obs_n = rts.obs_rms.normalize(st_.obs)
        done_ = torch.zeros(N_ENVS, dtype=torch.bool, device=dev)
        done_[::3] = True
        (c_d, h_d), (mu_d, _, v_d) = rnn_net(rts.hidden, obs_n, done_)
        (c_0, h_0), (mu_0, _, v_0) = rnn_net(rnn_net.initial_carry(N_ENVS), obs_n)
    pairs_ = ((c_d, c_0), (h_d, h_0), (mu_d, mu_0), (v_d, v_0))
    reset = {"done_envs": int(done_.sum()),
             "equal_to_zero_carry": all(torch.equal(a[done_], b[done_]) for a, b in pairs_),
             "others_differ": all(not torch.equal(a[~done_], b[~done_]) for a, b in pairs_[2:])}
    info.update(rnn_size=rnn_net.rnn_size, seq_len=rnn_agent.config.seq_len, bptt_replay=replay,
                replay_tol=RNN_REPLAY_TOL, done_reset=reset, train_im_train_env_steps_per_s=im_steps_per_s,
                train_im_rollout_ms=im_rollout_ms, train_im_update_ms=im_update_ms)
    emit(info)
    if not (replay and replay["neglogp_max_abs_err"] <= RNN_REPLAY_TOL["neglogp"]
            and replay["value_max_abs_err"] <= RNN_REPLAY_TOL["value"] * (1.0 + replay["value_scale"])):
        fail(f"train_rnn: the BPTT replay missed the rollout: {replay} (tolerance {RNN_REPLAY_TOL})")
    if replay["resets_inside_sequences"] == 0:
        fail("train_rnn: no reset inside a replayed sequence: the stored resets were not exercised")
    if not (reset["equal_to_zero_carry"] and reset["others_differ"]):
        fail(f"train_rnn: a done env's output is not a zero carry's, or the others' are: {reset}")
    del rnn_env, im_agent, rnn_agent, rts, st_

    # train_amp_rnn: the same network in the AMPAgent of env=im learning=im_amp
    ar_env, ar_base = built(["env=im"], "im_amp")
    ar_agent = with_network(ar_base, RNNActorCritic(ar_env.obs_dim, ar_env.action_dim, device=dev, seed=0))
    ar_ts, lib_launches["train_amp_rnn"], info = lib_train("train_amp_rnn", ar_agent, TRAIN_EPOCHS, want_k12)
    acfg = ar_agent.amp.config
    n_ = acfg.amp_batch_size
    a_ = ar_ts.amp
    info.update(replay_size=a_.replay_buffer.size, demo_size=a_.demo_buffer.size, amp_rms_count=float(a_.amp_rms.count),
                amp_batch_size=n_, last_window_is_env_amp_hist=bool(torch.equal(
                    ar_agent.ppo.amp_obs[-1], ar_ts.ppo.env_state.amp_hist.flatten(1))))
    emit(info)
    want_demo, want_count = acfg.amp_buffer_size // 4 + n_ * TRAIN_EPOCHS, TRAIN_EPOCHS * (per_epoch + n_)
    if ((info["replay_size"], info["demo_size"]) != (n_ * TRAIN_EPOCHS, want_demo)
            or abs(info["amp_rms_count"] - want_count) > 1.0 or not info["last_window_is_env_amp_hist"]
            or len(info.get("disc_loss", [])) != TRAIN_EPOCHS):
        fail(f"train_amp_rnn: AMP rows or discriminator steps: {info}")
    del ar_env, ar_base, ar_agent, ar_ts, a_

    # train_sept: SeptActorCritic (self / task / actor 1024-512, critic
    # 2048-1024, float32) under im_ppo's PPO on env=im, K1 -> K2
    se_env, se_base = built(["env=im"], "im_ppo")
    se_agent = with_network(se_base, SeptActorCritic(se_env.obs_dim, se_env.action_dim, se_env.self_obs_dim,
                                                     device=dev, seed=0))
    _, lib_launches["train_sept"], info = lib_train("train_sept", se_agent, TRAIN_EPOCHS, want_k12)
    info["self_obs_dim"] = se_env.self_obs_dim
    emit(info)
    if se_env.self_obs_dim != 358 or not all(math.isfinite(v) for v in info["reward_mean"]):
        fail(f"train_sept: self obs {se_env.self_obs_dim} wide, rewards {info['reward_mean']}")
    del se_env, se_base, se_agent

    # z_embedding: each z type at PULSE's latent (32) on 16384 rows of a
    # 1024-wide feature with a codebook of Z_CODES entries, on the card
    # against the same module on the CPU; then quantize and ema_update
    zf = torch.randn(Z_ROWS, Z_FEAT, generator=torch.Generator().manual_seed(5))
    zf_dev = zf.to(dev)
    cb_cpu = vq.create_codebook(Z_CODES, Z_LATENT, torch.Generator().manual_seed(6), device="cpu")
    cb_dev = vq.CodebookState(**{k: v.to(dev) for k, v in vars(cb_cpu).items()})

    def tied(x: torch.Tensor, cb: torch.Tensor, i_a: torch.Tensor, i_b: torch.Tensor) -> torch.Tensor:
        """Rows whose two indexes lie within Z_TIE of each other's squared
        distance (float64, relative to |x|^2 + |c|^2)."""
        x64, c64 = x.double(), cb.double()
        d_a, d_b = ((x64 - c64[i_a]) ** 2).sum(-1), ((x64 - c64[i_b]) ** 2).sum(-1)
        return (d_a - d_b).abs() <= Z_TIE * ((x64 ** 2).sum(-1) + (c64 ** 2).sum(-1).max())

    z_info = {"phase": "z_embedding", "card": card, "rows": Z_ROWS, "feature": Z_FEAT, "latent": Z_LATENT,
              "codes": Z_CODES, "tol": Z_TOL, "tie_tol": Z_TIE, "types": {}}
    for z_type in ZEmbedding.Z_TYPES:
        zn_cpu = ZEmbedding(Z_FEAT, Z_LATENT, z_type, device="cpu", seed=7)
        zn_dev = ZEmbedding(Z_FEAT, Z_LATENT, z_type, device=dev, seed=7)
        zn_dev.load_state_dict(zn_cpu.state_dict())
        with torch.no_grad():
            z_c, ex_c = zn_cpu(zf, cb_cpu)
            z_d, ex_d = zn_dev(zf_dev, cb_dev)
        z_d, ex_d = z_d.cpu(), {k: v.cpu() for k, v in ex_d.items()}
        row_err = (z_d - z_c).abs().amax(dim=-1)
        zi = {"z_max_abs_err": float(row_err.max()), "z_scale": float(z_c.abs().max()),
              "ms": cuda_ms(lambda: zn_dev(zf_dev, cb_dev), 5)}
        ok = True
        if z_type != "sphere":
            same = ex_d["indexes"] == ex_c["indexes"]
            q_in = ex_c["z_before_quant"]
            if z_type == "vq_vae_res":
                q_in = vq.project_to_norm(q_in, zn_cpu.embedding_norm, "sphere")
            ties = tied(q_in[~same], cb_cpu.codebook, ex_d["indexes"][~same], ex_c["indexes"][~same])
            zi.update(index_mismatches=int((~same).sum()), mismatches_within_tie=int(ties.sum()),
                      z_max_abs_err_equal_index_rows=float(row_err[same].max()),
                      **{f"{k}_err": abs(float(ex_d[k]) - float(ex_c[k])) for k in ("commit_loss", "codebook_loss")},
                      pre_quant_max_abs_err=float((ex_d["z_before_quant"] - ex_c["z_before_quant"]).abs().max()))
            ok = bool(ties.all()) and zi["z_max_abs_err_equal_index_rows"] <= Z_TOL * (1.0 + zi["z_scale"]) and all(
                zi[f"{k}_err"] <= Z_TOL * (1.0 + abs(float(ex_c[k]))) for k in ("commit_loss", "codebook_loss"))
        else:
            ok = zi["z_max_abs_err"] <= Z_TOL * (1.0 + zi["z_scale"])
        z_info["types"][z_type] = zi
        if not ok:
            fail(f"z_embedding {z_type}: card against CPU {zi}")
    zq_in = 0.1 * zf[:, :Z_LATENT]
    with torch.no_grad():
        _, idx_c, _ = vq.quantize(cb_cpu, zq_in)
        ema_c = vq.ema_update(cb_cpu, zq_in, idx_c)
        ema_d = vq.ema_update(cb_dev, zq_in.to(dev), idx_c.to(dev))
    z_info["ema_update"] = {k: float((getattr(ema_d, k).cpu() - getattr(ema_c, k)).abs().max())
                            for k in ("codebook", "ema_counts", "ema_means")}
    z_info["ema_codes_used"] = int((torch.bincount(idx_c, minlength=Z_CODES) > 0).sum())
    emit(z_info)
    ema_err = z_info["ema_update"]
    if ema_err["ema_counts"] > Z_TOL or any(ema_err[k] > Z_TOL * (1.0 + float(getattr(ema_c, k).abs().max()))
                                            for k in ("codebook", "ema_means")):
        fail(f"z_embedding: ema_update card against CPU {z_info['ema_update']}")

    want_a = {"step_reward_amp": 0, "observe": 0, "physics_step": HORIZON, "physics_step_rows": 0,
              "reward_amp": HORIZON}
    res, amp_launches, info, rows = train_amp("train_amp", ["env=amp"], want_a, TRAIN_EPOCHS)
    aenv, ast = res.agent.env, res.train_state.ppo.env_state
    # RA's AMP row on the run's last state against its plain version
    with torch.no_grad():
        t_a = aenv._motion_time(ast.motion_id, ast.start_time, ast.progress)
        ref_a = get_motion_state(aenv.motion, ast.motion_id, t_a)
        ra_row = cuda_obs.reward_amp(aenv.consts, ast.physics, ref_a)[-1]
        plain_row = cuda_obs.amp_row_plain(aenv.consts, ast.physics)
    ra_cmp = compare(ra_row, plain_row, K1_TOL["amp"], N_ENVS)
    info.update(RA_amp_row_vs_plain=ra_cmp, env=type(aenv).__name__, kernel_path=aenv._kernel_surface(),
                fused=aenv._fused_step_ok(), terminations=[r["terminations"] for r in rows])
    emit(info)
    want_total = {k: TRAIN_EPOCHS * n for k, n in want_a.items()}
    if amp_launches != want_total or aenv.obs_dim != 358 or info["fused"] or not info["kernel_path"]:
        fail(f"train_amp: launches {amp_launches} (expected {want_total}), obs {aenv.obs_dim} wide (expected "
             f"358), K3 -> RA path {info['kernel_path'] and not info['fused']}")
    if any((r["task_reward_min"], r["task_reward_max"]) != (1.0, 1.0) for r in rows):
        fail(f"train_amp: task reward not 1: {rows}")
    if ra_cmp["outlier_envs"]:
        fail(f"train_amp: RA's AMP row, {ra_cmp['outlier_envs']} envs beyond {ra_cmp['tol']} of the plain row")
    del res, aenv, ast

    want_g = dict(want_a)
    res, amp_getup_launches, info, rows = train_amp("train_amp_getup", ["env=amp_getup",
                                                                        "env.getup_update_epoch=1"], want_g, 3)
    genv = res.agent.env
    settle = amp_getup_launches["physics_step"] - 3 * HORIZON
    info.update(fall_settle_launches=settle, num_fall_states=genv.config.num_fall_states,
                fall_resets=int(genv.fall_resets), grace_holds=int(genv.grace_holds))
    emit(info)
    gc_ = GetupConfig()
    if settle != gc_.fall_settle_steps or amp_getup_launches["observe"] or amp_getup_launches["step_reward_amp"]:
        fail(f"train_amp_getup: launches {amp_getup_launches}: expected {gc_.fall_settle_steps} settle K3, "
             f"no K1 or K2")
    early, late = rows[:2], rows[2]
    if any((r["task_w"], r["disc_w"], r["fall_init_prob"], r["recovery_episode_prob"]) != (0.0, 1.0, 1.0, 0.0)
           for r in early) or early[-1]["fall_resets"] == 0:
        fail(f"train_amp_getup: epochs 0-1 not the style reward alone on fall resets: {early}")
    if (late["task_w"], late["disc_w"], late["fall_init_prob"], late["recovery_episode_prob"]) != (
            0.5, 0.5, gc_.fall_init_prob, gc_.recovery_episode_prob):
        fail(f"train_amp_getup: epoch 2 not the configured mix and probabilities: {late}")
    del res, genv

    # ---- MCP: composer weights over frozen PNN primitives -------------------- #
    # env=im_mcp: the policy (2048-1536-1024) outputs 3 composer weights; the
    # env blends 3 frozen 512-512 PNN columns on the pre-step obs (float32,
    # outside the policy's autocast) and steps K1 -> K2 as env=im does;
    # env=im_mcp_getup the same on K3 -> RA -> K2
    from pulse_tpu_torch.learning.pnn import PNN, compose_actions

    def per_step(info_) -> dict:
        """A training phase's ms and device-busy ms an env step (the
        rollout's, policy included)."""
        return {"ms_per_step": median(info_["rollout_ms"]) / HORIZON,
                "device_busy_ms_per_step": info_["rollout_device_busy_ms"] / HORIZON}

    want_mcp = {"step_reward_amp": HORIZON, "observe": HORIZON, "physics_step": 0, "physics_step_rows": 0,
                "reward_amp": 0}
    res, mcp_launches, info = train("train_mcp", ["env=im_mcp"], want_mcp)
    menv, mst = res.agent.env, res.train_state.env_state
    fresh_pnn = PNN(menv.obs_dim, 69, 3, (512, 512), device=dev, seed=run.PNN_SEED_OFFSET)   # cfg seed 0
    pnn_same = all(torch.equal(a_, b_) for a_, b_ in zip(menv.pnn.state_dict().values(),
                                                        fresh_pnn.state_dict().values()))
    with torch.no_grad():
        w_ = torch.rand(N_ENVS, 3, generator=g, device=dev) * 2.0 - 1.0
        with torch.autocast("cuda", dtype=torch.bfloat16):
            blend = menv.motor_actions(mst, w_)
        prims = menv.pnn(mst.obs)
        want_blend = torch.clamp(compose_actions(torch.softmax(w_ * menv.gate_temp, dim=-1), prims), -1.0, 1.0)
        blend_ms = cuda_ms(lambda: menv.motor_actions(mst, w_), 20)
    info.update(per_step(info), obs_dim=menv.obs_dim, action_dim=menv.action_dim, pnn_units=list(menv.pnn.units),
                pnn_unchanged=pnn_same, blend_dtype=str(blend.dtype),
                blend_vs_separate_pnn=float((blend - want_blend).abs().max()), blend_ms=blend_ms,
                fused=menv._fused_step_ok())
    emit(info)
    want_total = dict(want_mcp, step_reward_amp=TRAIN_EPOCHS * HORIZON, observe=TRAIN_EPOCHS * HORIZON + 1)
    if mcp_launches != want_total or menv.action_dim != 3 or res.train_state.network.mu.out_features != 3:
        fail(f"train_mcp: launches {mcp_launches} (expected {want_total}), action_dim {menv.action_dim}")
    if not pnn_same or blend.dtype != torch.float32 or info["blend_vs_separate_pnn"] > 1e-6:
        fail(f"train_mcp: PNN unchanged {pnn_same}, blend {blend.dtype}, off by {info['blend_vs_separate_pnn']}")
    del res, menv, mst, fresh_pnn

    want_mg = {"step_reward_amp": 0, "observe": HORIZON, "physics_step": HORIZON, "physics_step_rows": 0,
               "reward_amp": HORIZON}
    res, mcp_getup_launches, info = train("train_mcp_getup", ["env=im_mcp_getup"], want_mg)
    mgenv = res.agent.env
    info.update(per_step(info), action_dim=mgenv.action_dim, fall_resets=int(mgenv.fall_resets),
                grace_holds=int(mgenv.grace_holds))
    emit(info)
    want_total = {"step_reward_amp": 0, "observe": TRAIN_EPOCHS * HORIZON + 1,
                  "physics_step": GetupConfig().fall_settle_steps + TRAIN_EPOCHS * HORIZON, "physics_step_rows": 0,
                  "reward_amp": TRAIN_EPOCHS * HORIZON}
    if mcp_getup_launches != want_total or mgenv.action_dim != 3:
        fail(f"train_mcp_getup: launches {mcp_getup_launches} (expected {want_total})")
    del res, mgenv

    # ---- train_getup_shape: shape variation under the getup env -------------- #
    # env=im_getup env.shape_variation=true: every env its own body scale
    # (K3-rows -> RA -> K2 a step), the fall-state bank settled once under the
    # shared model (K3 on the settle only) and not rebuilt by the shapes
    want_gs = {"step_reward_amp": 0, "observe": HORIZON, "physics_step": 0, "physics_step_rows": HORIZON,
               "reward_amp": HORIZON}
    res, gs_launches, info = train("train_getup_shape", ["env=im_getup", "env.shape_variation=true"], want_gs)
    gsenv, gst = res.agent.env, res.train_state.env_state
    gs_rows = gsenv._model_rows(N_ENVS)
    # one step's physics, reward terms and obs, kernel against plain on identical inputs
    with torch.no_grad():
        gs_pd = gsenv.action_to_pd_target(0.3 * torch.randn(N_ENVS, gsenv.action_dim, generator=g, device=dev))
        gs_k = substep_cuda.physics_step_cuda(gsenv.model, gst.physics, gs_pd, model_rows=gs_rows)
        gs_p = physics_step(gsenv.batched_model, gst.physics, gs_pd)
        _, gs_ref = gsenv._post_step_ref(gst, gst.progress + 1)
        gs_parts = gsenv._disc_parts(N_ENVS)
        gs_ra = cuda_obs.reward_amp(gsenv.consts, gs_k, gs_ref, *gs_parts)
        gs_pra = cuda_obs.reward_amp_plain(gsenv.consts, gs_k, gs_ref, *gs_parts)
        gs_shape = gsenv._shape_obs(N_ENVS)
        gs_obs = cuda_obs.observe(gsenv.consts, gs_k, gs_ref, gs_shape)
        gs_pobs = cuda_obs.observe_plain(gsenv.consts, gs_k, gs_ref, gs_shape)
    gs_cmp = {f: compare(getattr(gs_k, f), getattr(gs_p, f), K1_TOL[f], N_ENVS) for f in phys}
    gs_cmp.update({n: compare(a, b, K1_TOL[n], N_ENVS) for n, a, b in zip(names, gs_ra, gs_pra)})
    gs_cmp["obs"] = compare(gs_obs, gs_pobs, K2_TOL, N_ENVS)
    gs_settle = gs_launches["physics_step"]
    # isotropic scales drawn in float32 can repeat (a few of 3072 draws):
    # each env's rows must be its own model's, so the rows are as distinct
    # as the models
    gs_bm = gsenv.batched_model
    gs_models = torch.cat([getattr(gs_bm, k).reshape(N_ENVS, -1).float() for k in BATCHED_LEAVES], dim=1)
    info.update(per_step(info), fall_settle_launches=gs_settle, fall_resets=int(gsenv.fall_resets),
                grace_holds=int(gsenv.grace_holds), distinct_model_rows=int(torch.unique(gs_rows, dim=0).shape[0]),
                distinct_models=int(torch.unique(gs_models, dim=0).shape[0]),
                model_rows_width=int(gs_rows.shape[1]), route=gsenv.physics_route, fused=gsenv._fused_step_ok(),
                fall_bank_root_height_median=float(gsenv.fall_states.root_pos[:, 2].median()),
                kernel_vs_plain_one_step=gs_cmp)
    emit(info)
    want_total = {"step_reward_amp": 0, "observe": TRAIN_EPOCHS * HORIZON + 1,
                  "physics_step": gsenv.config.fall_settle_steps, "physics_step_rows": TRAIN_EPOCHS * HORIZON,
                  "reward_amp": TRAIN_EPOCHS * HORIZON}
    if gs_launches != want_total or info["fused"] or info["route"] != "kernel":
        fail(f"train_getup_shape: launches {gs_launches} (expected {want_total}), route {info['route']}, "
             f"fused {info['fused']}")
    if (info["fall_resets"] == 0 or info["distinct_model_rows"] != info["distinct_models"]
            or info["distinct_models"] < N_ENVS - allowed):
        fail(f"train_getup_shape: {info['fall_resets']} fall resets, {info['distinct_model_rows']} distinct "
             f"model rows for {info['distinct_models']} distinct models of {N_ENVS} envs")
    for name, c in gs_cmp.items():
        if not c["outlier_envs"] <= allowed:
            fail(f"train_getup_shape kernel vs plain {name}: {c['outlier_envs']} envs beyond {c['tol']} "
                 f"(max {c['max']})")
    del res, gsenv, gst, gs_rows, gs_k, gs_p, gs_bm, gs_models

    # ---- getup_shape_tasks: the other getup tasks with shapes, 1 epoch each ---- #
    # env=amp_getup (K3-rows -> RA, the self obs in PyTorch: no K2),
    # env=im_mcp_getup over 3 fresh frozen columns and env=im_vae with
    # learning=im_z_fit (distillation from train_im's policy), each
    # K3-rows -> RA -> K2; the bank settled under the shared model (K3)
    gst_launches, gst_info = {}, {}

    def shape_route(env_) -> dict:
        return {"env": type(env_).__name__, "route": env_.physics_route, "fused": env_._fused_step_ok(),
                "shapes": env_.batched_model is not None and env_.batched_model.batched,
                "fall_settle_steps": env_.config.fall_settle_steps}

    want_tag = {"step_reward_amp": 0, "observe": 0, "physics_step": 0, "physics_step_rows": HORIZON,
                "reward_amp": HORIZON}
    res, n_, info, _ = train_amp("getup_shape_amp_getup", ["env=amp_getup", "env.shape_variation=true"], want_tag, 1,
                                 device_trace=False)
    gst_launches["amp_getup"], gst_info["amp_getup"] = n_, {**shape_route(res.agent.env), "losses": info["losses"],
                                                             "disc_loss": info["disc_loss"]}
    del res
    want_tmg = {"step_reward_amp": 0, "observe": HORIZON, "physics_step": 0, "physics_step_rows": HORIZON,
                "reward_amp": HORIZON}
    res, n_, info = train("getup_shape_mcp_getup", ["env=im_mcp_getup", "env.shape_variation=true"], want_tmg,
                          epochs=1, device_trace=False)
    gst_launches["im_mcp_getup"], gst_info["im_mcp_getup"] = n_, {**shape_route(res.agent.env),
                                                                  "losses": info["losses"]}
    del res
    d_epochs, d_epoch = [], DistillAgent.train_epoch

    def counted_shape_distill(agent, ds):
        before = dict(_build.launches)
        out = d_epoch(agent, ds)
        d_epochs.append({k: n - before[k] for k, n in _build.launches.items()})
        return out

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    DistillAgent.train_epoch = counted_shape_distill
    try:
        res = run.main(["env=im_vae", "learning=im_z_fit", "env.shape_variation=true", f"num_envs={N_ENVS}",
                        "max_epochs=1", "log_frequency=1", "device=cuda", f"output_dir={out_root}",
                        "exp_name=getup_shape_distill", f"learning.teacher_checkpoint={teacher_dir}"])
    finally:
        DistillAgent.train_epoch = d_epoch
    torch.cuda.synchronize()
    gst_launches["im_vae"] = dict(_build.launches)
    gst_info["im_vae"] = {**shape_route(res.agent.env), "launches_per_epoch": d_epochs,
                          "losses": [{k: m[k] for k in ("bc_loss", "kld", "ar1", "prior_reg")} for m in res.metrics]}
    if d_epochs != [want_tmg] or not all(math.isfinite(v) for m in gst_info["im_vae"]["losses"] for v in m.values()):
        fail(f"getup_shape_tasks im_vae: launches per epoch {d_epochs} (expected {want_tmg}), losses "
             f"{gst_info['im_vae']['losses']}")
    del res
    emit({"phase": "getup_shape_tasks", "card": card, "envs": N_ENVS, "launches": gst_launches, "tasks": gst_info})
    for task_, t_info in gst_info.items():
        settle_ = gst_launches[task_]["physics_step"]
        if (t_info["route"], t_info["fused"], t_info["shapes"]) != ("kernel", False, True) \
                or settle_ != t_info["fall_settle_steps"] or gst_launches[task_]["step_reward_amp"]:
            fail(f"getup_shape_tasks {task_}: {t_info}, launches {gst_launches[task_]}: expected K3-rows -> RA with "
                 f"per-env shapes and K3 on the settle only")

    # ---- curriculum: the PHC curriculum tool at 2048 envs, every stage -------- #
    # python -m pulse_tpu_torch.curriculum on the hard suite with r5's flags
    # (getup composer, sharp-turn ladder, specialists, amp_getup, gate
    # pretrain) at 2 epochs a stage (amp_getup 3: its schedule flips after
    # epoch 1), the specialists' and the ladder's evals every epoch. Two
    # eval outcomes are forced, since 2-epoch policies pass nothing: column
    # 0 passes fast_run (so that the composer has a column union to reach
    # and trains past its gate pretrain) and the ladder's first eval passes
    # level 0 (so that it advances); the real results are kept beside them.
    # Launches are read stage by stage (Curriculum._stage), epoch by epoch
    # and eval by eval
    from pulse_tpu_torch import curriculum as cur_mod

    cur_out = os.path.join(out_root, "curriculum")
    cur_args = ["--envs", str(PULSE_ENVS), "--epochs", str(CUR_EPOCHS), "--hard_epochs", str(CUR_EPOCHS),
                "--specialist_epochs", str(CUR_EPOCHS), "--composer_epochs", str(CUR_EPOCHS),
                "--amp_getup_epochs", str(CUR_EPOCHS + 1), "--max_specialists", "4", "--sharp_curriculum",
                "--composer_env", "getup", "--gate_pretrain_rounds", "2", "--spec_eval_every", "1",
                "--ladder_eval_every", "1", "--out", cur_out]
    r5_keys = json.load(open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "quality",
                                          "curriculum_r5.json")))

    def curriculum_run(label) -> tuple:
        """cur_mod.main(cur_args) with its launches read stage by stage:
        (report, stage records with launches, epochs, evals, forced)."""
        rec = {"stage": None, "stages": [], "epochs": [], "evals": [], "forced": [], "first_weights": {}}
        real_stage, real_eval = cur_mod.Curriculum._stage, cur_mod.im_eval
        ppo_epoch_, amp_epoch_ = PPOAgent.train_epoch, AMPAgent.train_epoch

        def stage(self, lbl, kind, body):
            rec["stage"] = lbl
            before = dict(_build.launches)
            t0_ = time.perf_counter()
            real_stage(self, lbl, kind, body)
            torch.cuda.synchronize()
            rec["stages"].append({"stage": lbl, "kind": kind, "seconds": time.perf_counter() - t0_,
                                  "launches": {k: n - before[k] for k, n in _build.launches.items()}})

        def counted(real):
            def epoch(agent, ts):
                net_ = getattr(ts, "ppo", ts).network
                rec["first_weights"].setdefault(rec["stage"], {k: v.detach().cpu().clone()
                                                               for k, v in net_.state_dict().items()})
                before = dict(_build.launches)
                out = real(agent, ts)
                rec["epochs"].append({"stage": rec["stage"], "env": type(agent.env).__name__,
                                      "launches": {k: n - before[k] for k, n in _build.launches.items()}})
                return out
            return epoch

        def evaluated(env_, policy_fn, batch_size=64):
            before = dict(_build.launches)
            r_ = real_eval(env_, policy_fn, batch_size=batch_size)
            kind = "mcp" if hasattr(env_, "pnn") else ("ladder" if env_.motion.num_motions == 5 else "suite")
            rec["evals"].append({"stage": rec["stage"], "kind": kind, "failed": r_.failed_motions.tolist(),
                                 "steps": math.ceil(float(env_.motion.motion_lengths.max())
                                                    / env_.model.config.control_dt),
                                 "launches": {k: n - before[k] for k, n in _build.launches.items()}})
            force = ((kind == "suite" and rec["stage"] == "col0")
                     or (kind == "ladder" and not any(e["kind"] == "ladder" for e in rec["evals"][:-1])))
            if force:
                failed_ = r_.failed_motions.copy()
                failed_[0] = False
                rec["forced"].append({"stage": rec["stage"], "kind": kind, "real": r_.failed_motions.tolist(),
                                      "forced": failed_.tolist()})
                r_ = dataclasses.replace(r_, failed_motions=failed_)
            return r_

        torch.cuda.synchronize()
        _build.reset_launch_counts()
        cur_mod.Curriculum._stage, cur_mod.im_eval = stage, evaluated
        PPOAgent.train_epoch, AMPAgent.train_epoch = counted(ppo_epoch_), counted(amp_epoch_)
        t0_ = time.perf_counter()
        try:
            report_ = cur_mod.main(cur_args)
        finally:
            cur_mod.Curriculum._stage, cur_mod.im_eval = real_stage, real_eval
            PPOAgent.train_epoch, AMPAgent.train_epoch = ppo_epoch_, amp_epoch_
        torch.cuda.synchronize()
        rec["seconds"] = time.perf_counter() - t0_
        rec["launches"] = dict(_build.launches)
        return report_, rec

    shutil.rmtree(cur_out, ignore_errors=True)
    cur_report, cur_rec = curriculum_run("curriculum")
    stage_labels = [x_["stage"] for x_ in cur_report["stages"]]
    kinds = [x_["kind"] for x_ in cur_report["stages"]]
    epoch_kinds = {"HumanoidImEnv": {"step_reward_amp": HORIZON, "observe": HORIZON, "physics_step": 0,
                                     "physics_step_rows": 0, "reward_amp": 0},
                   "HumanoidImGetupEnv": {"step_reward_amp": 0, "observe": HORIZON, "physics_step": HORIZON,
                                          "physics_step_rows": 0, "reward_amp": HORIZON}}
    epoch_kinds["HumanoidImMCPGetupEnv"] = epoch_kinds["HumanoidImGetupEnv"]
    # expected per stage: the stage's env builds, resets and evals beside its epochs
    settle_n = GetupConfig().fall_settle_steps
    stage_rows = []
    for st_ in cur_rec["stages"]:
        lbl = st_["stage"]
        ev = [x_ for x_ in cur_rec["evals"] if x_["stage"] == lbl]
        ep = [x_ for x_ in cur_rec["epochs"] if x_["stage"] == lbl]
        other = {k: st_["launches"][k] - sum(x_["launches"][k] for x_ in ev + ep) for k in st_["launches"]}
        want_other = dict.fromkeys(st_["launches"], 0)
        if lbl == "col0" or lbl.endswith("_ladder"):
            want_other["observe"] = 1                                   # the train state's reset
        if lbl == "amp_getup":
            want_other.update(physics_step=settle_n, observe=1)          # the getup env's settle and reset
        if lbl == "composer":
            rounds = 2 * 32                                             # gate pretrain: 2 rounds of 32 steps
            want_other.update(physics_step=settle_n, observe=2 + rounds, step_reward_amp=rounds)
        stage_rows.append({"stage": lbl, "seconds": st_["seconds"], "launches": st_["launches"],
                           "epochs": len(ep), "evals": len(ev), "other": other, "other_expected": want_other,
                           "epoch_envs": sorted({x_["env"] for x_ in ep})})
    emit({"phase": "curriculum", "card": card, "envs": PULSE_ENVS, "seconds": cur_rec["seconds"],
          "launches": cur_rec["launches"], "stages": stage_rows, "forced_evals": cur_rec["forced"],
          "report_stages": cur_report["stages"], "specialists": cur_report["specialists"],
          "columns_success": [c["success"] for c in cur_report["columns"]],
          "composer": {k: cur_report["composer"][k] for k in ("success", "mpjpe_pa_mm")},
          "column_union_success": cur_report["column_union_success"]})
    # the stages the tool's rules give on the evals it saw: 3 columns (no
    # column passes every clip), then up to 4 specialists, in clip order,
    # for the clips no column passes and no earlier specialist covers
    cols_ = cur_report["columns"]
    clip_names = list(cols_[0]["per_clip"])

    def fails(entry, n):
        return not entry["per_clip"][n]["success"]

    seen_ = cols_[:3]
    want_specs = []
    for clip_ in [x_ for x_ in clip_names if all(fails(c, x_) for c in cols_[:3])]:
        if len(want_specs) < 4 and all(fails(c, clip_) for c in seen_):
            want_specs.append(clip_)
            seen_ = cols_[:3 + len(want_specs)]
    spec_labels = [f"spec_{x_}" + ("_ladder" if x_ == "sharp_turns" else "") for x_ in want_specs]
    want_stages = [f"col{k}" for k in range(3)] + spec_labels + ["amp_getup", "composer"]
    if (stage_labels != want_stages or [c["stage"] for c in cols_] != want_stages[:-1]
            or cur_report["specialists"] != want_specs or "sharp_turns" not in want_specs):
        fail(f"curriculum: stages {stage_labels} (expected {want_stages} from the evals), columns "
             f"{[c['stage'] for c in cols_]}, specialists {cur_report['specialists']}")
    if kinds != ["column"] * 3 + ["specialist"] * len(want_specs) + ["amp_getup", "composer"]:
        fail(f"curriculum: stage kinds {kinds}")
    if not all(x_["finite_losses"] for x_ in cur_report["stages"]):
        fail(f"curriculum: a non-finite loss in {cur_report['stages']}")
    for ep_ in cur_rec["epochs"]:
        if ep_["launches"] != epoch_kinds.get(ep_["env"]):
            fail(f"curriculum {ep_['stage']}: an epoch on {ep_['env']} launched {ep_['launches']}")
    for ev_ in cur_rec["evals"]:
        want_e = {"step_reward_amp": ev_["steps"], "observe": ev_["steps"] + 1, "physics_step": 0,
                  "physics_step_rows": 0, "reward_amp": 0}
        if ev_["launches"] != want_e:
            fail(f"curriculum {ev_['stage']}: an eval launched {ev_['launches']} (expected {want_e})")
    for row in stage_rows:
        if row["other"] != row["other_expected"]:
            fail(f"curriculum {row['stage']}: launches beside its epochs and evals {row['other']} (expected "
                 f"{row['other_expected']})")
    want_epoch_envs = {"amp_getup": ["HumanoidImGetupEnv"], "composer": ["HumanoidImMCPGetupEnv"]}
    for row in stage_rows:
        if row["epochs"] == 0 or row["epoch_envs"] != want_epoch_envs.get(row["stage"], ["HumanoidImEnv"]):
            fail(f"curriculum {row['stage']}: {row['epochs']} epochs on {row['epoch_envs']}")
    ladder_levels = next(x_["ladder_levels"] for x_ in cur_report["stages"] if x_["stage"] == "spec_sharp_turns_ladder")
    if not ladder_levels or max(lv for _, lv in ladder_levels) < 1:
        fail(f"curriculum: the sharp-turn ladder did not advance: {ladder_levels}")
    # each column's first weights: the last column's, or column 0's
    for first_, src_ in [("col1", "col0"), ("col2", "col1"), ("amp_getup", "col0")] + [(x_, "col0") for x_ in spec_labels]:
        src_sd = torch.load(os.path.join(cur_out, f"{src_}.pt"), map_location="cpu", weights_only=True)["network"]
        w_ = cur_rec["first_weights"][first_]
        if not all(torch.equal(w_[k], v) for k, v in src_sd.items()):
            fail(f"curriculum: {first_}'s first weights are not {src_}'s last")
    missing = set(r5_keys) - set(cur_report)
    missing |= set(r5_keys["columns"][0]) - set(cur_report["columns"][0])
    partial = json.load(open(os.path.join(cur_out, "partial.json")))
    if missing or partial["status"] != "complete" or cur_report["composer"] is None:
        fail(f"curriculum: keys missing {missing}, partial.json status {partial['status']}")

    # ---- curriculum_resume: the same command into the same --out --------------- #
    res_report, res_rec = curriculum_run("curriculum_resume")
    emit({"phase": "curriculum_resume", "card": card, "seconds": res_rec["seconds"], "launches": res_rec["launches"],
          "stages": [{"stage": x_["stage"], "seconds": x_["seconds"], "launches": x_["launches"]}
                     for x_ in res_rec["stages"]], "evals": len(res_rec["evals"]),
          "report_equal_bitwise": {k: res_report[k] == cur_report[k] for k in ("columns", "composer", "final")}})
    eval_sum = {k: sum(x_["launches"][k] for x_ in res_rec["evals"]) for k in res_rec["launches"]}
    if res_rec["epochs"] or not all(x_["restored"] for x_ in res_report["stages"]) or res_rec["launches"] != eval_sum:
        fail(f"curriculum_resume: {len(res_rec['epochs'])} epochs trained, stages {res_report['stages']}, "
             f"launches {res_rec['launches']} against the evals' {eval_sum}")
    def same_result(a_, b_) -> bool:
        """Two result entries: the same stage, successes and per-clip
        outcomes, MPJPEs within 0.05 mm (the JSON's two decimals)."""
        return (a_["stage"] == b_["stage"] and a_["success"] == b_["success"]
                and all(a_["per_clip"][n]["success"] == b_["per_clip"][n]["success"] for n in a_["per_clip"])
                and all(abs(a_[k] - b_[k]) <= 0.05 for k in ("mpjpe_g_mm", "mpjpe_l_mm", "mpjpe_pa_mm")))

    res_cols = res_report["columns"] + [res_report["composer"]]
    cur_cols = cur_report["columns"] + [cur_report["composer"]]
    if (len(res_cols) != len(cur_cols) or not all(same_result(a_, b_) for a_, b_ in zip(res_cols, cur_cols))
            or res_report["specialists"] != cur_report["specialists"]):
        fail(f"curriculum_resume: columns {res_cols} differ from the first run's {cur_cols}")
    cur_phase_launches = {"curriculum": cur_rec["launches"], "curriculum_resume": res_rec["launches"]}
    del cur_rec, res_rec

    # ---- forward_pmcp: column k onto k+1 of the curriculum's frozen PNN -------- #
    from pulse_tpu_torch.scripts import forward_pmcp

    n_cols = len(cur_report["columns"])
    pnn_src = os.path.join(cur_out, f"pnn{n_cols}.pt")
    pnn_dst = os.path.join(cur_out, "pnn_forward.pt")
    t0 = time.perf_counter()
    forward_pmcp.main(["--ckpt", pnn_src, "--column", "0", "--out", pnn_dst])
    fp_s = time.perf_counter() - t0
    src_p = torch.load(pnn_src, weights_only=True)["params"]
    dst_p = torch.load(pnn_dst, weights_only=True)["params"]
    copied = all(torch.equal(dst_p[n.replace("col0_", "col1_")][leaf], src_p[n][leaf])
                 for n in src_p if n.startswith("col0_") for leaf in ("kernel", "bias"))
    kept = all(torch.equal(dst_p[n][leaf], src_p[n][leaf])
               for n in src_p if not n.startswith("col1_") for leaf in ("kernel", "bias"))
    emit({"phase": "forward_pmcp", "card": card, "columns": n_cols, "seconds": fp_s,
          "file_MB": os.path.getsize(pnn_src) / 2**20, "column0_copied_bitwise": copied, "others_kept": kept})
    if not (copied and kept) or sorted(dst_p) != sorted(src_p):
        fail(f"forward_pmcp: column 0 copied {copied}, other columns kept {kept}")
    shutil.rmtree(cur_out, ignore_errors=True)

    # ---- domain randomization: env=im learning=im_amp env.randomize=true ------ #
    # im.yaml's randomization_params: obs and action noise with held
    # correlated draws, per-env friction multipliers in [0.7, 1.3] on a
    # batched model, so every step is K3-rows -> RA -> K2 (never K1), then the
    # noise. shape_resampling_interval 2: the AMP agent re-draws the props
    # before epoch 3 (epoch % 2 == 1 past epoch 1), so 4 epochs
    from pulse_tpu_torch.env.domain_rand import apply_noise

    DR_EPOCHS = 4
    fric_rows = []

    def record_friction(agent, out):
        env_ = agent.env
        lay = substep_cuda.model_rows_layout(env_.model.num_bodies, int(env_.model.cp_body.shape[0]))[0]
        a_, b_ = lay["cp_friction"]
        fric_rows.append((env_.batched_model, env_._model_rows(N_ENVS)[:, a_:b_].clone()))

    want_dr = {"step_reward_amp": 0, "observe": HORIZON, "physics_step": 0, "physics_step_rows": HORIZON,
               "reward_amp": HORIZON}
    res, dr_launches, info, rows = train_amp("train_dr", ["env=im", "env.randomize=true",
                                                          "env.shape_resampling_interval=2"], want_dr, DR_EPOCHS,
                                             on_epoch=record_friction)
    denv_, dst = res.agent.env, res.train_state.ppo.env_state
    base_fric = denv_.model.cp_friction[None]
    mults = [r / base_fric for _, r in fric_rows]
    redraw_at = [i for i in range(1, DR_EPOCHS) if fric_rows[i][0] is not fric_rows[i - 1][0]]
    with torch.no_grad():
        # the kernel reads the re-drawn rows: K3-rows on the env's rows
        # against physics_step on its batched model; the pre-re-draw model's
        # step differs, so a stale rows cache would fail
        pd_d = denv_.action_to_pd_target(0.3 * torch.randn(N_ENVS, 69, generator=g, device=dev))
        k3r_dr = substep_cuda.physics_step_cuda(model, dst.physics, pd_d, model_rows=denv_._model_rows(N_ENVS))
        plain_dr = physics_step(denv_.batched_model, dst.physics, pd_d)
        old_dr = physics_step(fric_rows[1][0], dst.physics, pd_d)
        # the noise: one more step with the draws recorded; its obs minus K2's
        # clean obs of the merged state against the noise recomputed from
        # the held draw, the fresh draw and the pre-step DR counter
        drawn = {}
        real_draw = denv_._dr_draw

        def recording(name, shape, spec=None):
            drawn[name] = real_draw(name, shape, spec)
            return drawn[name]

        denv_._dr_draw = recording
        act_d = torch.clamp(policy_step(res.train_state.ppo.network, dst.obs, g,
                                        obs_rms=res.train_state.ppo.obs_rms)[0], -1.0, 1.0)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        nxt = denv_.step(dst, act_d)
        clean = denv_._observe(nxt)
        torch.cuda.synchronize()
        noise_launches = dict(_build.launches)
        del denv_._dr_draw
        spec_o = denv_.config.dr.observations
        want_obs = apply_noise(spec_o, clean, nxt.dr_corr_obs, drawn["obs"], dst.dr_step)
        noise_err = float((nxt.obs - want_obs).abs().max())
    k3r_cmp = {f: compare(getattr(k3r_dr, f), getattr(plain_dr, f), K1_TOL[f], N_ENVS) for f in PHYS_FIELDS}
    old_differ = envs_beyond(old_dr, plain_dr, N_ENVS)
    info.update(per_step(info), epochs_run=DR_EPOCHS, redraw_before_epochs=redraw_at,
                friction_mult_min=[float(m_.min()) for m_ in mults],
                friction_mult_max=[float(m_.max()) for m_ in mults],
                friction_distinct_envs=[int(m_[:, 0].unique().numel()) for m_ in mults],
                rows_changed_at_redraw=[not torch.equal(fric_rows[i][1], fric_rows[i - 1][1]) for i in redraw_at],
                K3rows_vs_plain_after_redraw=k3r_cmp, envs_where_old_props_step_differs=old_differ,
                noise_vs_recomputed_max_abs=noise_err, noise_max_abs=float((nxt.obs - clean).abs().max()),
                dr_step=int(dst.dr_step.max()), noise_step_launches=noise_launches,
                fused=denv_._fused_step_ok(), kernel_path=denv_._kernel_surface())
    emit(info)
    want_total = {"step_reward_amp": 0, "observe": DR_EPOCHS * HORIZON + 1, "physics_step": 0,
                  "physics_step_rows": DR_EPOCHS * HORIZON, "reward_amp": DR_EPOCHS * HORIZON}
    if dr_launches != want_total or info["fused"] or not info["kernel_path"]:
        fail(f"train_dr: launches {dr_launches} (expected {want_total}), K1 path {info['fused']}")
    if (min(info["friction_mult_min"]) < 0.7 - 1e-6 or max(info["friction_mult_max"]) > 1.3 + 1e-6
            or min(info["friction_distinct_envs"]) < N_ENVS // 2):
        fail(f"train_dr: friction multipliers outside [0.7, 1.3] or alike across envs: {info}")
    if redraw_at != [3] or not all(info["rows_changed_at_redraw"]) or torch.equal(fric_rows[3][1], fric_rows[1][1]):
        fail(f"train_dr: the props were re-drawn before epochs {redraw_at} (expected [3]), rows changed "
             f"{info['rows_changed_at_redraw']}")
    if any(c["outlier_envs"] > OUTLIER_FRAC * N_ENVS for c in k3r_cmp.values()) or old_differ <= OUTLIER_FRAC * N_ENVS:
        fail(f"train_dr: K3-rows on the re-drawn rows vs plain {k3r_cmp}; the old props' step differs in "
             f"{old_differ} envs")
    if noise_err > 1e-6 or info["noise_max_abs"] <= 1e-6:
        fail(f"train_dr: obs noise off by {noise_err} (noise {info['noise_max_abs']})")
    if noise_launches != {"step_reward_amp": 0, "observe": 2, "physics_step": 0, "physics_step_rows": 1,
                          "reward_amp": 1}:
        fail(f"train_dr: the noise step's launches {noise_launches}")
    del res, denv_, dst, nxt, clean, k3r_dr, plain_dr, old_dr, fric_rows

    # ---- PULSE stage 3: task policies in the distilled latent space ---------- #
    # run.main with learning=pulse_z_task (PPO with a 1024-512 policy over
    # 32-d latents, the 1024-512 discriminator, 0.5/0.5 task/style) on
    # env=speed_z and env=reach_z, the frozen PulseVAE and obs_rms read from
    # the distill phase's checkpoint. Each step: the frozen prior and decoder
    # (float32, autocast off), K3, then the task's reward, self obs, AMP row,
    # fall check and resets in plain PyTorch. Then test=true on each run's
    # checkpoint (task_eval at N_ENVS envs over one episode of Z_EVAL_STEPS:
    # that many K3 launches), and 8 acting steps each of env=im_z (K1 -> K2) and
    # env=traj_z (K3)
    from pulse_tpu_torch.env.humanoid_z import ZActionWrapper
    from pulse_tpu_torch.utils.config import load_config

    z_ckpt = os.path.join(out_root, "distill", "ckpt")
    z_sd = torch.load(run.latest_checkpoint(z_ckpt), map_location=dev, weights_only=True)["network"]
    want_z = {"step_reward_amp": 0, "observe": 0, "physics_step": HORIZON, "physics_step_rows": 0, "reward_amp": 0}
    z_steps = 8

    def decode_ms(zenv, st) -> float:
        """The frozen decode alone (prior, shift, decoder) at N_ENVS envs."""
        z_ = torch.rand(N_ENVS, zenv.action_dim, generator=g, device=dev) * 2.0 - 1.0
        return cuda_ms(lambda: zenv.decode_z(st.obs[:, : zenv.frozen.network.self_obs_dim], z_), 20)

    def train_z(exp: str, env_name: str) -> tuple:
        """train_amp on a Z task env, the Z gates, then test=true."""
        z_args = [f"env={env_name}", f"env.z_checkpoint={z_ckpt}"]
        res_, counts_, info_, rows_ = train_amp(exp, z_args, want_z, TRAIN_EPOCHS, learning="pulse_z_task")
        zenv, zts = res_.agent.env, res_.train_state.ppo
        zst = zts.env_state
        frozen_same = all(torch.equal(v, z_sd[k]) for k, v in zenv.frozen.network.state_dict().items())
        with torch.no_grad():
            pd_ = zenv.action_to_pd_target(0.3 * torch.randn(N_ENVS, zenv.env.action_dim, generator=g, device=dev))
            k3_ = substep_cuda.physics_step_cuda(zenv.model, zst.physics, pd_)
            plain_ = physics_step(zenv.model, zst.physics, pd_)
            dec_ms = decode_ms(zenv, zst)
        k3_cmp = {f: compare(getattr(k3_, f), getattr(plain_, f), K1_TOL[f], N_ENVS) for f in PHYS_FIELDS}
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0_ = time.perf_counter()
        ev = run.main([*z_args, "learning=pulse_z_task", f"num_envs={N_ENVS}", "test=true", "epoch=-1",
                       f"env.episode_length={Z_EVAL_STEPS}", "device=cuda", f"output_dir={out_root}",
                       f"exp_name={exp}"])
        torch.cuda.synchronize()
        ev_s, ev_launches = time.perf_counter() - t0_, dict(_build.launches)
        ev_steps = Z_EVAL_STEPS
        info_.update(per_step(info_), device_kernels_per_step=info_["rollout_device_kernels"] / HORIZON,
                     env=type(zenv.env).__name__, action_dim=zenv.action_dim,
                     policy_units=[m_.out_features for m_ in zts.network.actor if isinstance(m_, torch.nn.Linear)],
                     frozen_vae_unchanged=frozen_same, decode_ms=dec_ms,
                     terminations=[r["terminations"] for r in rows_], K3_vs_plain_last_state=k3_cmp,
                     task_eval={"envs": N_ENVS, "steps": ev_steps, "seconds": ev_s, "ms_per_step": 1e3 * ev_s / ev_steps,
                                "launches": ev_launches, **dataclasses.asdict(ev)})
        emit(info_)
        want_ev = {k: (ev_steps if k == "physics_step" else 0) for k in want_z}
        if (counts_ != {k: TRAIN_EPOCHS * n for k, n in want_z.items()} or not isinstance(zenv, ZActionWrapper)
                or zenv.action_dim != 32 or zts.network.mu.out_features != 32):
            fail(f"{exp}: launches {counts_}, action_dim {zenv.action_dim}")
        if not frozen_same:
            fail(f"{exp}: the frozen PulseVAE changed in training")
        if not sum(info_["terminations"]):
            fail(f"{exp}: no termination in {TRAIN_EPOCHS} epochs")
        if any(c["outlier_envs"] > OUTLIER_FRAC * N_ENVS for c in k3_cmp.values()):
            fail(f"{exp}: K3 on the run's last state against physics_step: {k3_cmp}")
        if ev_launches != want_ev or not all(math.isfinite(getattr(ev, k)) for k in
                                             ("return_mean", "length_mean", "terminate_rate", "reward_per_step")):
            fail(f"{exp}: test=true launches {ev_launches} (expected {want_ev}), result {ev}")
        return counts_, ev_launches

    speedz_launches, speedz_eval_launches = train_z("train_speed_z", "speed_z")
    reachz_launches, reachz_eval_launches = train_z("train_reach_z", "reach_z")

    zi = {"phase": "z_im_traj", "card": card, "envs": N_ENVS, "steps": z_steps}
    for env_name, want_ in (("im_z", dict(want_z, step_reward_amp=z_steps, observe=z_steps, physics_step=0)),
                            ("traj_z", dict(want_z, physics_step=z_steps))):
        zcfg = load_config([f"env={env_name}", "learning=pulse_z_task", f"env.z_checkpoint={z_ckpt}",
                            f"num_envs={N_ENVS}", "device=cuda"])
        zspec, zmodel = run.build_model_from_cfg(zcfg, dev)
        zenv = run.build_env_from_cfg(zcfg, zmodel, run.build_motion_from_cfg(zcfg, zspec, dev), dev)
        znet = ActorCritic(zenv.obs_dim, zenv.action_dim, actor_units=(1024, 512), critic_units=(1024, 512),
                           device=dev, seed=0)
        zrms = RunningMeanStd.create(zenv.obs_dim, device=dev)
        with torch.no_grad():
            zst = zenv.reset(N_ENVS)
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            for _ in range(z_steps):
                act_z = torch.clamp(policy_step(znet, zst.obs, g, obs_rms=zrms)[0], -1.0, 1.0)
                zst = zenv.step(zst, act_z)
            torch.cuda.synchronize()
            z_ms = 1e3 * (time.perf_counter() - t0) / z_steps
            z_launches = dict(_build.launches)
            z_busy, z_kern = device_busy(lambda: zenv.step(zst, act_z))
            z_dec = decode_ms(zenv, zst)
        zi[env_name] = {"env": type(zenv.env).__name__, "obs_dim": zenv.obs_dim, "action_dim": int(act_z.shape[1]),
                        "launches": z_launches, "ms_per_step": z_ms, "device_busy_ms_per_step": z_busy,
                        "device_kernels_per_step": z_kern, "decode_ms": z_dec,
                        "obs_finite": bool(torch.isfinite(zst.obs).all()), "resets": int(zst.done.sum())}
        if (z_launches != want_ or act_z.shape[1] != 32 or zenv.obs_dim != {"im_z": 934, "traj_z": 378}[env_name]
                or not zi[env_name]["obs_finite"]):
            fail(f"z_im_traj {env_name}: {zi[env_name]} (launches expected {want_})")
        del zenv, zst, znet
    emit(zi)
    im_z_launches, traj_z_launches = zi["im_z"]["launches"], zi["traj_z"]["launches"]

    # ---- pulse_stages: the PULSE three-stage quality harness ------------------ #
    # bench_pulse.main at PULSE_ENVS envs and full widths, PULSE_EPOCHS epochs
    # a stage, the full 300 prior steps at 256 envs and the full evals. The
    # launches are read by stage around the trainers' epochs, the evals and
    # prior sampling: K1 and K2 in the teacher, the student, both im_evals
    # (max_steps each, K2 once more at reset_to) and prior sampling, K2 once
    # at each imitation env reset; K3 only in the Z stages; no RA, no
    # K3-rows. Then K1 -> K2 on the student's last rollout state and on
    # prior sampling's last state, and K3 on each Z task's last training
    # state, against their plain versions
    import copy
    import importlib

    from pulse_tpu_torch import bench_pulse
    from pulse_tpu_torch.env.humanoid_task import HumanoidSpeedEnv
    from pulse_tpu_torch.learning.distill import DistillAgent

    im_eval_mod = importlib.import_module("pulse_tpu_torch.eval.im_eval")
    task_eval_mod = importlib.import_module("pulse_tpu_torch.eval.task_eval")
    pulse_out = os.path.join(out_root, "pulse_stages")
    by_stage, seen, ev_calls, last = {}, {}, [], {}

    def counted_call(real, label_of):
        def call(*a, **k):
            before = dict(_build.launches)
            out = real(*a, **k)
            label = label_of(*a)
            last[label] = (a, out)
            acc = by_stage.setdefault(label, dict.fromkeys(before, 0))
            for k_, n in _build.launches.items():
                acc[k_] += n - before[k_]
            return out
        return call

    def distill_label(agent, ds):
        seen["student"] = agent
        return "student"

    def z_label(agent, ts):
        seen["frozen"] = agent.env.frozen
        return "speed_z" if isinstance(agent.env.env, HumanoidSpeedEnv) else "reach_z"

    def im_eval_label(env_, *a):
        ev_calls.append(math.ceil(float(env_.motion.motion_lengths.max()) / env_.model.config.control_dt))
        return ("teacher_eval", "student_eval")[len(ev_calls) - 1]

    patched = [(PPOAgent, "train_epoch", lambda agent, ts: "teacher"), (DistillAgent, "train_epoch", distill_label),
               (AMPAgent, "train_epoch", z_label), (im_eval_mod, "im_eval", im_eval_label),
               (task_eval_mod, "task_eval",
                lambda env_, *a: "speed_z_eval" if isinstance(env_.env, HumanoidSpeedEnv) else "reach_z_eval"),
               (bench_pulse, "sample_prior", lambda *a: "prior")]
    originals = [(o_, n_, getattr(o_, n_)) for o_, n_, _ in patched]
    for o_, n_, label_of in patched:
        setattr(o_, n_, counted_call(getattr(o_, n_), label_of))
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        report = bench_pulse.main([f"--envs={PULSE_ENVS}", f"--teacher_epochs={PULSE_EPOCHS}",
                                   f"--distill_epochs={PULSE_EPOCHS}", f"--task_epochs={PULSE_EPOCHS}",
                                   f"--out={pulse_out}"])
    finally:
        for o_, n_, real in originals:
            setattr(o_, n_, real)
    torch.cuda.synchronize()
    pulse_s = time.perf_counter() - t0
    pulse_launches = dict(_build.launches)
    by_stage["resets"] = {k: n - sum(b[k] for b in by_stage.values()) for k, n in pulse_launches.items()}
    zero = dict.fromkeys(pulse_launches, 0)
    im_epoch = dict(zero, step_reward_amp=PULSE_EPOCHS * HORIZON, observe=PULSE_EPOCHS * HORIZON)
    z_epoch = dict(zero, physics_step=PULSE_EPOCHS * HORIZON)
    prior_steps = report["prior_sampling"]["steps"]
    want_stage = {"teacher": im_epoch, "student": im_epoch, "speed_z": z_epoch, "reach_z": z_epoch,
                  "speed_z_eval": dict(zero, physics_step=300), "reach_z_eval": dict(zero, physics_step=300),
                  "prior": dict(zero, step_reward_amp=prior_steps, observe=prior_steps),
                  # the teacher's and the student's agent.init and prior sampling's reset: one K2 each
                  "resets": dict(zero, observe=3)}
    for label, n_steps in zip(("teacher_eval", "student_eval"), ev_calls):
        want_stage[label] = dict(zero, step_reward_amp=n_steps, observe=n_steps + 1)
    # the student float32 on the card: its action_mu on the last rollout's
    # obs against a float64 copy, and against the same weights in bf16
    sagent = seen["student"]
    snet = sagent.network
    snap = torch.load(os.path.join(pulse_out, "student.pt"), map_location=dev, weights_only=True)
    with torch.no_grad():
        obs_n = RunningMeanStd(**snap["obs_rms"]).normalize(sagent._buffers.obs[-1])
        z0 = torch.zeros(obs_n.shape[0], snet.latent_dim, device=dev)
        mu32 = snet.latent_action(obs_n, z0)["action_mu"].double()
        mu64 = copy.deepcopy(snet).double().latent_action(obs_n.double(), z0.double())["action_mu"]
        mu16 = copy.deepcopy(snet).set_full_precision(False).latent_action(obs_n, z0)["action_mu"].double()
    err32, err16 = float((mu32 - mu64).abs().max()), float((mu16 - mu64).abs().max())
    fsd = seen["frozen"].network.state_dict()
    frozen_same = all(torch.equal(fsd[k], v) for k, v in snap["network"].items())
    metrics = {sec: report[sec] for sec in ("teacher", "student", "prior_sampling", "speed_z", "reach_z")}
    r5 = json.loads(bench_pulse.R5.read_text())
    emit({"phase": "pulse_stages", "card": card, "envs": PULSE_ENVS, "epochs": report["epochs"],
          "seconds_all": pulse_s, "launches": pulse_launches, "launches_by_stage": by_stage, **metrics,
          "timing": report["timing"], "targets": {k: t["pass"] for k, t in report["targets"].items()},
          "student_full_precision": snet.full_precision, "student_f32_vs_f64_max_abs": err32,
          "student_bf16_vs_f64_max_abs": err16, "frozen_vae_unchanged": frozen_same})
    if by_stage != want_stage:
        fail(f"pulse_stages: launches by stage {by_stage}, expected {want_stage}")
    if not set(r5) <= set(report) or len(report["targets"]) != 7:
        fail(f"pulse_stages: report keys {sorted(report)}, targets {sorted(report['targets'])}")
    if not (all(math.isfinite(v) for m in metrics.values() for v in m.values())
            and report["prior_sampling"]["finite"]):
        fail(f"pulse_stages: non-finite metrics {metrics}")
    if not (snet.full_precision and err32 <= 1e-4 < err16):
        fail(f"pulse_stages: the student against float64: {err32} (bf16 {err16}); full precision "
             f"{snet.full_precision}")
    if not frozen_same:
        fail("pulse_stages: the frozen PulseVAE changed in the Z training")

    def k1_k2_vs_plain(env_, st) -> dict:
        """K1 -> K2 on an imitation env's state against their plain
        versions, on the inputs its step gives them (the reference at the
        post-step time, then at the next control time, cycle offset included)
        and random actions."""
        n = st.motion_id.shape[0]
        progress = st.progress + 1
        with torch.no_grad():
            _, ref_ = env_._post_step_ref(st, progress)
            pd_ = env_.action_to_pd_target(0.3 * torch.randn(n, env_.model.num_dof, generator=g, device=dev))
            k1_ = cuda_obs.step_reward_amp(env_.model, env_.consts, st.physics, pd_, ref_)
            p1_ = cuda_obs.step_reward_amp_plain(env_.model, env_.consts, st.physics, pd_, ref_)
            t_next = env_._motion_time(st.motion_id, st.start_time, progress) + env_.model.config.control_dt
            ref_n = get_motion_state(env_.motion, st.motion_id, t_next,
                                     env_._cycle_offset(st.motion_id, st.start_time, progress))
            k2_ = cuda_obs.observe(env_.consts, k1_[0], ref_n, env_._shape_obs(n))
            p2_ = cuda_obs.observe_plain(env_.consts, k1_[0], ref_n, env_._shape_obs(n))
        cmp_ = {f: compare(getattr(k1_[0], f), getattr(p1_[0], f), K1_TOL[f], n) for f in PHYS_FIELDS}
        cmp_.update({nm: compare(a, b, K1_TOL[nm], n) for nm, a, b in zip(names, k1_[1:], p1_[1:])})
        cmp_["obs"] = compare(k2_, p2_, K2_TOL, n)
        return cmp_

    def k3_vs_plain(zenv, st) -> dict:
        """K3 on a Z task env's state against physics_step, random actions."""
        n = st.obs.shape[0]
        with torch.no_grad():
            pd_ = zenv.action_to_pd_target(0.3 * torch.randn(n, zenv.env.action_dim, generator=g, device=dev))
            k3_ = substep_cuda.physics_step_cuda(zenv.model, st.physics, pd_)
            plain_ = physics_step(zenv.model, st.physics, pd_)
        return {f: compare(getattr(k3_, f), getattr(plain_, f), K1_TOL[f], n) for f in PHYS_FIELDS}

    (s_agent, _), (s_ds, _) = last["student"]
    (p_env, *_), p_state = last["prior"]
    vs_plain = {"student_last_rollout_K1_K2": (PULSE_ENVS, k1_k2_vs_plain(s_agent.env, s_ds.env_state)),
                "prior_last_K1_K2": (p_state.obs.shape[0], k1_k2_vs_plain(p_env, p_state))}
    for stage in ("speed_z", "reach_z"):
        (z_agent, _), (z_ts, _) = last[stage]
        vs_plain[f"{stage}_last_K3"] = (PULSE_ENVS, k3_vs_plain(z_agent.env, z_ts.ppo.env_state))
    emit({"phase": "pulse_stages_vs_plain", "card": card,
          **{k: {"envs": n, **c} for k, (n, c) in vs_plain.items()}})
    for k, (n, c) in vs_plain.items():
        if n != {"prior_last_K1_K2": 256}.get(k, PULSE_ENVS) or any(
                v["outlier_envs"] > OUTLIER_FRAC * n for v in c.values()):
            fail(f"pulse_stages: {k} at {n} envs against the plain versions: {c}")

    # ---- env.use_pallas_physics=false: the plain versions in the kernels' place #
    # one env=im step from the same reset state (one generator seed) with the
    # key false (no launch) and true (K1, K2): the physics within K1_TOL in
    # all but 1% of the envs, and in the others the flags alike, the reward
    # within K1's 1e-4 and the observation within the stepped velocities'
    # 5e-3 (it reads them: K2's 1e-3 holds for one input state, not for two
    # states 5e-3 apart)
    pa = {}
    with torch.no_grad():
        for kernels_on in (False, True):
            aenv_ = HumanoidImEnv(model, motion, EnvConfig(use_pallas_physics=kernels_on), device=dev, seed=0)
            ast_ = aenv_.reset(N_ENVS)
            act_a = 0.5 * torch.randn(N_ENVS, 69, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            nxt_ = aenv_.step(ast_, act_a)
            torch.cuda.synchronize()
            pa[kernels_on] = (nxt_, dict(_build.launches), 1e3 * (time.perf_counter() - t0))
    (plain_st, plain_l, plain_ms_), (kern_st, kern_l, kern_ms_) = pa[False], pa[True]
    bad_ = torch.zeros(N_ENVS, dtype=torch.bool, device=dev)
    for f in PHYS_FIELDS:
        bad_ |= (getattr(plain_st.physics, f) - getattr(kern_st.physics, f)).abs().reshape(N_ENVS, -1).amax(1) > K1_TOL[f]
    ok_ = ~bad_
    pa_info = {"phase": "plain_arm", "card": card, "envs": N_ENVS, "launches_plain": plain_l, "launches_kernels": kern_l,
               "step_ms_plain": plain_ms_, "step_ms_kernels": kern_ms_, "physics_outlier_envs": int(bad_.sum()),
               "flags_differ": int((plain_st.done[ok_] != kern_st.done[ok_]).sum()),
               "reward_max_abs": float((plain_st.reward - kern_st.reward)[ok_].abs().max()),
               "obs_max_abs": float((plain_st.obs - kern_st.obs)[ok_].abs().max())}
    emit(pa_info)
    if (any(plain_l.values()) or kern_l["step_reward_amp"] != 1 or kern_l["observe"] != 1
            or pa_info["physics_outlier_envs"] > OUTLIER_FRAC * N_ENVS or pa_info["flags_differ"]
            or pa_info["reward_max_abs"] > K1_TOL["reward"] or pa_info["obs_max_abs"] > K1_TOL["body_vel"]):
        fail(f"plain_arm: {pa_info}")
    del pa, plain_st, kern_st, aenv_, ast_, nxt_

    # ---- demo: the live pose server's loop at 1 env on train_im's checkpoint - #
    # scripts/demo_server.demo_loop (what its main runs) with a real PoseServer
    # on 127.0.0.1 (port 0) and an in-process PoseClient (a socket timeout)
    # reading every frame; the client sends a clip switch after frame
    # DEMO_MOTION_AT and a driving pose after DEMO_POSE_AT, each applied
    # before the next step runs. Each step is K1 then K2; the loop's reset
    # and the clip switch's reset_to one K2 more each
    import threading

    from pulse_tpu_torch.ops import quat as dq
    from pulse_tpu_torch.scripts import common as script_common
    from pulse_tpu_torch.scripts import demo_server, record_rollout, sample_pulse
    from pulse_tpu_torch.utils.benchmarking import Timer
    from pulse_tpu_torch.utils.pose_server import PoseClient, PoseServer

    im_ckpt = os.path.join(out_root, "train_im", "ckpt")
    denv = script_common.make_env(dev)
    dpolicy = script_common.load_policy(denv, im_ckpt)
    drng = torch.Generator().manual_seed(16)
    dquat = torch.randn(4, generator=drng)
    d_motion = {"cmd": "motion", "id": 3, "time": 0.75}
    d_pose = {"cmd": "pose", "root_pos": [0.3, -0.2, 0.95], "root_rot": (dquat / dquat.norm()).tolist(),
              "dof_pos": (0.4 * torch.rand(69, generator=drng) - 0.2).tolist()}
    server = PoseServer(port=0)
    frames, viewer_err, applied = [], [], []
    try:
        client = PoseClient(port=server.port, timeout=DEMO_SOCKET_S)
        deadline = time.monotonic() + DEMO_SOCKET_S
        while server.num_clients < 1 and time.monotonic() < deadline:
            time.sleep(0.005)

        def viewer():
            try:
                for i_ in range(DEMO_STEPS):
                    frames.append(client.recv())
                    if i_ == DEMO_MOTION_AT:
                        client.send(d_motion)
                    elif i_ == DEMO_POSE_AT:
                        client.send(d_pose)
            except Exception as err:   # a timeout or a closed socket: the frame count tells
                viewer_err.append(repr(err))

        def on_command(i_, cmd, st_):
            ph_ = st_.physics
            rec = {"step": i_, "cmd": cmd["cmd"], "launches": dict(_build.launches)}
            if cmd["cmd"] == "motion":
                ref_ = get_motion_state(denv.motion, st_.motion_id, st_.start_time)
                rec.update(motion_id=int(st_.motion_id[0]), start_time=float(st_.start_time[0]),
                           progress=int(st_.progress[0]),
                           root_vs_reference=float((ph_.root_pos - ref_["root_pos"]).abs().max()))
            else:
                rec.update(root_pos=float((ph_.root_pos[0].cpu() - torch.tensor(cmd["root_pos"])).abs().max()),
                           root_rot=float((ph_.root_rot[0].cpu() - torch.tensor(cmd["root_rot"])).abs().max()),
                           dof=float((dq.quat_to_exp_map(ph_.joint_rot[0]).reshape(-1).cpu()
                                      - torch.tensor(cmd["dof_pos"])).abs().max()))
            applied.append(rec)

        th = threading.Thread(target=viewer, daemon=True)
        th.start()
        timer = Timer()
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        last = []
        with timer("demo_loop", block=True, result=last):
            last.append(demo_server.demo_loop(denv, dpolicy, server, DEMO_STEPS, on_command=on_command))
        d_launches = dict(_build.launches)
        th.join(DEMO_SOCKET_S)
        client.close()
    finally:
        server.close()
    d_ms = 1e3 * timer.totals["demo_loop"] / DEMO_STEPS
    want_d = {"step_reward_amp": DEMO_STEPS, "observe": DEMO_STEPS + 2, "physics_step": 0, "physics_step_rows": 0,
              "reward_amp": 0}
    d_ok_frames = [f_ for f_ in frames if len(f_["body_pos"]) == J and all(len(p_) == 3 for p_ in f_["body_pos"])
                   and all(math.isfinite(x_) for p_ in f_["body_pos"] for x_ in p_) and 0.0 <= f_["reward"] <= 1.0]
    demo_info = {"phase": "demo", "card": card, "envs": 1, "steps": DEMO_STEPS, "ms_per_step": d_ms,
                 "timer_report": timer.report(), "frames": len(frames), "frames_ok": len(d_ok_frames),
                 "viewer_error": viewer_err, "commands": applied, "launches": d_launches,
                 "checkpoint": run.latest_checkpoint(im_ckpt)}
    emit(demo_info)
    by_cmd = {a_["cmd"]: a_ for a_ in applied}
    mo, po = by_cmd.get("motion"), by_cmd.get("pose")
    if (len(frames) != DEMO_STEPS or len(d_ok_frames) != DEMO_STEPS or viewer_err or d_launches != want_d
            or len(applied) != 2 or mo is None or po is None):
        fail(f"demo: {demo_info}")
    if (mo["motion_id"] != d_motion["id"] % int(denv.motion.num_motions) or mo["start_time"] != d_motion["time"]
            or mo["progress"] != 0 or mo["root_vs_reference"] > MF_POS_TOL):
        fail(f"demo: the clip switch left {mo}")
    if max(po["root_pos"], po["root_rot"], po["dof"]) > MF_POS_TOL:
        fail(f"demo: the driving pose left {po}")
    # the launches before each command: one K1 a step, K2 one more at the reset
    # (and after the switch one more for its reset_to)
    if (mo["launches"]["step_reward_amp"] != mo["step"] or mo["launches"]["observe"] != mo["step"] + 2
            or po["launches"]["step_reward_amp"] != po["step"] or po["launches"]["observe"] != po["step"] + 2):
        fail(f"demo: launches at the commands {mo['launches']}, {po['launches']}")
    del denv, dpolicy, last

    # ---- demo_tasks: the demo task names through run.main's test=true -------- #
    # HumanoidImDemo on train_im's checkpoint against the eval phase's
    # HumanoidIm test=true run, HumanoidImMCPDemo and HumanoidImMCP on
    # train_mcp's: the class each builds, its launches and its metrics equal
    metric_keys = ("success_rate", "mpjpe_g", "mpjpe_l", "mpjpe_pa", "vel_dist", "accel_dist")

    def test_true(label, env_args, exp) -> tuple:
        built = []
        real_build = run.build_env_from_cfg

        def recording_build(*a_):
            built.append(real_build(*a_))
            return built[-1]

        run.build_env_from_cfg = recording_build
        try:
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            t0_ = time.perf_counter()
            result_ = run.main([*env_args, "learning=im_ppo", f"num_envs={N_ENVS}", "test=true", "epoch=-1",
                                "device=cuda", f"output_dir={out_root}", f"exp_name={exp}"])
            torch.cuda.synchronize()
            s_ = time.perf_counter() - t0_
        finally:
            run.build_env_from_cfg = real_build
        info_ = eval_checks(label, result_, built[0], 1, 1)
        info_.update(env_class=type(built[0]).__name__, seconds=s_)
        return result_, info_

    _, mcp_info = test_true("demo_tasks HumanoidImMCP", ["env=im_mcp"], "train_mcp")
    _, mcpd_info = test_true("demo_tasks HumanoidImMCPDemo", ["env=im_mcp", "env.task=HumanoidImMCPDemo"],
                             "train_mcp")
    _, imd_info = test_true("demo_tasks HumanoidImDemo", ["env=im", "env.task=HumanoidImDemo"], "train_im")
    cli_metrics = {k_: cli_info[k_] for k_ in (*metric_keys, "per_motion_steps", "failed_motions", "launches")}
    dt_info = {"phase": "demo_tasks", "card": card, "envs": N_ENVS, "HumanoidImDemo": imd_info,
               "HumanoidIm_eval_phase": cli_metrics, "HumanoidImMCPDemo": mcpd_info, "HumanoidImMCP": mcp_info}
    emit(dt_info)
    for demo_, base_, cls_ in ((imd_info, cli_info, "HumanoidImEnv"), (mcpd_info, mcp_info, "HumanoidImMCPEnv")):
        if demo_["env_class"] != cls_ or any(demo_[k_] != base_[k_] for k_ in (
                *metric_keys, "per_motion_steps", "failed_motions", "launches")):
            fail(f"demo_tasks: {demo_} against {base_}")
    if mcp_info["env_class"] != "HumanoidImMCPEnv":
        fail(f"demo_tasks: env=im_mcp built {mcp_info['env_class']}")
    demo_task_launches = {k_: sum(i_["launches"][k_] for i_ in (imd_info, mcpd_info, mcp_info))
                          for k_ in imd_info["launches"]}

    # ---- legacy_cli: the reference's old flag surface, in process ------------ #
    # --task HumanoidIm -> env=im learning=im_ppo at N_ENVS, 1 epoch: 32 K1 and
    # 32 K2, K2 once more at the agent's reset
    from pulse_tpu_torch import legacy_cli
    from pulse_tpu_torch.env.humanoid_im import HumanoidImEnv as ImEnv

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    lres = legacy_cli.main(["--task", "HumanoidIm", "--num_envs", str(N_ENVS), "--max_iterations", "1",
                            "--network_path", out_root, "--experiment", "legacy_cli", "--headless", "--rl_device",
                            "cuda:0"])
    torch.cuda.synchronize()
    legacy_s = time.perf_counter() - t0
    legacy_launches = dict(_build.launches)
    lcfg = json.load(open(os.path.join(out_root, "legacy_cli", "config.json")))
    l_info = {"phase": "legacy_cli", "card": card, "envs": N_ENVS, "epochs": len(lres.metrics), "seconds": legacy_s,
              "launches": legacy_launches, "env_class": type(lres.agent.env).__name__,
              "groups": [lcfg["env"]["task"], lcfg["learning"]["agent"]],
              "losses": {k_: lres.metrics[0][k_] for k_ in ("a_loss", "c_loss", "b_loss")},
              "reward_mean": lres.metrics[0]["reward_mean"],
              "checkpoint": run.latest_checkpoint(os.path.join(out_root, "legacy_cli", "ckpt"))}
    emit(l_info)
    want_l = {"step_reward_amp": HORIZON, "observe": HORIZON + 1, "physics_step": 0, "physics_step_rows": 0,
              "reward_amp": 0}
    if (legacy_launches != want_l or type(lres.agent.env) is not ImEnv or len(lres.metrics) != 1
            or l_info["groups"] != ["HumanoidIm", "ppo"] or not l_info["checkpoint"]
            or not all(math.isfinite(v_) for v_ in l_info["losses"].values())):
        fail(f"legacy_cli: {l_info}")
    del lres

    # ---- record_sample: record_rollout and sample_pulse at their defaults ---- #
    # each script's main (4 and 2 envs, 300 steps): the policy of train_im's
    # checkpoint, and PULSE's prior on the distill phase's PulseVAE with
    # early termination off (no termination; each episode ends only at
    # episode_length, 300 steps: at the last step); one reset (K2) then
    # K1 -> K2 each step
    def script_run(main_fn, argv) -> tuple:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0_ = time.perf_counter()
        out_ = main_fn(argv)
        torch.cuda.synchronize()
        return out_, dict(_build.launches), time.perf_counter() - t0_

    rec_npz = os.path.join(out_root, "rollout.npz")
    smp_npz = os.path.join(out_root, "pulse_samples.npz")
    _, rec_launches, rec_s = script_run(record_rollout.main, ["--ckpt", im_ckpt, "--out", rec_npz])
    smp, smp_launches, smp_s = script_run(sample_pulse.main,
                                          ["--ckpt", os.path.join(out_root, "distill", "ckpt"), "--out", smp_npz])
    import numpy as np

    with np.load(rec_npz) as d_:
        rec_shapes = {k_: list(d_[k_].shape) for k_ in d_.files}
        rec_finite = bool(np.isfinite(d_["all_body_pos"]).all() and np.isfinite(d_["body_rot"]).all())
        rec_reward = [float(d_["rewards"].min()), float(d_["rewards"].max())]
    with np.load(smp_npz) as d_:
        smp_shapes = {k_: list(d_[k_].shape) for k_ in d_.files}
        smp_finite = bool(np.isfinite(d_["all_body_pos"]).all())
        smp_root_z = [float(d_["all_body_pos"][..., 0, 2].min()), float(d_["all_body_pos"][..., 0, 2].max())]
    want_rs = {"step_reward_amp": RS_STEPS, "observe": RS_STEPS + 1, "physics_step": 0, "physics_step_rows": 0,
               "reward_amp": 0}
    rs_info = {"phase": "record_sample", "card": card, "steps": RS_STEPS,
               "record_rollout": {"envs": 4, "seconds": rec_s, "ms_per_step": 1e3 * rec_s / RS_STEPS,
                                  "launches": rec_launches, "shapes": rec_shapes, "finite": rec_finite,
                                  "reward_min_max": rec_reward},
               "sample_pulse": {"envs": 2, "seconds": smp_s, "ms_per_step": 1e3 * smp_s / RS_STEPS,
                                "launches": smp_launches, "shapes": smp_shapes, "finite": smp_finite,
                                "terminations": smp["terminations"], "episodes_ended": smp["episodes_ended"],
                                "root_z_min_max": smp_root_z}}
    emit(rs_info)
    if (rec_launches != want_rs or rec_shapes != {"body_pos": [RS_STEPS, J, 3], "body_rot": [RS_STEPS, J, 4],
                                                  "all_body_pos": [RS_STEPS, 4, J, 3], "rewards": [RS_STEPS, 4],
                                                  "node_names": [J], "parents": [J]}
            or not rec_finite or rec_reward[0] < 0.0 or rec_reward[1] > 1.0):
        fail(f"record_sample: record_rollout {rs_info['record_rollout']}")
    if (smp_launches != want_rs or smp_shapes != {"body_pos": [RS_STEPS, J, 3], "all_body_pos": [RS_STEPS, 2, J, 3],
                                                  "node_names": [J], "parents": [J]}
            or not smp_finite or smp["terminations"] != 0
            or smp["episodes_ended"] != 2 * (RS_STEPS // EnvConfig().episode_length)):
        fail(f"record_sample: sample_pulse {rs_info['sample_pulse']}")
    del smp
    shutil.rmtree(out_root, ignore_errors=True)

    # ---- control modes: isaac_pd, pd and force on the general step ------------ #
    # From the standing reference state at clip time 0 (velocities zeroed),
    # CONTROL_STEPS steps: isaac_pd and pd with the action whose PD target
    # is the start pose, force with zero torque. isaac_pd keeps the body's
    # height; the limp force-mode body sinks (its limbs first: the mean body
    # height, not yet the root's). pd and force run plain PyTorch on the
    # card (the JAX package runs them in XLA), so no kernel launches.
    from pulse_tpu_torch.physics.state import dof_pos_from_state

    cm_info = {"phase": "control_modes", "card": card, "envs": N_ENVS, "steps": CONTROL_STEPS}
    for mode in ("isaac_pd", "pd", "force"):
        cenv = HumanoidImEnv(model, motion, EnvConfig(control_mode=mode, enable_early_termination=False), device=dev,
                             seed=0)
        with torch.no_grad():
            cst = cenv.reset_to(torch.arange(N_ENVS, device=dev) % 4, torch.zeros(N_ENVS, device=dev))
            cst = cst.replace(physics=cst.physics.replace(root_vel6=torch.zeros_like(cst.physics.root_vel6),
                                                          joint_omega=torch.zeros_like(cst.physics.joint_omega)))
            hold = torch.clamp((dof_pos_from_state(cst.physics) - model.pd_action_offset) / model.pd_action_scale,
                               -1.0, 1.0)
            act_c = torch.zeros_like(hold) if mode == "force" else hold
            z0, b0 = cst.physics.root_pos[:, 2].clone(), cst.physics.body_pos[..., 2].mean(dim=1)
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            for _ in range(CONTROL_STEPS):
                cst = cenv.step(cst, act_c)
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t0) / CONTROL_STEPS
            c_launches = dict(_build.launches)
            busy_c, kern_c = device_busy(lambda: cenv.step(cst, act_c))
        finite = all(bool(torch.isfinite(getattr(cst.physics, f)).all()) for f in PHYS_FIELDS)
        cm_info[mode] = {"root_dz_mean": float((cst.physics.root_pos[:, 2] - z0).mean()),
                         "root_dz_min": float((cst.physics.root_pos[:, 2] - z0).min()),
                         "body_dz_mean": float((cst.physics.body_pos[..., 2].mean(dim=1) - b0).mean()),
                         "finite": finite, "ms_per_step": step_ms, "device_busy_ms_per_step": busy_c,
                         "device_kernels_per_step": kern_c, "launches": c_launches,
                         "kernel_path": cenv._kernel_surface()}
        del cenv, cst
    emit(cm_info)
    want_c = {"step_reward_amp": CONTROL_STEPS, "observe": CONTROL_STEPS, "physics_step": 0, "physics_step_rows": 0,
              "reward_amp": 0}
    zero_c = {k: 0 for k in want_c}
    if (cm_info["isaac_pd"]["launches"] != want_c or cm_info["pd"]["launches"] != zero_c
            or cm_info["force"]["launches"] != zero_c or cm_info["pd"]["kernel_path"]
            or cm_info["force"]["kernel_path"]):
        fail(f"control_modes: launches or paths {cm_info}")
    if not all(cm_info[m_]["finite"] for m_ in ("isaac_pd", "pd", "force")):
        fail(f"control_modes: non-finite state {cm_info}")
    if abs(cm_info["isaac_pd"]["body_dz_mean"]) > 0.005 or cm_info["force"]["body_dz_mean"] > -0.005:
        fail(f"control_modes: isaac_pd should keep the body's height and force lose it: {cm_info}")

    # ---- perturb: projectiles through HumanoidImPerturbEnv --------------------- #
    from pulse_tpu_torch.env.humanoid_im_perturb import HumanoidImPerturbEnv, PerturbConfig
    from pulse_tpu_torch.physics.prop import make_prop_state
    from pulse_tpu_torch.physics.step import physics_step_with_prop

    # early termination off, so that every env lives to relaunch at 7, 15 and
    # 23 unless its clip ends
    penv = HumanoidImPerturbEnv(model, motion, PerturbConfig(proj_interval=PROJ_INTERVAL,
                                                             enable_early_termination=False), device=dev, seed=0)
    pnet = ActorCritic(penv.obs_dim, penv.action_dim, device=dev, seed=0)
    prms = RunningMeanStd.create(penv.obs_dim, device=dev)
    relaunch_by_progress, wrong_relaunch, contact_envs = {}, 0, torch.zeros(N_ENVS, dtype=torch.bool, device=dev)
    real_launch = penv._launch
    with torch.no_grad():
        pst, prop = penv.reset(N_ENVS)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(PERTURB_STEPS):
            launched = {}

            def launch(root_pos, launched=launched):
                launched["prop"] = real_launch(root_pos)
                return launched["prop"]

            penv._launch = launch
            pre = pst.progress.clone()
            act_p = torch.clamp(policy_step(pnet, pst.obs, g, obs_rms=prms)[0], -1.0, 1.0)
            pst, prop = penv.step((pst, prop), act_p)
            mask = pre % PROJ_INTERVAL == PROJ_INTERVAL - 1
            took = (prop.pos == launched["prop"].pos).all(dim=1) & (prop.lin_vel == launched["prop"].lin_vel).all(dim=1)
            wrong_relaunch += int((took != mask).sum())
            for p_ in pre[mask].unique().tolist():
                relaunch_by_progress[p_] = relaunch_by_progress.get(p_, 0) + int((pre[mask] == p_).sum())
            contact_envs |= penv.prop_contact.abs().sum(dim=1) > 0
        torch.cuda.synchronize()
        p_ms = 1e3 * (time.perf_counter() - t0) / PERTURB_STEPS
        p_launches = dict(_build.launches)
        penv._launch = real_launch
        p_busy, p_kern = device_busy(lambda: penv.step((pst, prop), act_p))
        # the coupled step with the prop parked out of reach against K3 on the
        # same state and PD targets
        parked = make_prop_state(torch.tensor([[200.0, 200.0, 0.3]], device=dev).expand(N_ENVS, 3).contiguous())
        pd_p = penv.action_to_pd_target(act_p)
        coupled, _, parked_contact = physics_step_with_prop(model, penv.proj_spec, pst.physics, parked, pd_p)
        k3_p = substep_cuda.physics_step_cuda(model, pst.physics, pd_p)
    coupled_cmp = {f: compare(getattr(coupled, f), getattr(k3_p, f), K1_TOL[f], N_ENVS) for f in PHYS_FIELDS}
    p_info = {"phase": "perturb", "card": card, "envs": N_ENVS, "steps": PERTURB_STEPS,
              "proj_interval": PROJ_INTERVAL, "relaunches_by_pre_step_progress": relaunch_by_progress,
              "envs_relaunched_when_not_due_or_not_when_due": wrong_relaunch,
              "envs_with_prop_contact": int(contact_envs.sum()), "resets": int(pst.done.sum()),
              "ms_per_step": p_ms, "device_busy_ms_per_step": p_busy, "device_kernels_per_step": p_kern,
              "launches": p_launches, "parked_prop_contact_max": float(parked_contact.abs().max()),
              "coupled_parked_vs_K3": coupled_cmp, "obs_finite": bool(torch.isfinite(pst.obs).all())}
    emit(p_info)
    if wrong_relaunch or any(relaunch_by_progress.get(p_, 0) == 0 for p_ in (7, 15, 23)) or any(
            p_ % PROJ_INTERVAL != PROJ_INTERVAL - 1 for p_ in relaunch_by_progress):
        fail(f"perturb: relaunches {relaunch_by_progress}, {wrong_relaunch} env-steps off the schedule")
    if not p_info["envs_with_prop_contact"] or not p_info["obs_finite"] or any(p_launches.values()):
        fail(f"perturb: {p_info['envs_with_prop_contact']} envs hit, obs finite {p_info['obs_finite']}, "
             f"launches {p_launches}")
    if p_info["parked_prop_contact_max"] or any(c["outlier_envs"] > OUTLIER_FRAC * N_ENVS
                                                for c in coupled_cmp.values()):
        fail(f"perturb: the out-of-reach coupled step against K3: {coupled_cmp}")
    del penv, pnet, pst, prop, coupled, k3_p

    # ---- import_pth: the reference's .pth checkpoints ------------------------ #
    # Reference-layout files (torch modules laid out as the rl-games builders
    # lay them out, saved under their key names) at the configs' widths: a
    # PNN of env.num_prim (3) columns of learning.pnn_units (512-512) over
    # the 934-wide obs with its lateral stacks and running stats, a 512-256
    # composer over 3 primitives, and a PulseVAE at im_z_fit's widths with
    # running stats. Each imported network against the module it was saved
    # from (float32, TF32 off); then 2 epochs each of env=im_mcp on the
    # imported PNN (K1 -> K2), distillation from the PNN and composer
    # teacher (K3 -> RA -> K2) and speed_z on the imported PulseVAE (K3)
    import tempfile

    from torch import nn as tnn

    from pulse_tpu_torch.env.humanoid_strike import HumanoidStrikeEnv
    from pulse_tpu_torch.env.humanoid_task import TaskConfig
    from pulse_tpu_torch.env.humanoid_terrain import HumanoidPedestrianTerrainEnv
    from pulse_tpu_torch.ops import quat as oq
    from pulse_tpu_torch.utils import checkpoint as ref_ck

    def seq(in_dim, units, final=None, act=tnn.SiLU):
        layers = []
        for u in units:
            layers += [tnn.Linear(in_dim, u), act()]
            in_dim = u
        if final is not None:
            layers.append(tnn.Linear(in_dim, final))
        return tnn.Sequential(*layers)

    class RefPNN(tnn.Module):
        """The reference PNN: columns [Linear, act, Linear, act, Linear];
        u[c-1][pc] = bias-free [Linear(u0 -> u1), Linear(u1 -> out)], of
        which the forward uses the first, at the second hidden layer."""

        def __init__(self, in_dim, units, out_dim, n):
            super().__init__()
            self.actors = tnn.ModuleList([seq(in_dim, units, out_dim, tnn.ReLU) for _ in range(n)])
            self.u = tnn.ModuleList([tnn.ModuleList([tnn.Sequential(tnn.Linear(units[0], units[1], bias=False),
                                                                    tnn.Linear(units[1], out_dim, bias=False))
                                                     for _ in range(c + 1)]) for c in range(n - 1)])

        def forward(self, x):
            acts1, outs = [], []
            for c, a in enumerate(self.actors):
                h1 = a[:2](x)
                lat = sum((self.u[c - 1][pc][0](acts1[pc]) for pc in range(c)), torch.zeros((), device=x.device))
                outs.append(a[4](a[3](a[2](h1) + lat)))
                acts1.append(h1)
            return torch.stack(outs, dim=-2)

    def prefixed(prefix, module):
        return {f"{prefix}.{k}": v.detach().cpu() for k, v in module.state_dict().items()}

    def rms_sd(dim, seed):
        g_ = torch.Generator().manual_seed(seed)
        return {"running_mean_std.running_mean": 0.1 * torch.randn(dim, generator=g_, dtype=torch.float64),
                "running_mean_std.running_var": 1.0 + torch.rand(dim, generator=g_, dtype=torch.float64),
                "running_mean_std.count": torch.tensor(1.0e6, dtype=torch.float64)}

    pth_dir = tempfile.mkdtemp(prefix="chip_smoke_pth_")
    obs_w, self_w, lat_w = 934, 358, 32
    lz = load_config(["env=im_vae", "learning=im_z_fit"])["learning"]
    n_prim = int(load_config(["env=im_mcp"])["env"]["num_prim"])
    torch.manual_seed(31)
    ref_pnn = RefPNN(obs_w, (512, 512), 69, n_prim)
    pnn_rms = rms_sd(obs_w, 1)
    pnn_pth = os.path.join(pth_dir, "pnn.pth")
    torch.save({"model": {**prefixed("a2c_network.pnn", ref_pnn), **pnn_rms}, "epoch": 1}, pnn_pth)
    ref_comp = seq(obs_w, (512, 256), n_prim, tnn.ReLU)
    comp_pth = os.path.join(pth_dir, "composer.pth")
    torch.save({"model": prefixed("a2c_network.composer", ref_comp), "epoch": 1}, comp_pth)
    vae_mods = {"z_mlp": seq(obs_w, lz["encoder_units"], 5 * lat_w), "z_mu": tnn.Linear(5 * lat_w, lat_w),
                "z_logvar": tnn.Linear(5 * lat_w, lat_w), "z_prior": seq(self_w, lz["prior_units"]),
                "z_prior_mu": tnn.Linear(lz["prior_units"][-1], lat_w),
                "z_prior_logvar": tnn.Linear(lz["prior_units"][-1], lat_w),
                "actor_mlp": seq(self_w + lat_w, lz["decoder_units"]), "mu": tnn.Linear(lz["decoder_units"][-1], 69),
                "critic_mlp": seq(obs_w, (2048, 1536, 1024)), "value": tnn.Linear(1024, 1)}
    vae_pth = os.path.join(pth_dir, "pulse.pth")
    vae_sd = {k: v for name, m_ in vae_mods.items() for k, v in prefixed(f"a2c_network.{name}", m_).items()}
    torch.save({"model": {**vae_sd, **rms_sd(obs_w, 2)}, "epoch": 1}, vae_pth)
    pth_mb = sum(os.path.getsize(os.path.join(pth_dir, f_)) for f_ in os.listdir(pth_dir)) / 2**20

    # each importer's network against the module it was saved from
    imp = {}
    with torch.no_grad():
        x_ = torch.randn(N_ENVS, obs_w, generator=g, device=dev)
        z_ = torch.randn(N_ENVS, lat_w, generator=g, device=dev)
        sd_ = ref_ck.load_torch_checkpoint(pnn_pth)["model"]
        i_pnn, pnn_info = ref_ck.import_pnn(sd_, device=dev)
        imp["pnn"] = float((i_pnn(x_) - ref_pnn.to(dev)(x_)).abs().max())
        i_comp = ref_ck.import_mcp_composer(ref_ck.load_torch_checkpoint(comp_pth)["model"], final="relu", device=dev)
        imp["composer"] = float((i_comp(x_) - torch.relu(ref_comp.to(dev)(x_))).abs().max())
        i_rms = ref_ck.import_running_mean_std(sd_, device=dev)
        imp["running_mean_std"] = float((i_rms.mean.double().cpu() - pnn_rms["running_mean_std.running_mean"]).abs().max())
        vsd_ = ref_ck.load_torch_checkpoint(vae_pth)["model"]
        i_vae = ref_ck.import_pulse_vae(vsd_, full_precision=True, device=dev)
        m_ = {k: v.to(dev) for k, v in vae_mods.items()}
        out_ = i_vae(x_, z_)
        h_ = m_["z_mlp"](x_)
        post_mu, post_lv = m_["z_mu"](h_), m_["z_logvar"](h_)
        ph_ = m_["z_prior"](x_[:, :self_w])
        prior_mu = m_["z_prior_mu"](ph_)
        want_ = {"post_mu": post_mu, "post_logvar": post_lv, "prior_mu": prior_mu,
                 "prior_logvar": torch.clamp(m_["z_prior_logvar"](ph_), -8.0, 2.0),
                 "action_mu": m_["mu"](m_["actor_mlp"](torch.cat([x_[:, :self_w],
                                                                  prior_mu + post_mu + torch.exp(0.5 * post_lv) * z_],
                                                                 -1))),
                 "value": m_["value"](m_["critic_mlp"](x_))[:, 0]}
        imp.update({f"pulse_vae_{k}": float((out_[k] - v).abs().max()) for k, v in want_.items()})
        del x_, z_, out_, h_, m_, i_vae, i_comp
    imp_spec = ref_ck.pulse_vae_spec_from_torch(vsd_)
    emit({"phase": "import_pth", "card": card, "files_MB": pth_mb, "pnn": pnn_info,
          "pulse_vae_spec": {k: list(v) if isinstance(v, tuple) else v for k, v in imp_spec.items()},
          "max_abs_vs_saved_module": imp, "tol": 1e-5})
    if max(imp.values()) > 1e-5 or pnn_info["num_primitives"] != n_prim or not pnn_info["has_lateral"]:
        fail(f"import_pth: the imported networks against the saved modules {imp}, {pnn_info}")

    # env=im_mcp on the imported PNN: K1 -> K2 as train_mcp
    res, pth_mcp_launches, info = train("import_pth_mcp", ["env=im_mcp", f"env.pnn_checkpoint={pnn_pth}"], want_mcp)
    menv, mst = res.agent.env, res.train_state.env_state
    mcp_frozen = all(torch.equal(v, i_pnn.state_dict()[k]) for k, v in menv.pnn.state_dict().items())
    mcp_cmp = k1_k2_vs_plain(menv, mst)
    info.update(per_step(info), action_dim=menv.action_dim, pnn_frozen_unchanged=mcp_frozen,
                pnn_obs_rms_frozen=bool(menv.pnn_obs_rms.frozen), K1_K2_vs_plain_last_state=mcp_cmp)
    emit(info)
    want_total = dict(want_mcp, step_reward_amp=TRAIN_EPOCHS * HORIZON, observe=TRAIN_EPOCHS * HORIZON + 1)
    if (pth_mcp_launches != want_total or menv.action_dim != n_prim or not mcp_frozen
            or any(c["outlier_envs"] > OUTLIER_FRAC * N_ENVS for c in mcp_cmp.values())):
        fail(f"import_pth_mcp: launches {pth_mcp_launches} (expected {want_total}), PNN unchanged {mcp_frozen}, "
             f"K1 / K2 vs plain {mcp_cmp}")
    del res, menv, mst

    # distillation from the PNN and composer teacher: K3 -> RA -> K2
    pth_epoch_launches = []

    def counted_pth_epoch(agent, ds):
        before = dict(_build.launches)
        out = distill_epoch(agent, ds)
        pth_epoch_launches.append({k: n - before[k] for k, n in _build.launches.items()})
        return out

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    DistillAgent.train_epoch = counted_pth_epoch
    t0 = time.perf_counter()
    try:
        res = run.main(["env=im_vae", "learning=im_z_fit", f"num_envs={N_ENVS}", f"max_epochs={TRAIN_EPOCHS}",
                        "log_frequency=1", "device=cuda", f"output_dir={out_root}", "exp_name=import_pth_distill",
                        f"learning.teacher_pnn_checkpoint={pnn_pth}", f"learning.teacher_composer_checkpoint={comp_pth}"])
    finally:
        DistillAgent.train_epoch = distill_epoch
    torch.cuda.synchronize()
    pd_s, pd_counts = time.perf_counter() - t0, dict(_build.launches)
    tf_ = res.agent.teacher_fn
    teacher_same = (all(torch.equal(v, i_pnn.state_dict()[k]) for k, v in tf_.pnn.state_dict().items())
                    and all(torch.equal(v, ref_ck.import_mcp_composer(ref_ck.load_torch_checkpoint(comp_pth)["model"],
                                                                      final="relu", device=dev).state_dict()[k])
                            for k, v in tf_.composer.state_dict().items()))
    denv, dst = res.agent.env, res.train_state.env_state
    n_ = N_ENVS
    with torch.no_grad():
        progress = dst.progress + 1
        _, ref_ = denv._post_step_ref(dst, progress)
        pd_ = denv.action_to_pd_target(0.3 * torch.randn(n_, 69, generator=g, device=dev))
        k3_ = substep_cuda.physics_step_cuda(denv.model, dst.physics, pd_)
        plain3_ = physics_step(denv.model, dst.physics, pd_)
        ra_ = cuda_obs.reward_amp(denv.consts, k3_, ref_, *denv._disc_parts(n_))
        plain_ra = cuda_obs.reward_amp_plain(denv.consts, k3_, ref_, *denv._disc_parts(n_))
        st_ = dst.replace(physics=k3_, progress=progress)
        t_next = denv._motion_time(st_.motion_id, st_.start_time, progress) + denv.model.config.control_dt
        ref_n = get_motion_state(denv.motion, st_.motion_id, t_next,
                                 denv._cycle_offset(st_.motion_id, st_.start_time, progress))
        k2_ = cuda_obs.observe(denv.consts, k3_, ref_n, denv._shape_obs(n_))
        plain2_ = cuda_obs.observe_plain(denv.consts, k3_, ref_n, denv._shape_obs(n_))
    d_cmp = {f: compare(getattr(k3_, f), getattr(plain3_, f), K1_TOL[f], n_) for f in PHYS_FIELDS}
    d_cmp.update({nm: compare(a, b, K1_TOL[nm], n_) for nm, a, b in zip(names, ra_, plain_ra)})
    d_cmp["obs"] = compare(k2_, plain2_, K2_TOL, n_)
    ms = res.metrics
    want_d = {"step_reward_amp": 0, "observe": HORIZON, "physics_step": HORIZON, "physics_step_rows": 0,
              "reward_amp": HORIZON}
    settle = pd_counts["physics_step"] - sum(el["physics_step"] for el in pth_epoch_launches)
    info = {"phase": "import_pth_distill", "card": card, "envs": N_ENVS, "epochs": len(ms), "seconds_all": pd_s,
            "launches": pd_counts, "launches_per_epoch": pth_epoch_launches, "bc_loss": [m["bc_loss"] for m in ms],
            "teacher_frozen_unchanged": teacher_same, "teacher_obs_rms_frozen": bool(tf_.obs_rms.frozen),
            "K3_RA_K2_vs_plain_last_state": d_cmp,
            "rollout_ms": [1e3 * m["rollout_s"] for m in ms[1:]], "update_ms": [1e3 * m["update_s"] for m in ms[1:]],
            "train_env_steps_per_s": [per_epoch / (m["rollout_s"] + m["update_s"]) for m in ms[1:]]}
    emit(info)
    if (len(pth_epoch_launches) != TRAIN_EPOCHS or any(el != want_d for el in pth_epoch_launches)
            or settle != denv.config.fall_settle_steps or pd_counts["observe"] - TRAIN_EPOCHS * HORIZON != 1):
        fail(f"import_pth_distill: launches {pd_counts}, per epoch {pth_epoch_launches} (expected {want_d})")
    if not all(math.isfinite(v) for v in info["bc_loss"]) or not teacher_same:
        fail(f"import_pth_distill: bc_loss {info['bc_loss']}, teacher unchanged {teacher_same}")
    if any(c["outlier_envs"] > OUTLIER_FRAC * N_ENVS for c in d_cmp.values()):
        fail(f"import_pth_distill: K3 -> RA -> K2 against the plain versions {d_cmp}")
    pth_distill_launches = pd_counts
    del res, denv, dst, tf_, k3_, plain3_

    # speed_z on the imported PulseVAE: K3, as train_speed_z
    res, pth_z_launches, info, _ = train_amp("import_pth_speed_z", ["env=speed_z", f"env.z_checkpoint={vae_pth}"],
                                             want_z, TRAIN_EPOCHS, learning="pulse_z_task", trace_rollout=False)
    zenv, zts = res.agent.env, res.train_state.ppo
    want_vae = ref_ck.import_pulse_vae(vsd_, device=dev).state_dict()
    z_frozen = all(torch.equal(v, want_vae[k]) for k, v in zenv.frozen.network.state_dict().items())
    z_cmp = k3_vs_plain(zenv, zts.env_state)
    info.update(per_step(info), frozen_vae_unchanged=z_frozen, frozen_full_precision=zenv.frozen.network.full_precision,
                K3_vs_plain_last_state=z_cmp)
    emit(info)
    if (pth_z_launches != {k: TRAIN_EPOCHS * n for k, n in want_z.items()} or not z_frozen
            or any(c["outlier_envs"] > OUTLIER_FRAC * N_ENVS for c in z_cmp.values())):
        fail(f"import_pth_speed_z: launches {pth_z_launches}, VAE unchanged {z_frozen}, K3 vs plain {z_cmp}")
    del res, zenv, zts, want_vae, i_pnn

    # ---- the plain physics: strike, pedestrian terrain, self collision ------- #
    # No kernel covers the coupled strike step, terrain or self collision (nor
    # did a TPU kernel): the envs choose the plain route from their model and
    # launch nothing. Each trains or acts at N_ENVS, then one step of 64 envs
    # on the card is held against the same step on the CPU
    zero_launches = {"step_reward_amp": 0, "observe": 0, "physics_step": 0, "physics_step_rows": 0, "reward_amp": 0}
    cpu_spec_model = build_model(spec, PhysicsConfig(), device="cpu")
    n_cmp = 64

    def tree(fn, obj):
        if obj is None or isinstance(obj, (int, float, bool, str)):
            return obj
        if isinstance(obj, torch.Tensor):
            return fn(obj)
        if isinstance(obj, dict):
            return {k: tree(fn, v) for k, v in obj.items()}
        return dataclasses.replace(obj, **{f.name: tree(fn, getattr(obj, f.name)) for f in dataclasses.fields(obj)})

    def cpu_store(card_env):
        """The card env's motion store on the CPU: the steps are compared
        here, not the stores (a store built on the card differs from the
        CPU's build by float32's floors, motion_file)."""
        return tree(lambda t: t.cpu(), card_env.motion)

    def card_vs_cpu(card_env, cpu_env, st) -> dict:
        """One step of the first n_cmp envs of `st` on the card and on the CPU
        with the same actions: the physics within K1_TOL, the reward within
        K1's tolerance, the flags alike, in the envs that reset on neither
        (their fresh states come from two generators). The obs is held to
        K2_TOL on identical inputs: the CPU env observes the card's stepped
        state. The CPU's own stepped obs ("obs_after_step", reported) carries
        the physics' differences, which K1_TOL lets reach 5e-3 in the body
        velocities that the self obs holds unscaled."""
        sub = tree(lambda t: t[:n_cmp].clone(), st)
        act = torch.rand(n_cmp, card_env.action_dim, generator=g, device=dev) * 2.0 - 1.0
        with torch.no_grad():
            a = card_env.step(sub, act)
            b = cpu_env.step(tree(lambda t: t.cpu(), sub), act.cpu())
            same = cpu_env._observe(tree(lambda t: t.cpu(), a)).to(dev)
        b = tree(lambda t: t.to(dev), b)
        bad = a.done != b.done
        keep = ~(a.done | b.done)
        fields = [(f, getattr(a.physics, f), getattr(b.physics, f), K1_TOL[f]) for f in PHYS_FIELDS]
        fields += [("reward", a.reward, b.reward, K1_TOL["reward"]), ("obs", a.obs, same, K2_TOL)]
        if "prop" in getattr(a, "task", {}):
            fields += [(f"prop_{f}", getattr(a.task["prop"], f), getattr(b.task["prop"], f), K1_TOL["root_pos"]
                        if f in ("pos", "rot") else K1_TOL["root_vel6"]) for f in ("pos", "rot", "lin_vel", "ang_vel")]
        res_ = {"envs": n_cmp, "compared_envs": int(keep.sum()), "flags_differ": int(bad.sum())}
        for name_, x, y, tol in fields:
            err = (x.float() - y.float()).abs().reshape(n_cmp, -1).amax(dim=1)
            bad |= keep & (err > tol)
            res_[name_] = {"max": float(err[keep].max()) if keep.any() else 0.0, "tol": tol}
        step_err = (a.obs - b.obs).abs().amax(dim=1)
        res_["obs_after_step"] = {"max": float(step_err[keep].max()) if keep.any() else 0.0}
        res_["outlier_envs"] = int(bad.sum())
        return res_

    def walkable_and_grounded(tenv, st) -> dict:
        """The spawns on walkable cells, and the lowest foot's height above
        the ground under it."""
        t_ = tenv.terrain
        cells = torch.round((st.physics.root_pos[:, :2] - t_.origin) / t_.cell_size).long()
        walk = torch.zeros(t_.heights.shape, dtype=torch.bool, device=dev)
        wc = torch.round((t_.walkable_xy - t_.origin) / t_.cell_size).long()
        walk[wc[:, 0], wc[:, 1]] = True
        on_cell = torch.equal(t_.origin + cells.float() * t_.cell_size, st.physics.root_pos[:, :2])
        feet = [tenv.body_names.index(n_) for n_ in ("L_Ankle", "R_Ankle", "L_Toe", "R_Toe")]
        fp = st.physics.body_pos[:, feet]
        h_ = (fp[..., 2] - tenv._ground_z(fp[..., :2])).amin(dim=1)
        return {"on_walkable_cells": bool(on_cell and walk[cells[:, 0], cells[:, 1]].all()),
                "foot_height_median_m": float(h_.median()), "foot_height_min_m": float(h_.min()),
                "foot_height_max_m": float(h_.max()),
                "frac_feet_within_0.1m": float((h_.abs() <= FOOT_TOL).float().mean())}

    def z_steps_plain(env_args: list, label: str) -> dict:
        """8 policy-acting steps of a Z env built through run's builders."""
        zcfg = load_config([*env_args, "learning=pulse_z_task", f"num_envs={N_ENVS}", "device=cuda"])
        zspec, zmodel = run.build_model_from_cfg(zcfg, dev)
        zenv = run.build_env_from_cfg(zcfg, zmodel, run.build_motion_from_cfg(zcfg, zspec, dev), dev)
        znet = ActorCritic(zenv.obs_dim, zenv.action_dim, actor_units=(1024, 512), critic_units=(1024, 512),
                           device=dev, seed=0)
        zrms = RunningMeanStd.create(zenv.obs_dim, device=dev)
        with torch.no_grad():
            zst = zenv.reset(N_ENVS)
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            t0_ = time.perf_counter()
            for _ in range(z_steps):
                zst = zenv.step(zst, torch.clamp(policy_step(znet, zst.obs, g, obs_rms=zrms)[0], -1.0, 1.0))
            torch.cuda.synchronize()
            out_ = {"env": type(zenv.env).__name__, "physics_route": zenv.env.physics_route,
                    "obs_dim": zenv.obs_dim, "action_dim": zenv.action_dim, "launches": dict(_build.launches),
                    "ms_per_step": 1e3 * (time.perf_counter() - t0_) / z_steps,
                    "obs_finite": bool(torch.isfinite(zst.obs).all()), "resets": int(zst.done.sum())}
        if out_["launches"] != zero_launches or out_["physics_route"] != "plain" or not out_["obs_finite"]:
            fail(f"{label}: {out_}")
        return out_

    # strike: 1 epoch of env=strike learning=pulse_z_task, then strike_z
    box_moved, box_at_clamp, box_max_w = [], [], []

    def strike_hook(agent, out):
        prop_ = out[0].ppo.env_state.task["prop"]
        up_ = oq.quat_rotate(prop_.rot, torch.tensor([0.0, 0.0, 1.0], device=dev).expand_as(prop_.pos))[:, 2]
        box_moved.append(int(((up_ < 0.999) | (prop_.lin_vel[:, :2].norm(dim=-1) > 0.02)).sum()))
        # the boxes at the prop step's velocity clamp (physics/prop.py)
        pc_ = agent.env.model.config
        w_b = oq.quat_rotate_inverse(prop_.rot, prop_.ang_vel).abs().amax(dim=-1)
        box_at_clamp.append(int(((w_b >= 0.999 * pc_.max_angular_velocity)
                                 | (prop_.lin_vel.abs().amax(dim=-1) >= 0.999 * pc_.max_linear_velocity)).sum()))
        box_max_w.append(float(prop_.ang_vel.norm(dim=-1).max()))

    res, strike_launches, info, _ = train_amp("train_strike", ["env=strike"], zero_launches, PLAIN_EPOCHS,
                                              on_epoch=strike_hook, learning="pulse_z_task", trace_rollout=False)
    senv_, sts = res.agent.env, res.train_state.ppo
    s_cmp = card_vs_cpu(senv_, HumanoidStrikeEnv(cpu_spec_model, cpu_store(senv_), senv_.config, device="cpu"), sts.env_state)
    info.update(per_step(info), device_kernels_per_step=info["rollout_device_kernels"] / HORIZON,
                physics_route=senv_.physics_route, obs_dim=senv_.obs_dim, boxes_moved_per_epoch=box_moved,
                boxes_at_velocity_clamp_per_epoch=box_at_clamp, box_max_ang_vel_per_epoch=box_max_w,
                card_vs_cpu=s_cmp, strike_z=z_steps_plain(["env=strike_z", f"env.z_checkpoint={vae_pth}"],
                                                          "train_strike strike_z"))
    emit(info)
    if strike_launches != zero_launches or senv_.physics_route != "plain" or senv_.obs_dim != 373:
        fail(f"train_strike: launches {strike_launches}, route {senv_.physics_route}, obs {senv_.obs_dim}")
    if not max(box_moved) or s_cmp["outlier_envs"] > OUTLIER_FRAC * n_cmp:
        fail(f"train_strike: boxes moved {box_moved}, card vs CPU {s_cmp}")
    del res, senv_, sts

    # pedestrian terrain: 1 epoch on the default 8 x 8 tiles of 8 m
    res, terrain_launches, info, _ = train_amp("train_terrain", ["env=pedestrian_terrain"], zero_launches,
                                               PLAIN_EPOCHS, learning="pulse_z_task", trace_rollout=False)
    tenv_, tts = res.agent.env, res.train_state.ppo
    with torch.no_grad():
        spawned = walkable_and_grounded(tenv_, tenv_.reset(N_ENVS))
    t_cmp = card_vs_cpu(tenv_, HumanoidPedestrianTerrainEnv(cpu_spec_model, cpu_store(tenv_), tenv_.config, device="cpu"),
                        tts.env_state)
    info.update(per_step(info), device_kernels_per_step=info["rollout_device_kernels"] / HORIZON,
                physics_route=tenv_.physics_route, obs_dim=tenv_.obs_dim,
                heightfield=list(tenv_.model.terrain_heights.shape), walkable_cells=int(tenv_.terrain.walkable_xy.shape[0]),
                spawns=spawned, card_vs_cpu=t_cmp,
                terrain_z=z_steps_plain(["env=pedestrian_terrain", "env.task=HumanoidPedestrianTerrainZ"],
                                        "train_terrain HumanoidPedestrianTerrainZ"))
    emit(info)
    if (terrain_launches != zero_launches or tenv_.physics_route != "plain" or tenv_.obs_dim != 634
            or list(tenv_.model.terrain_heights.shape) != [256, 256]):
        fail(f"train_terrain: launches {terrain_launches}, route {tenv_.physics_route}, obs {tenv_.obs_dim}")
    if (not spawned["on_walkable_cells"] or spawned["frac_feet_within_0.1m"] < FOOT_FRAC
            or abs(spawned["foot_height_median_m"]) > FOOT_TOL or t_cmp["outlier_envs"] > OUTLIER_FRAC * n_cmp):
        fail(f"train_terrain: spawns {spawned}, card vs CPU {t_cmp}")
    del res, tenv_, tts

    # train_terrain_cnn: CNNActorCritic (conv 16-32, k 3, stride 2 on the
    # obs' 16 x 16 height map, then 1024-512 towers) in train_terrain's
    # AMPAgent on env=pedestrian_terrain, 1 epoch on the plain route; then
    # the conv features of the final obs against those of its height map
    # shifted by 0.5 m
    cnn_env, cnn_base = built(["env=pedestrian_terrain"], "pulse_z_task")
    cnn_net = CNNActorCritic(cnn_env.obs_dim, cnn_env.action_dim, grid_shape=(16, 16), device=dev, seed=0)
    cnn_agent = with_network(cnn_base, cnn_net)
    cnn_ts, lib_launches["train_terrain_cnn"], info = lib_train("train_terrain_cnn", cnn_agent, 1, zero_launches)
    with torch.no_grad():
        o_ = cnn_ts.ppo.obs_rms.normalize(cnn_ts.ppo.env_state.obs)
        o_shift = o_.clone()
        o_shift[:, -cnn_env.height_map_dim:] += 0.5
        f0, f1 = cnn_net.features(o_), cnn_net.features(o_shift)
    n_flat = cnn_env.obs_dim - cnn_env.height_map_dim
    info.update(physics_route=cnn_env.physics_route, obs_dim=cnn_env.obs_dim, height_map_dim=cnn_env.height_map_dim,
                conv_features=f0.shape[1] - n_flat,
                flat_features_unchanged=bool(torch.equal(f0[:, :n_flat], f1[:, :n_flat])),
                conv_features_changed_frac=float(((f0[:, n_flat:] - f1[:, n_flat:]).abs().amax(dim=1) > 0)
                                                 .float().mean()))
    emit(info)
    if (cnn_env.physics_route != "plain" or cnn_env.height_map_dim != 256 or not info["flat_features_unchanged"]
            or info["conv_features_changed_frac"] != 1.0 or lib_launches["train_terrain_cnn"] != zero_launches):
        fail(f"train_terrain_cnn: {info}")
    del cnn_env, cnn_base, cnn_agent, cnn_ts
    shutil.rmtree(out_root, ignore_errors=True)
    shutil.rmtree(pth_dir, ignore_errors=True)

    # self collision: 8 steps of HumanoidImEnv on a self-collision model
    sc_model = build_model(spec, PhysicsConfig(self_collision=True), device=dev)
    sc_env = HumanoidImEnv(sc_model, motion, EnvConfig(), device=dev, seed=0)
    sc_cpu = HumanoidImEnv(build_model(spec, PhysicsConfig(self_collision=True), device="cpu"), cpu_store(sc_env),
                           EnvConfig(), device="cpu", seed=0)
    with torch.no_grad():
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        sc_st = sc_env.reset(N_ENVS)
        t0 = time.perf_counter()
        for _ in range(SC_STEPS):
            sc_st = sc_env.step(sc_st, 0.3 * torch.randn(N_ENVS, 69, generator=g, device=dev))
        torch.cuda.synchronize()
        sc_ms = 1e3 * (time.perf_counter() - t0) / SC_STEPS
        sc_launches = dict(_build.launches)
        sc_busy, sc_kern = device_busy(lambda: sc_env.step(sc_st, 0.3 * torch.randn(N_ENVS, 69, generator=g,
                                                                                    device=dev)))
    sc_finite = all(bool(torch.isfinite(getattr(sc_st.physics, f)).all()) for f in PHYS_FIELDS)
    sc_cmp = card_vs_cpu(sc_env, sc_cpu, sc_st)
    emit({"phase": "self_collision", "card": card, "envs": N_ENVS, "steps": SC_STEPS,
          "physics_route": sc_env.physics_route, "launches": sc_launches, "ms_per_step": sc_ms,
          "device_busy_ms_per_step": sc_busy, "device_kernels_per_step": sc_kern, "state_finite": sc_finite,
          "resets": int(sc_st.done.sum()), "card_vs_cpu": sc_cmp})
    if (sc_launches != zero_launches or sc_env.physics_route != "plain" or not sc_finite
            or sc_cmp["outlier_envs"] > OUTLIER_FRAC * n_cmp):
        fail(f"self_collision: route {sc_env.physics_route}, launches {sc_launches}, finite {sc_finite}, "
             f"card vs CPU {sc_cmp}")
    del sc_env, sc_cpu, sc_st, sc_model

    # ---- motion_file: an archive the size of AMASS, its store, training on it - #
    # ~10k clips of 30-600 frames at 30 fps, cut as windows from 64 synthetic
    # 20 s clips, written with the port's write_archive into a gitignored
    # directory, read back, built into a store on the card; a 200-clip subset
    # against the CPU's build; env=im trained from the file; then
    # process_amass's raw -> db -> isaac stages with the gendered ground fix
    # (the batched LBS on the card) and that .pkl into a store
    import numpy as np

    from pulse_tpu_torch.kinematics.skeleton import _smooth_time_axis
    from pulse_tpu_torch.motion.archive import read_archive, write_archive
    from pulse_tpu_torch.motion.loader import load_motion_file
    from pulse_tpu_torch.motion.motion_lib import _calc_frame_blend
    from pulse_tpu_torch.motion.reference_format import axis_angle_to_quat
    from pulse_tpu_torch.scripts import process_amass
    from pulse_tpu_torch.smpl import body_model as smpl_bm

    def store_vs_cpu(card_store, card_rows, cpu_store, fps_of, q_ids, q_t, card_q_ids) -> tuple:
        """(store, motion state): each field of the card's store (its rows
        `card_rows`) and of its motion state at (`card_q_ids`, `q_t`) against
        the CPU's build of the same clips (`cpu_store`, each clip's fps in
        `fps_of`) and its motion state at (`q_ids`, `q_t`), held to the base
        tolerance (MF_POS_TOL, or MF_VEL_REL of a velocity field's largest
        magnitude) plus the floor that each element's CPU side sets (MF_*)."""
        with torch.no_grad():
            ms_card = get_motion_state(card_store, card_q_ids, q_t.to(dev))
            ms_cpu = get_motion_state(cpu_store, q_ids, q_t)

        # each element's floor from its CPU side (MF_*)
        ulps = MF_ULPS * 2.0**-24

        def angle_axis_floor(q_, delta=0.0):
            """The floor of quat_to_angle_axis's vector v of the CPU's [..., 4]
            quaternions, when the card's may also differ from them by delta
            (a slerp's floor, relative to the quaternion's size): 1 - w^2
            moves by ulps + 2 delta, and the vector by |v| times that over
            2 s^2, by pi delta through xyz, and by all of |v| where that
            reaches s^2 (one side reads w as 1 and returns 0); and s."""
            q_ = q_.double()
            xyz, w_ = q_[..., :3].norm(dim=-1), q_[..., 3].abs().clamp(max=1.0)
            s2 = 1.0 - w_ * w_
            moved = ulps + 2.0 * torch.as_tensor(delta, dtype=torch.float64)
            v_ = 2.0 * torch.atan2(xyz, w_)
            return (v_ * moved / (2.0 * torch.maximum(s2, moved)) + math.pi * delta + torch.where(s2 <= moved, v_, 0.0),
                    s2.sqrt())

        floors = {f_: torch.zeros_like(getattr(cpu_store, f_), dtype=torch.float64) for f_ in STORE_FIELDS}
        s_of = {f_: torch.ones_like(floors[f_]) for f_ in ("gavs", "dvs")}   # the CPU side's s, a witness
        for s_, n_, fps_ in zip(cpu_store.length_starts.tolist(), cpu_store.motion_num_frames.tolist(), fps_of):
            g_, l_ = cpu_store.grs[s_ : s_ + n_], cpu_store.lrs[s_ : s_ + n_, 1:]
            jump, sg = angle_axis_floor(oq.quat_mul_norm(g_[1:], oq.quat_inverse(g_[:-1])))
            floors["gavs"][s_ : s_ + n_] = _smooth_time_axis(fps_ * torch.cat([jump, torch.zeros(1, J,
                                                                                                 dtype=jump.dtype)]))[
                ..., None]
            s_of["gavs"][s_ : s_ + n_] = torch.cat([sg, sg[-1:]])[..., None]
            jump, sl = angle_axis_floor(oq.quat_mul_norm(oq.quat_inverse(l_[:-1]), l_[1:]))
            floors["dvs"][s_ : s_ + n_] = fps_ * torch.cat([jump, jump[-1:]]).repeat_interleave(3, dim=1)
            s_of["dvs"][s_ : s_ + n_] = torch.cat([sl, sl[-1:]]).repeat_interleave(3, dim=1)
        f0_, f1_, bl_ = _calc_frame_blend(q_t, cpu_store.motion_lengths[q_ids], cpu_store.motion_num_frames[q_ids],
                                          cpu_store.motion_dt[q_ids])
        f0_, f1_ = f0_ + cpu_store.length_starts[q_ids], f1_ + cpu_store.length_starts[q_ids]
        b3, b2 = bl_[:, None, None].double(), bl_[:, None].double()

        def slerp_floor(table):
            """[N, J, 4] floors of slerp(table[f0], table[f1]) (its output
            about unit), [N, J] the relative part, [N, J] |q1 - q0| at
            the cut (else 0) and [N, J] s."""
            q0_, q1_ = table[f0_].double(), table[f1_].double()
            c_ = (q0_ * q1_).sum(-1)
            s2 = 1.0 - c_ * c_
            rel = torch.where(s2 >= 1e-6, ulps / (2.0 * s2.clamp(min=1e-6)), 0.0)
            d_ = torch.where(c_[..., None] < 0, -q1_, q1_) - q0_
            at_cut = (s2 <= 1e-6 + ulps)[..., None]
            return (rel[..., None] + torch.where(at_cut, d_.abs(), 0.0), rel, torch.where(at_cut, d_, 0.0).norm(dim=-1),
                    s2.clamp(min=0.0).sqrt())

        rb_f, _, _, rb_s = slerp_floor(cpu_store.grs)
        lr_f, lr_rel, lr_cut, lr_s = slerp_floor(cpu_store.lrs)
        dof_f, dof_s = angle_axis_floor(ms_cpu["local_rot"][:, 1:], lr_rel[:, 1:] + lr_cut[:, 1:])
        s_ang = torch.minimum(s_of["gavs"][f0_], s_of["gavs"][f1_])
        s_of.update(root_rot=rb_s[:, :1].expand(-1, 4), rb_rot=rb_s[..., None].expand(-1, -1, 4),
                    local_rot=lr_s[..., None].expand(-1, -1, 4), root_ang_vel=s_ang[:, 0], body_ang_vel=s_ang,
                    dof_vel=torch.minimum(s_of["dvs"][f0_], s_of["dvs"][f1_]),
                    dof_pos=torch.minimum(dof_s, lr_s[:, 1:]).repeat_interleave(3, dim=1))
        ang_f = (1.0 - b3) * floors["gavs"][f0_] + b3 * floors["gavs"][f1_]
        floors.update(root_rot=rb_f[:, 0], rb_rot=rb_f, local_rot=lr_f, root_ang_vel=ang_f[:, 0], body_ang_vel=ang_f,
                      dof_vel=(1.0 - b2) * floors["dvs"][f0_] + b2 * floors["dvs"][f1_],
                      dof_pos=dof_f.repeat_interleave(3, dim=1))

        def held(name, got, want) -> dict:
            """Within the base tolerance plus the element's floor; the
            elements beyond the base alone are counted, those of them whose
            floor is under the base (none where the gate holds), and by the
            CPU side's s (a rate's: its own frame's; s <= 1.2e-3: at or near
            slerp's cut)."""
            got, want = got.double().cpu(), want.double().cpu()
            err = (got - want).abs()
            scale = float(want.abs().max())
            base = MF_VEL_REL * scale if name in vel_fields else MF_POS_TOL
            floor_ = floors[name] if name in floors else torch.zeros_like(err)
            beyond = err > base
            s_b = s_of[name][beyond] if name in s_of else torch.ones(int(beyond.sum()), dtype=torch.float64)
            edges = (0.0, 1.2e-3, 1e-2, 3e-2, 1e-1, 2.0)
            return {"max_abs": float(err.max()), "max_rel": float(err.max()) / max(scale, 1e-12), "base_tol": base,
                    "elements": err.numel(), "floor_over_base": int((floor_ > base).sum()),
                    "max_floor": float(floor_.max()), "beyond_base": int(beyond.sum()),
                    "beyond_base_floor_under_base": int((beyond & (floor_ <= base)).sum()),
                    "beyond_base_by_cpu_s": {f"s<={hi:g}": int(((s_b > lo) & (s_b <= hi)).sum()) + (
                        int((s_b <= 0).sum()) if lo == 0 else 0) for lo, hi in zip(edges, edges[1:])},
                    "max_err_over_tol": float((err / (base + floor_).clamp(min=1e-300)).max()),
                    "ok": bool((err <= base + floor_).all())}

        vel_fields = ("gvs", "gavs", "dvs", "root_vel", "body_vel", "root_ang_vel", "body_ang_vel", "dof_vel")
        store_cmp = {f_: held(f_, getattr(card_store, f_)[card_rows], getattr(cpu_store, f_)) for f_ in STORE_FIELDS}
        state_cmp = {k_: held(k_, ms_card[k_], ms_cpu[k_]) for k_ in ms_card}
        return store_cmp, state_cmp

    t_phase = time.perf_counter()
    os.makedirs(os.path.dirname(out_root), exist_ok=True)
    mf_dir = tempfile.mkdtemp(prefix="motion_file_", dir=os.path.dirname(out_root))   # output/: gitignored
    try:
        mrng = np.random.default_rng(14)
        bases = [make_synthetic_clips(spec.skeleton, 1, seconds=20.0, seed=100 + s)[0] for s in range(MF_BASES)]
        base_T = bases[0]["local_rotation"].shape[0]
        mf_clips = []
        for k in range(MF_CLIPS):
            b_, T_ = bases[k % MF_BASES], int(mrng.integers(MF_MIN_T, MF_MAX_T + 1))
            o_ = int(mrng.integers(0, base_T - T_ + 1))
            mf_clips.append({"fps": 30.0, "local_rotation": b_["local_rotation"][o_ : o_ + T_],
                             "root_translation": b_["root_translation"][o_ : o_ + T_]})
        mf_frames = sum(c_["local_rotation"].shape[0] for c_ in mf_clips)
        mtn = os.path.join(mf_dir, "amass_size.mtn")
        t0 = time.perf_counter()
        write_archive(mtn, mf_clips)
        write_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(mtn)
        t0 = time.perf_counter()
        read = read_archive(mtn)
        read_s = time.perf_counter() - t0
        sample = mrng.choice(MF_CLIPS, MF_CLIPS // 100, replace=False)
        round_trip = all(read[i]["fps"] == mf_clips[i]["fps"]
                         and np.array_equal(read[i]["local_rotation"], mf_clips[i]["local_rotation"])
                         and np.array_equal(read[i]["root_translation"], mf_clips[i]["root_translation"])
                         for i in sample)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mf_store = build_motion_data(spec.skeleton, read, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        store_bytes = sum(getattr(mf_store, f_).numel() * 4 for f_ in STORE_FIELDS)

        # the card's store of a 200-clip subset and the motion state at
        # MF_QUERIES (clip, t) against the CPU's build (the tolerances and
        # floors at MF_CLIPS)
        sub = np.sort(mrng.choice(MF_CLIPS, MF_SUBSET, replace=False))
        t0 = time.perf_counter()
        sub_cpu = build_motion_data(spec.skeleton, [read[i] for i in sub], device="cpu")
        cpu_build_s = time.perf_counter() - t0
        starts_ = mf_store.length_starts[torch.as_tensor(sub, device=dev)].tolist()
        rows_ = torch.cat([torch.arange(s_, s_ + read[i]["local_rotation"].shape[0]) for s_, i in zip(starts_, sub)])
        q_ids = torch.randint(0, MF_SUBSET, (MF_QUERIES,), generator=torch.Generator().manual_seed(3))
        q_t = torch.rand(MF_QUERIES, generator=torch.Generator().manual_seed(4)) * sub_cpu.motion_lengths[q_ids]
        store_cmp, state_cmp = store_vs_cpu(mf_store, rows_.to(dev), sub_cpu, [read[i]["fps"] for i in sub], q_ids, q_t,
                                            torch.as_tensor(sub, device=dev)[q_ids.to(dev)])
        store_info = {"phase": "motion_file", "card": card, "clips": MF_CLIPS, "frames": mf_frames,
                      "file_bytes": file_bytes, "write_s": write_s, "read_s": read_s,
                      "read_GBps": file_bytes / read_s / 1e9, "build_s": build_s, "store_bytes": store_bytes,
                      "store_floats_per_frame": store_bytes // 4 // mf_frames, "groups": len({(c_["local_rotation"].shape[0], c_["fps"]) for c_ in read}),
                      "round_trip_clips": len(sample), "round_trip_bit_exact": round_trip,
                      "subset_clips": MF_SUBSET, "subset_cpu_build_s": cpu_build_s, "store_vs_cpu": store_cmp,
                      "queries": MF_QUERIES, "motion_state_vs_cpu": state_cmp}
        emit(store_info)
        if not round_trip or file_bytes != 24 + 8 * MF_CLIPS + 4 * mf_frames * (4 * J + 3):
            fail(f"motion_file: round trip {round_trip}, {file_bytes} bytes for {mf_frames} frames")
        if not all(c_["ok"] for c_ in (*store_cmp.values(), *state_cmp.values())):
            fail(f"motion_file: the card's store or motion state against the CPU's: {store_cmp}, {state_cmp}")
        del mf_store, read, sub_cpu
        torch.cuda.empty_cache()

        # train the main path from the file: K1 and K2 32 each an epoch
        res, mf_launches, info = train("motion_file_train", ["env=im", f"env.motion_file={mtn}"],
                                       {"step_reward_amp": HORIZON, "observe": HORIZON, "physics_step": 0,
                                        "physics_step_rows": 0, "reward_amp": 0})
        m_env = res.agent.env
        info.update(phase="motion_file_train", clips=m_env.motion.num_motions,
                    store_device=str(m_env.motion.gts.device), train_im_env_steps_per_s=im_steps_per_s)
        emit(info)
        if m_env.motion.num_motions != MF_CLIPS or m_env.motion.gts.device.type != "cuda":
            fail(f"motion_file_train: {m_env.motion.num_motions} clips on {m_env.motion.gts.device}")
        del res, m_env

        # process_amass on AMASS-style 120 fps sequences with a gendered
        # synthetic SMPL triple at V = 6890, then the .pkl into a store
        amass_root = os.path.join(mf_dir, "amass")
        os.makedirs(os.path.join(amass_root, "SYNTH", "subj"))
        for i in range(MF_AMASS_SEQS):
            T_ = int(mrng.integers(480, 1201))
            tt = np.linspace(0, 8 * np.pi, T_)[:, None]
            poses = mrng.uniform(0.0, 0.35, (1, 156)) * np.sin(mrng.uniform(0.5, 2.0, (1, 156)) * tt
                                                                + mrng.uniform(0, np.pi, (1, 156)))
            poses[:, :3] += np.asarray([np.pi / 2, 0, 0])
            trans = np.stack([0.005 * np.arange(T_), np.full(T_, 0.91), 0.01 * np.sin(np.arange(T_) / 10)], 1)
            np.savez(os.path.join(amass_root, "SYNTH", "subj", f"seq{i}_poses.npz"), poses=poses, trans=trans,
                     betas=mrng.standard_normal(16), gender=("neutral", "male", "female")[i % 3],
                     mocap_framerate=120.0)
        smpl_dir = os.path.join(mf_dir, "smpl")
        os.makedirs(smpl_dir)
        for s_, g_ in enumerate(("NEUTRAL", "MALE", "FEMALE")):
            write_smpl_pickle(os.path.join(smpl_dir, f"SMPL_{g_}.pkl"), spec.skeleton, num_surface_verts=6866, seed=s_)
        pk = {k_: os.path.join(mf_dir, f"{k_}.pkl") for k_ in ("raw", "db", "isaac")}
        t0 = time.perf_counter()
        process_amass.process_raw(amass_root, pk["raw"])
        db = process_amass.process_db(pk["raw"], pk["db"], None, smpl_dir, device=dev)
        process_amass.process_isaac(pk["db"], pk["isaac"], device=dev)
        amass_clips = load_motion_file(pk["isaac"], spec.skeleton)
        a_store = build_motion_data(spec.skeleton, amass_clips, device=dev)
        torch.cuda.synchronize()
        amass_s = time.perf_counter() - t0
        # the batched LBS of the fixed first frames on the card against a
        # float64 LBS on the CPU; after the fix each lowest vertex is at z = 0
        gsmpl = smpl_bm.GenderedSMPL.load(smpl_dir)
        lbs_err, lowest = 0.0, []
        for g_ in ("neutral", "male", "female"):
            keys_ = [k_ for k_, v_ in db.items() if v_["gender"] == g_]
            args_ = [torch.from_numpy(np.stack(x_)) for x_ in (
                [db[k_]["beta"] for k_ in keys_],
                [axis_angle_to_quat(db[k_]["pose_aa"][0].reshape(24, 3)) for k_ in keys_],
                [db[k_]["trans"][0] for k_ in keys_])]
            with torch.no_grad():
                v_card, _ = smpl_bm.lbs(gsmpl.for_gender(g_), *(a_.float().to(dev) for a_ in args_))
                v_cpu, _ = smpl_bm.lbs(gsmpl.for_gender(g_), *(a_.double() for a_ in args_))
            lbs_err = max(lbs_err, float((v_card.double().cpu() - v_cpu).abs().max()))
            lowest += v_cpu[..., 2].amin(dim=1).tolist()
        codes = sorted({float(c_["shape_params"][0]) for c_ in amass_clips})
        a_info = {"phase": "motion_file_amass", "card": card, "sequences": MF_AMASS_SEQS, "db": len(db),
                  "clips": a_store.num_motions, "frames": int(a_store.gts.shape[0]),
                  "vertices": int(gsmpl.neutral.v_template.shape[0]), "seconds": amass_s,
                  "lbs_card_vs_cpu64_max_abs_m": lbs_err, "lowest_vertex_after_fix_m": [min(lowest), max(lowest)],
                  "gender_codes": codes, "store_finite": all(bool(torch.isfinite(getattr(a_store, f_)).all())
                                                             for f_ in STORE_FIELDS)}
        emit(a_info)
        if (len(db) != MF_AMASS_SEQS or a_store.num_motions != MF_AMASS_SEQS or not a_info["store_finite"]
                or a_info["vertices"] != 6890 or codes != sorted(smpl_bm.GENDER_CODE.values())
                or lbs_err > MF_POS_TOL or max(abs(x_) for x_ in lowest) > MF_POS_TOL):
            fail(f"motion_file_amass: {a_info}")
        del a_store
    finally:
        shutil.rmtree(mf_dir, ignore_errors=True)
        shutil.rmtree(out_root, ignore_errors=True)
    emit({"phase": "motion_file_seconds", "card": card, "seconds": time.perf_counter() - t_phase})

    # ---- scripts_on_card: play_motion, joint_monkey --sweep, the skinning ----- #
    # each script's device work on the card and on the CPU on the same inputs:
    # play_motion's store of PLAY_CLIPS synthetic clips held as the
    # motion_file gate holds a store (store_vs_cpu: the base tolerances plus
    # the per-element floors) at its trace's lookups, the trace's positions
    # within 1e-5 m; joint_monkey's FK sweep (20 frames a DOF); and
    # render_smpl_mesh's batched skinning of SKIN_FRAMES frames on a synthetic
    # SMPL model at V = 6890, both within 1e-5 m. Then the drawing: PNGs where
    # matplotlib is installed, else the ImportError that names it. No kernel runs
    import importlib.util

    import numpy as np

    from pulse_tpu_torch.scripts import joint_monkey, play_motion, render_smpl_mesh
    from pulse_tpu_torch.smpl.body_model import load_smpl_model

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t_phase = time.perf_counter()
    tree = spec.skeleton
    pclips = play_motion.load_clips(tree, "", PLAY_CLIPS - 1)
    p_card = build_motion_data(tree, pclips, device=dev)
    p_cpu = build_motion_data(tree, pclips, device="cpu")
    trace_card, trace_cpu = play_motion.playback(p_card, PLAY_CLIPS - 1), play_motion.playback(p_cpu, PLAY_CLIPS - 1)
    p_times = torch.as_tensor(trace_cpu["times"])
    p_ids = torch.full(p_times.shape, PLAY_CLIPS - 1, dtype=torch.long)
    p_store_cmp, p_state_cmp = store_vs_cpu(p_card, torch.arange(p_card.gts.shape[0], device=dev), p_cpu,
                                            [c_["fps"] for c_ in pclips], p_ids, p_times, p_ids.to(dev))
    sweep_card = joint_monkey.sweep_dofs(spec, SWEEP_FRAMES, device=dev)
    sweep_cpu = joint_monkey.sweep_dofs(spec, SWEEP_FRAMES, device="cpu")
    os.makedirs(os.path.dirname(out_root), exist_ok=True)
    skin_dir = tempfile.mkdtemp(prefix="skin_", dir=os.path.dirname(out_root))   # output/: gitignored
    try:
        skin_pkl = write_smpl_pickle(os.path.join(skin_dir, "SMPL_NEUTRAL.pkl"), tree, num_surface_verts=6866, seed=5)
        smodel = load_smpl_model(skin_pkl)
        srng = np.random.default_rng(16)
        s_quat = srng.standard_normal((3 * SKIN_FRAMES, J, 4)).astype(np.float32)
        s_quat /= np.linalg.norm(s_quat, axis=-1, keepdims=True)
        s_trans = (srng.uniform(-1, 1, (3 * SKIN_FRAMES, 3)) + [0, 0, 0.9]).astype(np.float32)
        s_betas = srng.uniform(-2, 2, 10).astype(np.float32)
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s_frames, v_card, j_card = render_smpl_mesh.skin_frames(smodel, s_quat, s_trans, s_betas, stride=3,
                                                                    max_frames=SKIN_FRAMES, device=dev)
            torch.cuda.synchronize()
            skin_ms = 1e3 * (time.perf_counter() - t0)
            _, v_cpu, j_cpu = render_smpl_mesh.skin_frames(smodel, s_quat, s_trans, s_betas, stride=3,
                                                           max_frames=SKIN_FRAMES, device="cpu")
        have_mpl = importlib.util.find_spec("matplotlib") is not None
        try:
            pngs = render_smpl_mesh.render_frames(smodel, s_quat, s_trans, s_betas, os.path.join(skin_dir, "png"),
                                                  stride=3, max_frames=1, device=dev)
            draw = {"pngs": len(pngs)}
        except ImportError as err:
            draw = {"import_error": str(err)}
    finally:
        shutil.rmtree(skin_dir, ignore_errors=True)
    soc_launches = dict(_build.launches)
    soc_info = {"phase": "scripts_on_card", "card": card, "seconds": time.perf_counter() - t_phase,
                "play_motion": {"clips": PLAY_CLIPS, "frames": len(trace_cpu["times"]),
                                "trace_pos_max_abs_m": float(np.abs(trace_card["body_pos"] - trace_cpu["body_pos"]).max()),
                                "trace_rot_max_abs": float(np.abs(trace_card["body_rot"] - trace_cpu["body_rot"]).max()),
                                "store_vs_cpu": p_store_cmp, "motion_state_vs_cpu": p_state_cmp},
                "joint_monkey": {"frames": int(sweep_cpu["body_pos"].shape[0]),
                                 "pos_max_abs_m": float(np.abs(sweep_card["body_pos"] - sweep_cpu["body_pos"]).max()),
                                 "rot_max_abs": float(np.abs(sweep_card["body_rot"] - sweep_cpu["body_rot"]).max())},
                "render_smpl_mesh": {"frames": len(s_frames), "vertices": int(v_card.shape[1]), "skin_ms": skin_ms,
                                     "verts_max_abs_m": float((v_card.cpu() - v_cpu).abs().max()),
                                     "joints_max_abs_m": float((j_card.cpu() - j_cpu).abs().max()),
                                     "matplotlib": have_mpl, **draw},
                "launches": soc_launches}
    emit(soc_info)
    pm, jm_, rm = soc_info["play_motion"], soc_info["joint_monkey"], soc_info["render_smpl_mesh"]
    if (pm["trace_pos_max_abs_m"] > MF_POS_TOL or not all(c_["ok"] for c_ in (*p_store_cmp.values(),
                                                                              *p_state_cmp.values()))):
        fail(f"scripts_on_card: play_motion {pm}")
    if max(jm_["pos_max_abs_m"], jm_["rot_max_abs"]) > MF_POS_TOL or jm_["frames"] != SWEEP_FRAMES * 69:
        fail(f"scripts_on_card: joint_monkey {jm_}")
    if (rm["vertices"] != 6890 or rm["frames"] != SKIN_FRAMES or max(rm["verts_max_abs_m"], rm["joints_max_abs_m"])
            > MF_POS_TOL or (rm.get("pngs") != 1 if have_mpl else "matplotlib" not in rm.get("import_error", ""))):
        fail(f"scripts_on_card: render_smpl_mesh {rm}")
    if any(soc_launches.values()):
        fail(f"scripts_on_card: kernel launches {soc_launches}")
    del p_card, p_cpu, v_card, j_card

    # ---- dp_world1 and dp_two_ranks: the data-parallel path ----------------- #
    w1_launches = dp_world1(dev, "nccl", N_ENVS, card)["launches"]
    torch.cuda.empty_cache()
    dp2_launches = dp_two_ranks("cuda", N_ENVS, card)["launches"]

    # ---- K3's and RA's times on the kernel phase's inputs ---------------------- #
    with torch.no_grad():
        P, n_sub = int(model.cp_body.shape[0]), model.config.steps_per_control
        n_amp = cuda_obs.amp_obs_dim(J, len(e.key_ids), e.amp_v, e.root_height_obs)
        k3_in = [kin_phys.root_pos, kin_phys.root_rot, kin_phys.joint_rot, kin_phys.root_vel6, kin_phys.joint_omega,
                 kin_pd]
        x3 = substep_cuda.env_block(k3_in, N_ENVS, 174 + 69)
        o3, o3_one = torch.empty(N_ENVS, 174 + 16 * J, device=dev), torch.empty(N_ENVS, 174 + 16 * J, device=dev)
        x3_fall = substep_cuda.env_block([t_[:n_fall] for t_ in k3_in], n_fall, 174 + 69)
        o_ra = cuda_obs.ra_outputs(N_ENVS, n_amp, dev)
        # the wrappers upload this model's and env's tables to K3's and RA's units
        substep_cuda.physics_step_cuda(model, kin_phys, kin_pd)
        cuda_obs.reward_amp(e, k3, kin_ref)
        m_rows = bm_rows.contiguous()

        def k3_launch(group, out=o3, x=x3, n=N_ENVS):
            return lambda: _build.check(lib.k3_physics_step(x.data_ptr(), out.data_ptr(), n, group, stream), "K3")

        def k3r_launch(group, out=o3):
            return lambda: _build.check(lib.k3_physics_step_rows(x3.data_ptr(), m_rows.data_ptr(), out.data_ptr(),
                                                                 N_ENVS, group, stream), "K3-rows")

        # the chosen G against one lane an env: outputs, then times in turns
        one_vs_group = {}
        for name, launch in (("K3", k3_launch), ("K3rows", k3r_launch)):
            launch(1, o3_one)()
            launch(GROUP)()
            one_vs_group[name] = float((o3 - o3_one).abs().max())
        k3_launch(1, o3_one, x3_fall, n_fall)()
        k3_launch(GROUP, o3, x3_fall, n_fall)()
        one_vs_group["K3_256_envs"] = float((o3[:n_fall] - o3_one[:n_fall]).abs().max())
        k3_ms_one, k3_ms_group = in_turns(lambda: cuda_ms(k3_launch(1), 20), lambda: cuda_ms(k3_launch(GROUP), 20))
        k3f_ms_one, k3f_ms_group = in_turns(lambda: cuda_ms(k3_launch(1, o3, x3_fall, n_fall), 20),
                                            lambda: cuda_ms(k3_launch(GROUP, o3, x3_fall, n_fall), 20))
        k3r_ms_one, k3r_ms_group = in_turns(lambda: cuda_ms(k3r_launch(1), 20), lambda: cuda_ms(k3r_launch(GROUP), 20))
        k3_ms, k3_ms_fall, k3r_ms = (sum(t_) / 2 for t_ in (k3_ms_group, k3f_ms_group, k3r_ms_group))
        ra_args, ra_ins = cuda_obs.reward_amp_args(e, k3, kin_ref, o_ra)
        ra_ms = cuda_ms(lambda: _build.check(lib.ra_reward_amp(*ra_args, stream), "RA"), 100)
        # every built G, once each (the choice of GROUP)
        sweep = {g_: {"K1_ms": cuda_ms(k1_launch(g_), 10), "K3_ms": cuda_ms(k3_launch(g_), 10),
                      "K3_ms_256_envs": cuda_ms(k3_launch(g_, o3, x3_fall, n_fall), 10),
                      "K3rows_ms": cuda_ms(k3r_launch(g_), 10)} for g_ in substep_cuda.BUILT_GROUPS}
        k3r_plain_ms = cuda_ms(lambda: physics_step(bm, kin_phys, kin_pd), 3)
        k3r_wrap_ms = cuda_ms(lambda: substep_cuda.physics_step_cuda(model, kin_phys, kin_pd, model_rows=bm_rows), 20)
        k3_plain_ms = cuda_ms(lambda: physics_step(model, kin_phys, kin_pd), 3)
        ra_plain_ms = cuda_ms(lambda: cuda_obs.reward_amp_plain(e, k3, kin_ref), 10)
        k3_wrap_ms = cuda_ms(lambda: substep_cuda.physics_step_cuda(model, kin_phys, kin_pd), 20)
        ra_wrap_ms = cuda_ms(lambda: cuda_obs.reward_amp(e, k3, kin_ref), 20)
    k3_bound, k3_by = bound_ms(4.0 * N_ENVS * (x3.shape[1] + o3.shape[1]), N_ENVS * physics_ops_per_env(J, P, n_sub))
    k3r_bound, k3r_by = bound_ms(4.0 * N_ENVS * (x3.shape[1] + m_rows.shape[1] + o3.shape[1]),
                                 N_ENVS * rows_ops_per_env(J, P, n_sub))
    ra_bytes = 4.0 * N_ENVS * (26 * J + 7 * (J - 1) + cuda_obs.RA_ROWS + n_amp)
    ra_bound, ra_by = bound_ms(ra_bytes, N_ENVS * epilogue_ops_per_env(J, len(e.reset_ids), len(e.key_ids), e.amp_v))
    emit({"phase": "timing_k3_ra", "card": card, "envs": N_ENVS, "K3_ms": k3_ms, "K3_ms_256_envs": k3_ms_fall,
          "K3rows_ms": k3r_ms, "RA_ms": ra_ms, "group": GROUP,
          f"K3_ms_G{GROUP}_turns": k3_ms_group, "K3_ms_G1_turns": k3_ms_one,
          f"K3_ms_256_envs_G{GROUP}_turns": k3f_ms_group, "K3_ms_256_envs_G1_turns": k3f_ms_one,
          f"K3rows_ms_G{GROUP}_turns": k3r_ms_group, "K3rows_ms_G1_turns": k3r_ms_one,
          f"max_abs_diff_G{GROUP}_vs_G1": one_vs_group,
          "K3_plain_ms": k3_plain_ms, "K3rows_plain_ms": k3r_plain_ms,
          "RA_plain_ms": ra_plain_ms, "K3_wrapper_ms": k3_wrap_ms, "K3rows_wrapper_ms": k3r_wrap_ms,
          "RA_wrapper_ms": ra_wrap_ms, "K3_bound_ms": k3_bound, "K3rows_bound_ms": k3r_bound, "RA_bound_ms": ra_bound,
          "physics_ops_per_env": physics_ops_per_env(J, P, n_sub), "rows_ops_per_env": rows_ops_per_env(J, P, n_sub),
          "epilogue_ops_per_env": epilogue_ops_per_env(J, len(e.reset_ids), len(e.key_ids), e.amp_v)})
    emit({"phase": "group_sweep", "card": card, "envs": N_ENVS, "group": GROUP, "ms": sweep})

    def launch_geometry(info_fn, *args) -> dict:
        info = (ctypes.c_int * 4)()
        _build.check(info_fn(*args, info), "kernel info")
        return {"blocks": info[0], "threads_per_block": info[1], "shared_bytes_per_block": info[2],
                "blocks_per_sm": info[3]}

    def physics_geometry(info_fn, *args) -> dict:
        g_ = geometry(info_fn, *args)
        return {"blocks": -(-N_ENVS // g_["envs_per_block"]), "threads_per_block": g_["threads_per_block"],
                "shared_bytes_per_block": g_["shared_bytes_per_block"], "blocks_per_sm": g_["blocks_per_sm"]}

    def roof(ms, bytes_moved, bound, by, geom) -> dict:
        return {"ms": ms, "bound_ms": bound, "bound_by": by, "fraction_of_bound": bound / ms,
                "GBps": bytes_moved / (ms * 1e-3) / 1e9, "geometry": geom}

    # K2's and RA's diagnosis. The times above replay inputs and outputs
    # that the L2 still holds; L2-cold, each launch takes the next of
    # `copies` sets of them, together over twice the L2, so that no set is
    # touched again before the L2 has turned over; at the batch and at an
    # eighth of it (one block an SM at most). Each regime gets cuda_ms and,
    # from a profiler trace of as many launches, the kernels' own device
    # time: cuda_ms also holds the host's issue time of a launch where
    # that is the longer
    def probe(sets, args_of, warm, launch, nbytes, bound, reps=96) -> dict:
        res = {"copies": len(sets)}
        regimes = [("warm", N_ENVS, [warm])] + [
            ("cold", n, [args_of(*env_slice(set_, lo, lo + n)) for lo in range(0, N_ENVS, n) for set_ in sets])
            for n in (N_ENVS, N_ENVS // 8)]
        for label, n, arg_list in regimes:
            cycle = itertools.cycle(arg_list)

            def fn():
                _build.check(launch(*next(cycle)[0], stream), "probe launch")

            ms_ = cuda_ms(fn, reps)
            busy, n_kernels = device_busy(lambda: [fn() for _ in range(reps)])
            # the mean of the kernels the trace holds (it may miss a few)
            dev_ms = busy / n_kernels if n_kernels else None
            res[f"{label}_{n}_envs"] = {
                "ms": ms_, "device_ms": dev_ms, "device_kernels": n_kernels,
                "device_GBps": nbytes * n / N_ENVS / dev_ms / 1e6 if dev_ms else None,
                "device_fraction_of_bound": bound * n / N_ENVS / dev_ms if dev_ms else None}
        return res

    def copies(physics, ref_, fields, out, nbytes):
        return [(dataclasses.replace(physics, **{f: getattr(physics, f).clone() for f in fields}),
                 {k: ref_[k].clone() for k in ("rg_pos", "rb_rot", "body_vel", "body_ang_vel")}, out())
                for _ in range(max(2, math.ceil(2 * L2_BYTES / nbytes)))]

    with torch.no_grad():
        k2_sets = copies(ph, ref, ("body_pos", "body_rot", "body_vel", "body_ang_vel"),
                         lambda: torch.empty(N_ENVS, env.obs_dim, device=dev), k2_bytes)
        k2_probe = probe(k2_sets, lambda p_, r_, o_: cuda_obs.observe_args(e, p_, r_, o_, n_self), (k2_args, k2_ins),
                         lib.k2_observe, k2_bytes, k2_bound)
        del k2_sets
        ra_sets = copies(k3, kin_ref, ("body_pos", "body_rot", "body_vel", "body_ang_vel", "joint_rot", "joint_omega"),
                         lambda: cuda_obs.ra_outputs(N_ENVS, n_amp, dev), ra_bytes)
        ra_probe = probe(ra_sets, lambda p_, r_, o_: cuda_obs.reward_amp_args(e, p_, r_, o_), (ra_args, ra_ins),
                         lib.ra_reward_amp, ra_bytes, ra_bound)
        del ra_sets
    emit({"phase": "roofline", "card": card, "envs": N_ENVS, "group": GROUP,
          "probe": {"K2": k2_probe, "RA": ra_probe}, "kernels": {
        "K1": roof(k1_ms, 4.0 * N_ENVS * (x1.shape[1] + o1.shape[1]), k1_bound, k1_by,
                   physics_geometry(lib.k1_kernel_info, GROUP)),
        "K2": roof(k2_ms, k2_bytes, k2_bound, k2_by, launch_geometry(lib.k2_kernel_info, N_ENVS, J)),
        "K3": roof(k3_ms, 4.0 * N_ENVS * (x3.shape[1] + o3.shape[1]), k3_bound, k3_by,
                   physics_geometry(lib.k3_kernel_info, GROUP, 0)),
        "K3rows": roof(k3r_ms, 4.0 * N_ENVS * (x3.shape[1] + m_rows.shape[1] + o3.shape[1]), k3r_bound, k3r_by,
                       physics_geometry(lib.k3_kernel_info, GROUP, 1)),
        "RA": roof(ra_ms, ra_bytes, ra_bound, ra_by, launch_geometry(lib.ra_kernel_info, N_ENVS))}})

    src = "pulse_tpu_torch/csrc/"

    def plain_phases(kernel) -> dict:
        """The plain-route phases' launches of a kernel (each gated to 0)."""
        return {"train_strike": strike_launches[kernel], "train_terrain": terrain_launches[kernel],
                "self_collision": sc_launches[kernel]}

    def entry_phases(kernel) -> dict:
        """The entry points' phases' launches of a kernel (K3, K3-rows and
        RA gated to 0 in each)."""
        return {"demo": d_launches[kernel], "demo_tasks": demo_task_launches[kernel],
                "legacy_cli": legacy_launches[kernel], "record_rollout": rec_launches[kernel],
                "sample_pulse": smp_launches[kernel], "scripts_on_card": soc_launches[kernel]}

    def getup_shape_curriculum_phases(kernel) -> dict:
        """train_getup_shape's, getup_shape_tasks' and the curriculum's
        launches of a kernel."""
        return {"train_getup_shape": gs_launches[kernel],
                **{f"getup_shape_{t}": n[kernel] for t, n in gst_launches.items()},
                **{ph: n[kernel] for ph, n in cur_phase_launches.items()}}

    def lib_phases(kernel) -> dict:
        """The learning-layer phases' launches of a kernel (train_rnn,
        train_amp_rnn, train_sept on K1 -> K2; train_terrain_cnn none)."""
        return {ph: n[kernel] for ph, n in lib_launches.items()}

    def no_launch_phases(kernel) -> dict:
        """The plain-route phases' and motion_file_train's launches of a kernel
        that neither runs (each gated to 0)."""
        return {**plain_phases(kernel), "motion_file_train": mf_launches[kernel]}

    def dp_phases(kernel) -> dict:
        """The data-parallel phases' launches of a kernel (dp_two_ranks' summed
        over its ranks)."""
        return {"dp_world1": w1_launches[kernel], "dp_two_ranks": dp2_launches[kernel]}

    emit({"kernels": [
        {"name": "step_reward_amp", "route": "cuda", "source": src + "step_reward_amp.cu",
         "replaces": "pulse_tpu/env/pallas_obs.py:376",
         "launches": sum(n["step_reward_amp"] for n in (im_launches, amp_im_launches, mcp_launches, im_z_launches,
                                                         pulse_launches, pth_mcp_launches, mf_launches))
         + sum(entry_phases("step_reward_amp").values())
         + sum(getup_shape_curriculum_phases("step_reward_amp").values())
         + sum(lib_phases("step_reward_amp").values()) + sum(dp_phases("step_reward_amp").values()),
         "launches_by_phase": {"train_im": im_launches["step_reward_amp"],
                               "motion_file_train": mf_launches["step_reward_amp"],
                               "train_amp_im": amp_im_launches["step_reward_amp"],
                               "train_mcp": mcp_launches["step_reward_amp"],
                               "z_im_traj": im_z_launches["step_reward_amp"],
                               "pulse_stages": pulse_launches["step_reward_amp"],
                               "import_pth_mcp": pth_mcp_launches["step_reward_amp"], **entry_phases("step_reward_amp"),
                               **plain_phases("step_reward_amp"), **getup_shape_curriculum_phases("step_reward_amp"),
                               **lib_phases("step_reward_amp"), **dp_phases("step_reward_amp")},
         "max_abs_err": max_err["step_reward_amp"], "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "observe", "route": "cuda", "source": src + "observe.cuh",
         "replaces": "pulse_tpu/env/pallas_obs.py:558",
         "launches": sum(n["observe"] for n in (im_launches, amp_im_launches, mcp_launches, mcp_getup_launches,
                                                 dr_launches, im_z_launches, pulse_launches, pth_mcp_launches,
                                                 pth_distill_launches, mf_launches))
         + sum(entry_phases("observe").values()) + sum(getup_shape_curriculum_phases("observe").values())
         + sum(lib_phases("observe").values()) + sum(dp_phases("observe").values()),
         "launches_by_phase": {"train_im": im_launches["observe"], "train_amp_im": amp_im_launches["observe"],
                               "motion_file_train": mf_launches["observe"],
                               "train_mcp": mcp_launches["observe"], "train_mcp_getup": mcp_getup_launches["observe"],
                               "train_dr": dr_launches["observe"], "z_im_traj": im_z_launches["observe"],
                               "pulse_stages": pulse_launches["observe"],
                               "import_pth_mcp": pth_mcp_launches["observe"],
                               "import_pth_distill": pth_distill_launches["observe"], **entry_phases("observe"),
                               **plain_phases("observe"), **getup_shape_curriculum_phases("observe"),
                               **lib_phases("observe"), **dp_phases("observe")},
         "max_abs_err": max_err["observe"], "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
        {"name": "physics_step", "route": "cuda", "source": src + "physics_step.cu",
         "replaces": "pulse_tpu/physics/substep_pallas.py:847",
         "launches": sum(n["physics_step"] for n in (getup_launches, vr_launches, amp_launches,
                                                     amp_getup_launches, mcp_getup_launches, speedz_launches,
                                                     speedz_eval_launches, reachz_launches, reachz_eval_launches,
                                                     traj_z_launches, pulse_launches, pth_distill_launches,
                                                     pth_z_launches))
         + sum(getup_shape_curriculum_phases("physics_step").values())
         + sum(lib_phases("physics_step").values()) + sum(dp_phases("physics_step").values()),
         "launches_by_phase": {"train_getup": getup_launches["physics_step"],
                               "train_vr": vr_launches["physics_step"], "train_amp": amp_launches["physics_step"],
                               "train_amp_getup": amp_getup_launches["physics_step"],
                               "train_mcp_getup": mcp_getup_launches["physics_step"],
                               "train_speed_z": speedz_launches["physics_step"],
                               "train_speed_z_test_true": speedz_eval_launches["physics_step"],
                               "train_reach_z": reachz_launches["physics_step"],
                               "train_reach_z_test_true": reachz_eval_launches["physics_step"],
                               "z_im_traj": traj_z_launches["physics_step"],
                               "pulse_stages": pulse_launches["physics_step"],
                               "import_pth_distill": pth_distill_launches["physics_step"],
                               "import_pth_speed_z": pth_z_launches["physics_step"], **no_launch_phases("physics_step"),
                               **entry_phases("physics_step"), **getup_shape_curriculum_phases("physics_step"),
                               **lib_phases("physics_step"), **dp_phases("physics_step")},
         "max_abs_err": max_err["physics_step"], "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": None},
        {"name": "physics_step_rows", "route": "cuda", "source": src + "physics_step.cu",
         "replaces": "pulse_tpu/physics/substep_pallas.py:744",
         "launches": shape_launches["physics_step_rows"] + dr_launches["physics_step_rows"]
         + sum(getup_shape_curriculum_phases("physics_step_rows").values())
         + sum(lib_phases("physics_step_rows").values()) + sum(dp_phases("physics_step_rows").values()),
         "launches_by_phase": {"train_shape": shape_launches["physics_step_rows"],
                               "train_dr": dr_launches["physics_step_rows"], **no_launch_phases("physics_step_rows"),
                               **entry_phases("physics_step_rows"),
                               **getup_shape_curriculum_phases("physics_step_rows"),
                               **lib_phases("physics_step_rows"), **dp_phases("physics_step_rows")},
         "max_abs_err": max_err["physics_step_rows"], "ms": k3r_ms, "plain_ms": k3r_plain_ms, "bound_ms": k3r_bound,
         "bound_by": k3r_by, "library_ms": None},
        {"name": "reward_amp", "route": "cuda", "source": src + "reward_amp.cu",
         "replaces": "pulse_tpu/env/pallas_obs.py:309",
         "launches": sum(n["reward_amp"] for n in (getup_launches, amp_launches, amp_getup_launches,
                                                   mcp_getup_launches, dr_launches, pth_distill_launches))
         + sum(getup_shape_curriculum_phases("reward_amp").values())
         + sum(lib_phases("reward_amp").values()) + sum(dp_phases("reward_amp").values()),
         "launches_by_phase": {"train_getup": getup_launches["reward_amp"], "train_amp": amp_launches["reward_amp"],
                               "train_amp_getup": amp_getup_launches["reward_amp"],
                               "train_mcp_getup": mcp_getup_launches["reward_amp"],
                               "train_dr": dr_launches["reward_amp"],
                               "import_pth_distill": pth_distill_launches["reward_amp"], **no_launch_phases("reward_amp"),
                               **entry_phases("reward_amp"), **getup_shape_curriculum_phases("reward_amp"),
                               **lib_phases("reward_amp"), **dp_phases("reward_amp")},
         "max_abs_err": max_err["reward_amp"], "ms": ra_ms, "plain_ms": ra_plain_ms, "bound_ms": ra_bound,
         "bound_by": ra_by, "library_ms": None},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
