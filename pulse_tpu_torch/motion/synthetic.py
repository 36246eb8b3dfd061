"""Procedural clips for tests, the chip smoke run and the quality benchmark.

Counterpart of `pulse_tpu/motion/synthetic.py` (same seeds, same numbers):
`make_synthetic_clips` (sinusoidal gait, moving root, constant pelvis
height), the 6-clip hard suite `make_hard_clips` and the 30-clip graded
suite `make_graded_suite`, whose foot grounding runs the port's FK.
"""

from __future__ import annotations

import numpy as np
import torch

from pulse_tpu_torch.kinematics.skeleton import SkeletonTree, forward_kinematics


def _aa(axis, angle):
    """xyzw quaternion from axis (3,) and angle array [T]."""
    axis = np.asarray(axis, np.float32)
    axis = axis / np.linalg.norm(axis)
    half = 0.5 * np.asarray(angle)
    return np.stack(
        [axis[0] * np.sin(half), axis[1] * np.sin(half), axis[2] * np.sin(half), np.cos(half)],
        axis=-1,
    ).astype(np.float32)


def make_synthetic_clips(
    tree: SkeletonTree,
    num_clips: int = 4,
    seconds: float = 4.0,
    fps: float = 30.0,
    seed: int = 0,
    pelvis_height: float = 0.93,
) -> list[dict]:
    """Walking-like clips: hip/knee/shoulder sinusoids + forward drift."""
    rng = np.random.default_rng(seed)
    J = tree.num_joints
    names = tree.node_names
    clips = []
    for _ in range(num_clips):
        T = int(seconds * fps) + 1
        t = np.arange(T) / fps
        freq = rng.uniform(0.8, 1.6)
        amp = rng.uniform(0.25, 0.55)
        speed = rng.uniform(0.5, 1.4)
        heading = rng.uniform(-np.pi, np.pi)
        phase = 2 * np.pi * freq * t

        local_rot = np.tile(np.asarray([0, 0, 0, 1.0], np.float32), (T, J, 1))
        local_rot[:, 0] = _aa([0, 0, 1], np.full(T, heading))

        def set_joint(name, axis, angle):
            if name in names:
                local_rot[:, names.index(name)] = _aa(axis, angle)

        set_joint("L_Hip", [0, 1, 0], amp * np.sin(phase))
        set_joint("R_Hip", [0, 1, 0], -amp * np.sin(phase))
        set_joint("L_Knee", [0, 1, 0], amp * np.clip(np.sin(phase + np.pi / 2), 0, None))
        set_joint("R_Knee", [0, 1, 0], amp * np.clip(-np.sin(phase + np.pi / 2), 0, None))
        set_joint("L_Ankle", [0, 1, 0], 0.3 * amp * np.sin(phase + np.pi))
        set_joint("R_Ankle", [0, 1, 0], -0.3 * amp * np.sin(phase + np.pi))
        set_joint("L_Shoulder", [0, 1, 0], -0.5 * amp * np.sin(phase))
        set_joint("R_Shoulder", [0, 1, 0], 0.5 * amp * np.sin(phase))
        set_joint("L_Elbow", [0, 1, 0], 0.3 * amp * (1 + np.sin(phase)))
        set_joint("R_Elbow", [0, 1, 0], 0.3 * amp * (1 - np.sin(phase)))
        set_joint("Torso", [0, 0, 1], 0.1 * amp * np.sin(phase))

        direction = np.asarray([np.cos(heading), np.sin(heading), 0.0])
        root_translation = (
            t[:, None] * speed * direction[None, :]
            + np.asarray([0.0, 0.0, pelvis_height])
            + np.stack([np.zeros(T), np.zeros(T), 0.02 * np.sin(2 * phase)], axis=-1)
        ).astype(np.float32)

        clips.append({"fps": fps, "local_rotation": local_rot, "root_translation": root_translation})
    return clips


def _qmul(a, b):
    """xyzw quaternion product, numpy, broadcasting over leading dims."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    ).astype(np.float32)


def make_hard_clips(tree: SkeletonTree, fps: float = 30.0) -> tuple[list[dict], list[str]]:
    """The HARD synthetic benchmark suite: deterministic clips with the
    dynamic content the easy walking clips lack — fast running, spins,
    jumps, getting up from supine, sharp turns, crouch-walking.

    Plays the role of the reference's AMASS eval sweep
    (phc/learning/im_amp.py:136-363) as a hermetic, committed stress set:
    `python -m pulse_tpu_torch.bench_quality` trains on these and reports
    per-clip success/MPJPE, held against the JAX package's committed runs
    (quality/ab_*_r5.json).

    Returns (clips, names); clip dicts match make_synthetic_clips."""
    J = tree.num_joints
    names = tree.node_names

    def base(T):
        lr = np.tile(np.asarray([0, 0, 0, 1.0], np.float32), (T, J, 1))
        return lr

    def set_joint(lr, name, axis, angle):
        if name in names:
            lr[:, names.index(name)] = _aa(axis, angle)

    clips, clip_names = [], []

    def add(name, lr, root_t):
        clips.append(
            {
                "fps": fps,
                "local_rotation": lr.astype(np.float32),
                "root_translation": root_t.astype(np.float32),
            }
        )
        clip_names.append(name)

    # 1. fast run: 3.5 m/s, 2.4 Hz stride, large hip/knee excursion
    T = int(3.0 * fps) + 1
    t = np.arange(T) / fps
    ph = 2 * np.pi * 2.4 * t
    lr = base(T)
    set_joint(lr, "L_Hip", [0, 1, 0], 0.75 * np.sin(ph))
    set_joint(lr, "R_Hip", [0, 1, 0], -0.75 * np.sin(ph))
    set_joint(lr, "L_Knee", [0, 1, 0], 1.1 * np.clip(np.sin(ph + np.pi / 2), 0, None))
    set_joint(lr, "R_Knee", [0, 1, 0], 1.1 * np.clip(-np.sin(ph + np.pi / 2), 0, None))
    set_joint(lr, "L_Ankle", [0, 1, 0], 0.3 * np.sin(ph + np.pi))
    set_joint(lr, "R_Ankle", [0, 1, 0], -0.3 * np.sin(ph + np.pi))
    set_joint(lr, "L_Shoulder", [0, 1, 0], -0.6 * np.sin(ph))
    set_joint(lr, "R_Shoulder", [0, 1, 0], 0.6 * np.sin(ph))
    set_joint(lr, "L_Elbow", [0, 1, 0], 0.5 * (1 + np.sin(ph)))
    set_joint(lr, "R_Elbow", [0, 1, 0], 0.5 * (1 - np.sin(ph)))
    root = np.stack(
        [3.5 * t, np.zeros(T), 0.93 + 0.04 * np.sin(2 * ph)], axis=-1
    )
    add("fast_run", lr, root)

    # 2. spin: two full in-place yaw turns in 3 s, arms out
    T = int(3.0 * fps) + 1
    t = np.arange(T) / fps
    lr = base(T)
    yaw = 2 * np.pi * (2.0 / 3.0) * t
    lr[:, 0] = _aa([0, 0, 1], yaw)
    set_joint(lr, "L_Shoulder", [1, 0, 0], np.full(T, -1.2))
    set_joint(lr, "R_Shoulder", [1, 0, 0], np.full(T, 1.2))
    root = np.stack([np.zeros(T), np.zeros(T), np.full(T, 0.93)], axis=-1)
    add("spin", lr, root)

    # 3. jump: periodic crouch + ballistic-ish flight (1 Hz)
    T = int(3.0 * fps) + 1
    t = np.arange(T) / fps
    lr = base(T)
    ph = 2 * np.pi * 1.0 * t
    crouch = 0.9 * np.clip(-np.sin(ph), 0, None)     # knees bend in the dip
    flight = 0.30 * np.clip(np.sin(ph), 0, None) ** 2
    set_joint(lr, "L_Hip", [0, 1, 0], -0.7 * crouch)
    set_joint(lr, "R_Hip", [0, 1, 0], -0.7 * crouch)
    set_joint(lr, "L_Knee", [0, 1, 0], 1.2 * crouch)
    set_joint(lr, "R_Knee", [0, 1, 0], 1.2 * crouch)
    set_joint(lr, "L_Ankle", [0, 1, 0], -0.5 * crouch)
    set_joint(lr, "R_Ankle", [0, 1, 0], -0.5 * crouch)
    set_joint(lr, "L_Shoulder", [0, 1, 0], -1.0 * crouch + 0.8 * flight / 0.3)
    set_joint(lr, "R_Shoulder", [0, 1, 0], -1.0 * crouch + 0.8 * flight / 0.3)
    z = 0.93 - 0.25 * crouch + flight
    root = np.stack([0.3 * t, np.zeros(T), z], axis=-1)
    add("jump", lr, root)

    # 4. getup from supine: lie on the back, roll up to standing over 4 s
    T = int(4.0 * fps) + 1
    t = np.arange(T) / fps
    lr = base(T)
    # progress 0 -> 1 with smoothstep; pitch -pi/2 (supine) -> 0 (upright)
    s = np.clip(t / 3.0, 0.0, 1.0)
    s = s * s * (3 - 2 * s)
    pitch = -(np.pi / 2) * (1.0 - s)
    lr[:, 0] = _aa([0, 1, 0], pitch)
    # knees/hips tuck through the middle of the motion
    tuck = np.sin(np.pi * s) * 1.2
    set_joint(lr, "L_Hip", [0, 1, 0], -0.8 * tuck)
    set_joint(lr, "R_Hip", [0, 1, 0], -0.8 * tuck)
    set_joint(lr, "L_Knee", [0, 1, 0], tuck)
    set_joint(lr, "R_Knee", [0, 1, 0], tuck)
    z = 0.15 + (0.93 - 0.15) * s
    root = np.stack([np.zeros(T), np.zeros(T), z], axis=-1)
    add("getup_supine", lr, root)

    # 5. sharp turns: 1.6 m/s walk, 90-degree heading flips every second
    T = int(4.0 * fps) + 1
    t = np.arange(T) / fps
    ph = 2 * np.pi * 1.6 * t
    lr = base(T)
    seg = np.minimum((t // 1.0).astype(int), 3)
    head_targets = np.asarray([0.0, np.pi / 2, 0.0, -np.pi / 2])
    # quarter-second blend measured from the (clipped) segment start —
    # (t % 1.0) put the final frame (t=4.0) at frac=0, snapping the heading
    # -90° -> 0° in ONE frame (a 33.8 m/s body teleport that made the clip
    # untrackable by ANY policy; success requires holding to the clip end)
    frac = np.clip((t - seg) / 0.25, 0, 1)
    prev = head_targets[np.maximum(seg - 1, 0)]
    heading = prev + (head_targets[seg] - prev) * frac
    lr[:, 0] = _aa([0, 0, 1], heading)
    set_joint(lr, "L_Hip", [0, 1, 0], 0.5 * np.sin(ph))
    set_joint(lr, "R_Hip", [0, 1, 0], -0.5 * np.sin(ph))
    set_joint(lr, "L_Knee", [0, 1, 0], 0.6 * np.clip(np.sin(ph + np.pi / 2), 0, None))
    set_joint(lr, "R_Knee", [0, 1, 0], 0.6 * np.clip(-np.sin(ph + np.pi / 2), 0, None))
    set_joint(lr, "L_Shoulder", [0, 1, 0], -0.4 * np.sin(ph))
    set_joint(lr, "R_Shoulder", [0, 1, 0], 0.4 * np.sin(ph))
    direction = np.stack([np.cos(heading), np.sin(heading)], axis=-1)
    xy = np.cumsum(1.6 * direction / fps, axis=0)
    root = np.concatenate(
        [xy, (0.93 + 0.02 * np.sin(2 * ph))[:, None]], axis=-1
    )
    add("sharp_turns", lr, root)

    # 6. crouch walk: deep flexion, 0.8 m/s. Pelvis at 0.74 m: with this
    # leg pose FK puts the feet AT the ground (median lowest-foot z ~+0.02,
    # matching the walking clips); the original 0.62 m buried the feet
    # 3-14 cm UNDER the floor for the whole clip — a physically impossible
    # imitation target no policy (or oracle) could ever satisfy
    T = int(4.0 * fps) + 1
    t = np.arange(T) / fps
    ph = 2 * np.pi * 1.2 * t
    lr = base(T)
    set_joint(lr, "L_Hip", [0, 1, 0], -0.8 + 0.35 * np.sin(ph))
    set_joint(lr, "R_Hip", [0, 1, 0], -0.8 - 0.35 * np.sin(ph))
    set_joint(lr, "L_Knee", [0, 1, 0], 1.5 + 0.3 * np.sin(ph + np.pi / 2))
    set_joint(lr, "R_Knee", [0, 1, 0], 1.5 - 0.3 * np.sin(ph + np.pi / 2))
    set_joint(lr, "L_Ankle", [0, 1, 0], np.full(T, -0.6))
    set_joint(lr, "R_Ankle", [0, 1, 0], np.full(T, -0.6))
    root = np.stack([0.8 * t, np.zeros(T), np.full(T, 0.74)], axis=-1)
    add("crouch_walk", lr, root)

    return clips, clip_names


def _ground_root_z(tree: SkeletonTree, local_rot, root_xy_z, clearance=0.02):
    """Shift a clip's root z so the lowest foot body sits at `clearance`
    (median over frames). ≙ the reference's MotionLibSMPL height fix
    (phc/utils/motion_lib_smpl.py fix_trans_height) — without it deep-crouch
    clips bury the feet under the floor, a physically impossible target
    (the v1 crouch_walk bug, see make_hard_clips)."""
    feet = [i for i, n in enumerate(tree.node_names)
            if "Ankle" in n or "Toe" in n or "Foot" in n]
    _, gpos = forward_kinematics(
        tree, torch.as_tensor(np.asarray(local_rot, np.float32)),
        torch.as_tensor(np.asarray(root_xy_z, np.float32)),
    )
    lowest = np.median(gpos.numpy()[:, feet, 2].min(axis=1))
    out = np.array(root_xy_z, np.float32)
    out[:, 2] += np.float32(clearance - lowest)
    return out


def make_graded_suite(
    tree: SkeletonTree, fps: float = 30.0
) -> tuple[list[dict], list[str], dict[str, list[int]]]:
    """Graded family benchmark: 6 motion families x 5 difficulty levels
    (30 clips), each family parameterized by ONE physical difficulty knob.
    Gives success-% real resolution (1 clip = 3.3%), localizes regressions
    to a family/level, and runs PMCP at an M where categorical reweighting
    matters — the hermetic stand-in for the reference's whole-DB eval
    (phc/learning/im_amp.py:136-242 over ~11k AMASS clips).

    Levels marked (=v2) are bit-identical to the corresponding
    make_hard_clips clip (pinned by tests/test_torch_eval.py), so graded
    results calibrate directly against the committed v2 targets.

    families:
      run     speed 1.5..4.4 m/s          (3.5 = fast_run v2)
      spin    yaw rate 0.25..0.85 rev/s   (2/3 = spin v2)
      jump    flight height 0.12..0.55 m  (0.30 = jump v2)
      getup   rise time 3.75..1.2 s       (3.0 = getup_supine v2)
      turn    heading-blend 0.8..0.25 s   (0.25 = sharp_turns v2)
      crouch  flexion scale 0.55..1.15    (1.0 = crouch_walk v2)

    Returns (clips, names, families: family -> clip indices easy->hard)."""
    J = tree.num_joints
    names = tree.node_names

    def base(T):
        return np.tile(np.asarray([0, 0, 0, 1.0], np.float32), (T, J, 1))

    def set_joint(lr, name, axis, angle):
        if name in names:
            lr[:, names.index(name)] = _aa(axis, angle)

    clips, clip_names = [], []
    families: dict[str, list[int]] = {}

    def add(family, label, lr, root_t):
        families.setdefault(family, []).append(len(clips))
        clips.append({
            "fps": fps,
            "local_rotation": lr.astype(np.float32),
            "root_translation": root_t.astype(np.float32),
        })
        clip_names.append(f"{family}_{label}")

    # ---- run: speed knob; gait freq/amplitudes scale with sqrt(v/3.5) so
    # the 3.5 m/s level reproduces fast_run exactly ----------------------- #
    for v in (1.5, 2.2, 2.9, 3.5, 4.4):
        T = int(3.0 * fps) + 1
        t = np.arange(T) / fps
        s = np.sqrt(v / 3.5)
        ph = 2 * np.pi * (2.4 * s) * t
        lr = base(T)
        set_joint(lr, "L_Hip", [0, 1, 0], 0.75 * s * np.sin(ph))
        set_joint(lr, "R_Hip", [0, 1, 0], -0.75 * s * np.sin(ph))
        set_joint(lr, "L_Knee", [0, 1, 0],
                  1.1 * s * np.clip(np.sin(ph + np.pi / 2), 0, None))
        set_joint(lr, "R_Knee", [0, 1, 0],
                  1.1 * s * np.clip(-np.sin(ph + np.pi / 2), 0, None))
        set_joint(lr, "L_Ankle", [0, 1, 0], 0.3 * np.sin(ph + np.pi))
        set_joint(lr, "R_Ankle", [0, 1, 0], -0.3 * np.sin(ph + np.pi))
        set_joint(lr, "L_Shoulder", [0, 1, 0], -0.6 * s * np.sin(ph))
        set_joint(lr, "R_Shoulder", [0, 1, 0], 0.6 * s * np.sin(ph))
        set_joint(lr, "L_Elbow", [0, 1, 0], 0.5 * (1 + np.sin(ph)))
        set_joint(lr, "R_Elbow", [0, 1, 0], 0.5 * (1 - np.sin(ph)))
        root = np.stack(
            [v * t, np.zeros(T), 0.93 + 0.04 * np.sin(2 * ph)], axis=-1
        )
        add("run", f"{v:g}ms", lr, root)

    # ---- spin: in-place yaw rate knob, arms out -------------------------- #
    for rate in (0.25, 0.4, 0.55, 2.0 / 3.0, 0.85):
        T = int(3.0 * fps) + 1
        t = np.arange(T) / fps
        lr = base(T)
        lr[:, 0] = _aa([0, 0, 1], 2 * np.pi * rate * t)
        set_joint(lr, "L_Shoulder", [1, 0, 0], np.full(T, -1.2))
        set_joint(lr, "R_Shoulder", [1, 0, 0], np.full(T, 1.2))
        root = np.stack([np.zeros(T), np.zeros(T), np.full(T, 0.93)], axis=-1)
        add("spin", f"{rate:.2f}rps", lr, root)

    # ---- jump: flight-height knob; crouch depth scales with sqrt(h/0.3)
    # so the 0.30 m level reproduces jump exactly -------------------------- #
    for h in (0.12, 0.20, 0.30, 0.42, 0.55):
        T = int(3.0 * fps) + 1
        t = np.arange(T) / fps
        lr = base(T)
        ph = 2 * np.pi * 1.0 * t
        s = np.sqrt(h / 0.30)
        crouch = (0.9 * s) * np.clip(-np.sin(ph), 0, None)
        flight = h * np.clip(np.sin(ph), 0, None) ** 2
        set_joint(lr, "L_Hip", [0, 1, 0], -0.7 * crouch)
        set_joint(lr, "R_Hip", [0, 1, 0], -0.7 * crouch)
        set_joint(lr, "L_Knee", [0, 1, 0], 1.2 * crouch)
        set_joint(lr, "R_Knee", [0, 1, 0], 1.2 * crouch)
        set_joint(lr, "L_Ankle", [0, 1, 0], -0.5 * crouch)
        set_joint(lr, "R_Ankle", [0, 1, 0], -0.5 * crouch)
        set_joint(lr, "L_Shoulder", [0, 1, 0], -1.0 * crouch + 0.8 * flight / h)
        set_joint(lr, "R_Shoulder", [0, 1, 0], -1.0 * crouch + 0.8 * flight / h)
        z = 0.93 - 0.25 * crouch + flight
        root = np.stack([0.3 * t, np.zeros(T), z], axis=-1)
        add("jump", f"{h:g}m", lr, root)

    # ---- getup: rise-time knob (shorter = harder); 3.0 s reproduces
    # getup_supine exactly (clip length = rise + 1 s hold) ----------------- #
    for rise in (3.75, 3.0, 2.4, 1.8, 1.2):
        T = int((rise + 1.0) * fps) + 1
        t = np.arange(T) / fps
        lr = base(T)
        s = np.clip(t / rise, 0.0, 1.0)
        s = s * s * (3 - 2 * s)
        lr[:, 0] = _aa([0, 1, 0], -(np.pi / 2) * (1.0 - s))
        tuck = np.sin(np.pi * s) * 1.2
        set_joint(lr, "L_Hip", [0, 1, 0], -0.8 * tuck)
        set_joint(lr, "R_Hip", [0, 1, 0], -0.8 * tuck)
        set_joint(lr, "L_Knee", [0, 1, 0], tuck)
        set_joint(lr, "R_Knee", [0, 1, 0], tuck)
        z = 0.15 + (0.93 - 0.15) * s
        root = np.stack([np.zeros(T), np.zeros(T), z], axis=-1)
        add("getup", f"{rise:g}s", lr, root)

    # ---- turn: heading-blend knob at fixed 1.6 m/s; 0.25 s reproduces
    # sharp_turns exactly — the family IS the sharp-turn curriculum -------- #
    for blend in (0.8, 0.6, 0.45, 0.35, 0.25):
        T = int(4.0 * fps) + 1
        t = np.arange(T) / fps
        ph = 2 * np.pi * 1.6 * t
        lr = base(T)
        seg = np.minimum((t // 1.0).astype(int), 3)
        head_targets = np.asarray([0.0, np.pi / 2, 0.0, -np.pi / 2])
        frac = np.clip((t - seg) / blend, 0, 1)
        prev = head_targets[np.maximum(seg - 1, 0)]
        heading = prev + (head_targets[seg] - prev) * frac
        lr[:, 0] = _aa([0, 0, 1], heading)
        set_joint(lr, "L_Hip", [0, 1, 0], 0.5 * np.sin(ph))
        set_joint(lr, "R_Hip", [0, 1, 0], -0.5 * np.sin(ph))
        set_joint(lr, "L_Knee", [0, 1, 0],
                  0.6 * np.clip(np.sin(ph + np.pi / 2), 0, None))
        set_joint(lr, "R_Knee", [0, 1, 0],
                  0.6 * np.clip(-np.sin(ph + np.pi / 2), 0, None))
        set_joint(lr, "L_Shoulder", [0, 1, 0], -0.4 * np.sin(ph))
        set_joint(lr, "R_Shoulder", [0, 1, 0], 0.4 * np.sin(ph))
        direction = np.stack([np.cos(heading), np.sin(heading)], axis=-1)
        xy = np.cumsum(1.6 * direction / fps, axis=0)
        root = np.concatenate(
            [xy, (0.93 + 0.02 * np.sin(2 * ph))[:, None]], axis=-1
        )
        add("turn", f"{blend:g}s", lr, root)

    # ---- crouch: flexion-scale knob; pelvis height from FK foot-grounding
    # (the scale-1.0 level pins to v2's hand-fixed 0.74 m) ----------------- #
    for c in (0.55, 0.7, 0.85, 1.0, 1.15):
        T = int(4.0 * fps) + 1
        t = np.arange(T) / fps
        ph = 2 * np.pi * 1.2 * t
        lr = base(T)
        set_joint(lr, "L_Hip", [0, 1, 0], -0.8 * c + 0.35 * np.sin(ph))
        set_joint(lr, "R_Hip", [0, 1, 0], -0.8 * c - 0.35 * np.sin(ph))
        set_joint(lr, "L_Knee", [0, 1, 0], 1.5 * c + 0.3 * np.sin(ph + np.pi / 2))
        set_joint(lr, "R_Knee", [0, 1, 0], 1.5 * c - 0.3 * np.sin(ph + np.pi / 2))
        set_joint(lr, "L_Ankle", [0, 1, 0], np.full(T, -0.6 * c))
        set_joint(lr, "R_Ankle", [0, 1, 0], np.full(T, -0.6 * c))
        root = np.stack([0.8 * t, np.zeros(T), np.full(T, 0.74)], axis=-1)
        if c != 1.0:
            # match v2's grounding: v2's hand-fixed 0.74 m pelvis puts the
            # median lowest foot at ~+0.02; FK re-derives that per level
            root = _ground_root_z(tree, lr, root, clearance=0.02)
        add("crouch", f"{c:g}x", lr, root)

    return clips, clip_names, families
