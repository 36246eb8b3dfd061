"""Why the port clamps the strike box's velocities: a box whose velocities
grow without bound under the JAX package's prop integrator, reproduced on
the CPU and stepped by both packages.

    python tests/prop_divergence.py [--envs 64] [--steps 300] [--seed 0]

Steps `HumanoidStrikeEnv` (`env=strike`) on the CPU with uniform random
actions and the prop step's velocity clamp taken out (the JAX package's
integrator), until some box's angular velocity passes 60 rad/s. From the
last control step at which that box was at rest, it steps that env again
substep by substep: the port's unclamped `prop_step` and the JAX
package's `pulse_tpu.physics.prop.prop_step`, both fed the same humanoid
kinematics. Then it lifts the box, as it was at its first speed over
5 rad/s, 20 m into the air, away from every contact, and runs both
integrators 600 substeps (5 s) in free flight. Prints one JSON object:
per substep the box's |w| under each package, the force of the humanoid's
contact on it and the deepest box corner; the free-flight |w| every 60
substeps.

Imports both packages, as the tests do; it is not collected by pytest.
"""

import argparse
import dataclasses
import inspect
import json
import os
import sys
import textwrap

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pulse_tpu.physics import prop as jax_prop

from pulse_tpu_torch import run
from pulse_tpu_torch.ops import quat as q
from pulse_tpu_torch.physics import prop
from pulse_tpu_torch.physics import step as torch_step
from pulse_tpu_torch.physics.step import _substep, refresh_kinematics
from pulse_tpu_torch.utils.config import load_config


def unclamped_prop_step():
    """The port's prop_step without its velocity clamp: the JAX package's
    integrator."""
    src = textwrap.dedent(inspect.getsource(prop.prop_step))
    for clamped, plain in (
            ("lin_vel = torch.clamp(prop.lin_vel + h * force / m, -vmax, vmax)", "lin_vel = prop.lin_vel + h * force / m"),
            ("w_body = torch.clamp(w_body + h * (t_body - q.cross(w_body, I_diag * w_body)) / I_diag, -wmax, wmax)",
             "w_body = w_body + h * (t_body - q.cross(w_body, I_diag * w_body)) / I_diag")):
        assert clamped in src, "prop_step's clamp changed; update this script"
        src = src.replace(clamped, plain)
    ns = dict(prop.__dict__)
    exec(src, ns)
    return ns["prop_step"]


def one_env(tree, k):
    return type(tree)(**{f.name: getattr(tree, f.name)[k:k + 1] for f in dataclasses.fields(tree)})


def to_jax(p):
    return jax_prop.PropState(**{f.name: jnp.asarray(getattr(p, f.name)[0].numpy()) for f in dataclasses.fields(p)})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    step_prop = unclamped_prop_step()
    torch_step.prop_step = step_prop
    cfg = load_config(["env=strike", "learning=pulse_z_task", "device=cpu"])
    spec, model = run.build_model_from_cfg(cfg, "cpu")
    env = run.build_task_env_from_cfg(cfg, model, run.build_motion_from_cfg(cfg, spec, "cpu"), "cpu")
    ps, h, n_sub = env.prop_spec, model.config.h, model.config.steps_per_control
    g = torch.Generator().manual_seed(args.seed)

    # ---- roll until a box passes 60 rad/s ------------------------------- #
    st, hist, k = env.reset(args.envs), [], None
    with torch.no_grad():
        for t in range(args.steps):
            a = torch.clamp(torch.randn(args.envs, env.action_dim, generator=g), -1.0, 1.0)
            hist = (hist + [(st, a)])[-12:]
            st = env.step(st, a)
            w = torch.linalg.vector_norm(st.task["prop"].ang_vel, dim=-1).nan_to_num(1e30)
            if (w > 60.0).any():
                k = int(torch.nonzero(w > 60.0)[0])
                break
    if k is None:
        print(json.dumps({"diverged": False, "steps": args.steps}))
        return 1

    # ---- that env again, substep by substep, under both packages ----------- #
    jax_spec = jax_prop.PropSpec(half_extents=ps.half_extents, density=ps.density, friction=ps.friction)
    from pulse_tpu.assets import load_smpl_humanoid as jax_load_smpl
    from pulse_tpu.physics import PhysicsConfig as JaxPhysicsConfig, build_model as jax_build_model

    jcfg = JaxPhysicsConfig(**{f.name: getattr(model.config, f.name) for f in dataclasses.fields(JaxPhysicsConfig)
                               if hasattr(model.config, f.name)})
    jmodel = jax_build_model(jax_load_smpl(), jcfg)
    jstep = jax.jit(lambda p, bp, br, bv, bw: jax_prop.prop_step(jmodel, jax_spec, p, bp, br, bv, bw, h))
    speed = [float(torch.linalg.vector_norm(s.task["prop"].ang_vel[k])) for s, _ in hist]
    i0 = max(i for i, wk in enumerate(speed) if wk < 1e-3)
    phys, pr = one_env(hist[i0][0].physics, k), one_env(hist[i0][0].task["prop"], k)
    jpr = to_jax(pr)
    corners = torch.as_tensor(np.asarray(ps.corners), dtype=torch.float32)
    rows = []
    with torch.no_grad():
        for ci in range(i0, len(hist)):
            pd = env.action_to_pd_target(hist[ci][1][k:k + 1])
            for sub in range(n_sub):
                phys = refresh_kinematics(model, phys)
                kin = (phys.body_pos, phys.body_rot, phys.body_vel, phys.body_ang_vel)
                new, f_ext_h, contact = step_prop(model, ps, pr, *kin, h)
                jpr = jstep(jpr, *(jnp.asarray(x[0].numpy()) for x in kin))[0]
                cw = pr.pos[0] + q.quat_rotate(pr.rot[0].expand(8, 4), corners)
                rows.append({"control_step": ci - i0, "substep": sub,
                             "w_port": float(torch.linalg.vector_norm(new.ang_vel[0])),
                             "w_jax": float(jnp.linalg.norm(jpr.ang_vel)),
                             "humanoid_contact_N": float(torch.linalg.vector_norm(contact[0])),
                             "deepest_corner_m": float(-cw[:, 2].min())})
                phys = _substep(model, phys, pd, h, f_ext_extra=f_ext_h)
                pr = new

        # ---- free flight from the box's first speed over 5 rad/s ----------- #
        first = next(s for s in [s for s, _ in hist] + [st]
                     if float(torch.linalg.vector_norm(s.task["prop"].ang_vel[k])) > 5.0)
        p0 = one_env(first.task["prop"], k)
        fp = dataclasses.replace(p0, pos=p0.pos + torch.tensor([0.0, 0.0, 20.0]), lin_vel=torch.zeros(1, 3))
        jfp = to_jax(fp)
        J = model.num_bodies
        far = torch.full((1, J, 3), 1e3)
        unit = torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(1, J, 4)
        zero = torch.zeros(1, J, 3)
        free = []
        for i in range(600):
            fp = step_prop(model, ps, fp, far, unit, zero, zero, h)[0]
            jfp = jstep(jfp, *(jnp.asarray(x[0].numpy()) for x in (far, unit, zero, zero)))[0]
            if i % 60 == 59:
                free.append({"substep": i + 1, "w_port": float(torch.linalg.vector_norm(fp.ang_vel[0])),
                             "w_jax": float(jnp.linalg.norm(jfp.ang_vel))})
    print(json.dumps({"diverged": True, "env": k, "control_step": t, "envs": args.envs, "seed": args.seed,
                      "h": h, "substeps": n_sub, "box_mass_kg": ps.mass, "box_inertia": list(map(float, ps.inertia_diag)),
                      "contact_stiffness": model.config.contact_stiffness,
                      "contact_damping": model.config.contact_damping, "struck": rows,
                      "free_flight_from_w": float(torch.linalg.vector_norm(p0.ang_vel[0])), "free_flight": free}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
