"""The pedestrian-terrain task: trajectory following over a heightfield,
batched over envs.

Counterpart of `pulse_tpu/env/humanoid_terrain.py` (PHC's
HumanoidPedestrianTerrain): the traj task (`HumanoidTrajEnv`) on the
generated curriculum terrain (`env/terrain.py` `GeneratedTerrain` of the
default `TerrainConfig`: 8 x 8 tiles of 8 m at 0.25 m cells, seed 0), with

  * spawns on walkable cells, the reference-state pose lifted by the ground
    height there, and the trajectory drawn from the spawn;
  * a height-map observation after the traj obs: the ground heights at a
    16 x 16 grid at 0.25 m in the heading frame (the JAX package's default
    "grid" sensor), as root height - ground - 0.9, clipped to [-2, 2];
  * the fall check on each body's height above the ground under it
    (`HumanoidTaskEnv`), and the plain physics step with terrain contact:
    no kernel covers terrain (`physics_route` "plain"), as no TPU kernel
    does.

The JAX package's other sensor layouts and its scanned-scene terrain
(`MeshTerrain`) are set by no config or entry point there and are not
ported (ROADMAP). Spawn cells come from the env's generator through
`_sample_reset`, which a test can replace to feed given draws.
"""

from __future__ import annotations

import numpy as np
import torch

from pulse_tpu_torch._device import resolve_device
from pulse_tpu_torch.env.humanoid_task import HumanoidTrajEnv, TaskEnvState
from pulse_tpu_torch.env.terrain import GeneratedTerrain, TerrainConfig, height_map_points, terrain_height
from pulse_tpu_torch.ops import quat as q


class HumanoidPedestrianTerrainEnv(HumanoidTrajEnv):
    def __init__(self, model, motion, config=None, device=None, seed: int = 0):
        device = resolve_device(device)
        self.terrain = t = GeneratedTerrain.generate(TerrainConfig(), device=device)
        # the same field again on a model that has it changes nothing, so
        # with_config can pass self.model back through here
        model = model.with_terrain(t.heights, t.cell_size, t.origin)
        super().__init__(model, motion, config, device=device, seed=seed)
        pts = height_map_points()
        self._hm_points = torch.as_tensor(np.concatenate([pts, np.zeros((pts.shape[0], 1), np.float32)], axis=-1),
                                          device=self.device)
        self.height_map_dim = pts.shape[0]
        self.task_obs_dim = 2 * self.config.traj_num_samples + self.height_map_dim
        self.obs_dim = self.self_obs_dim + self.task_obs_dim
        # the mirror of the height map across the heading axis: each point's
        # nearest point with y negated
        flipped = pts * np.asarray([1.0, -1.0], np.float32)
        d = np.linalg.norm(pts[None, :, :] - flipped[:, None, :], axis=-1)
        self._hm_flip_perm = torch.as_tensor(np.argmin(d, axis=1), device=self.device)

    def _ground_z(self, xy: torch.Tensor) -> torch.Tensor:
        m = self.model
        return terrain_height(m.terrain_heights, m.terrain_cell, m.terrain_origin, xy)

    def _sample_task(self, n: int) -> dict:
        """The trajectory's draws and the spawn cells [n] ("spawn")."""
        draws = super()._sample_task(n)
        draws["spawn"] = torch.randint(0, self.terrain.walkable_xy.shape[0], (n,), generator=self.generator,
                                       device=self.device)
        return draws

    def _fresh(self, motion_ids: torch.Tensor, start_times: torch.Tensor, draws: dict) -> TaskEnvState:
        """The reference-state init moved onto its spawn cell and lifted by
        the ground height there, its trajectory drawn from the spawn."""
        state = super()._fresh(motion_ids, start_times, draws)
        ph = state.physics
        xy = self.terrain.sample_valid_locations(motion_ids.shape[0], idx=draws["spawn"])
        root_pos = torch.cat([xy, ph.root_pos[:, 2:3] + self._ground_z(xy)[:, None]], dim=-1)
        ph = ph.replace(root_pos=root_pos, body_pos=ph.body_pos + (root_pos - ph.root_pos)[:, None])
        return state.replace(physics=ph, task=self._reset_task(draws, ph))

    def _height_map_obs(self, state: TaskEnvState) -> torch.Tensor:
        """[B, height_map_dim]: root height - ground - 0.9 at the sensor
        points in the heading frame, clipped to [-2, 2]."""
        ph = state.physics
        heading = q.calc_heading_quat(ph.root_rot)
        world = q.quat_rotate(heading[:, None], self._hm_points[None])[..., 0:2] + ph.root_pos[:, None, 0:2]
        return torch.clamp(ph.root_pos[:, 2:3] - self._ground_z(world) - 0.9, -2.0, 2.0)

    def _task_obs(self, state: TaskEnvState) -> torch.Tensor:
        return torch.cat([super()._task_obs(state), self._height_map_obs(state)], dim=-1)

    def flip_task_obs(self, task_obs: torch.Tensor) -> torch.Tensor:
        """The task obs [..., task_obs_dim] mirrored across the heading axis:
        the trajectory samples' heading-local y negated, the height map
        permuted to the mirrored points."""
        n_traj = 2 * self.config.traj_num_samples
        lead = task_obs.shape[:-1]
        traj = task_obs[..., :n_traj].reshape(*lead, -1, 2) * task_obs.new_tensor([1.0, -1.0])
        return torch.cat([traj.reshape(*lead, -1), task_obs[..., n_traj:][..., self._hm_flip_perm]], dim=-1)
