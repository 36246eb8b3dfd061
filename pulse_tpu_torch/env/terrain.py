"""Procedural terrain: heightfield generation, height and normal queries,
the walkable-cell table and the height-map sensor grid.

Counterpart of the parts of `pulse_tpu/env/terrain.py` (PHC's
humanoid_pedestrian_terrain Terrain and its height-point initializers)
that the pedestrian-terrain env runs:

  * `generate_heightfield`: the curriculum grid of flat, pyramid-slope,
    stair and obstacle tiles, host numpy with the same `default_rng`
    calls, so the heights are bit-equal to the JAX package's;
  * `terrain_height` / `terrain_normal`: batched bilinear gathers of a
    [H, W] device heightfield (clamped at the border, so the border height
    extends outside), and the normal of its central differences;
  * `GeneratedTerrain`: a generated field and the world xy of every
    walkable cell on a device; `sample_valid_locations` draws spawns from
    an explicit generator or takes the caller's cell indices;
  * `height_map_points` (the "grid" sensor) and
    `walkable_map_from_heightfield`.

The JAX module's scanned-scene terrain (`MeshTerrain`, mesh rasterization)
and its other sensor layouts are used by no config or entry point there
and are not ported (ROADMAP).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pulse_tpu_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class TerrainConfig:
    num_tiles_x: int = 8
    num_tiles_y: int = 8
    tile_size: float = 8.0          # m
    cell_size: float = 0.25         # m a heightfield cell
    # curriculum proportions
    p_flat: float = 0.3
    p_slope: float = 0.25
    p_stairs: float = 0.25
    p_obstacles: float = 0.2
    max_slope: float = 0.35         # rise / run
    stair_height: float = 0.15
    stair_run: float = 0.4
    obstacle_height: float = 0.2
    obstacle_size: float = 1.0


def generate_heightfield(cfg: TerrainConfig, seed: int = 0) -> np.ndarray:
    """[H, W] heights (m) of the tile grid; a tile's difficulty grows with
    its row."""
    rng = np.random.default_rng(seed)
    cells = int(cfg.tile_size / cfg.cell_size)
    H = cfg.num_tiles_x * cells
    W = cfg.num_tiles_y * cells
    field = np.zeros((H, W), np.float32)
    probs = np.asarray([cfg.p_flat, cfg.p_slope, cfg.p_stairs, cfg.p_obstacles])
    probs = probs / probs.sum()

    for tx in range(cfg.num_tiles_x):
        difficulty = (tx + 1) / cfg.num_tiles_x
        for ty in range(cfg.num_tiles_y):
            kind = rng.choice(4, p=probs)
            tile = np.zeros((cells, cells), np.float32)
            if kind == 1:  # pyramid slope
                slope = cfg.max_slope * difficulty * rng.uniform(0.5, 1.0)
                xx = np.minimum(np.arange(cells), np.arange(cells)[::-1])
                yy = np.minimum(np.arange(cells), np.arange(cells)[::-1])
                dist = np.minimum.outer(xx, yy).astype(np.float32)
                tile = dist * cfg.cell_size * slope
                if rng.uniform() < 0.5:
                    tile = tile.max() - tile  # a pit
            elif kind == 2:  # stairs
                h = cfg.stair_height * difficulty * rng.uniform(0.5, 1.0)
                run_cells = max(int(cfg.stair_run / cfg.cell_size), 1)
                steps = (np.arange(cells) // run_cells).astype(np.float32)
                if rng.uniform() < 0.5:
                    steps = steps[::-1]
                tile = np.tile((steps * h)[:, None], (1, cells))
            elif kind == 3:  # discrete obstacles
                n_obs = rng.integers(4, 10)
                size_cells = max(int(cfg.obstacle_size / cfg.cell_size), 1)
                for _ in range(n_obs):
                    ox = rng.integers(0, max(cells - size_cells, 1))
                    oy = rng.integers(0, max(cells - size_cells, 1))
                    h = cfg.obstacle_height * difficulty * rng.uniform(0.3, 1.0)
                    sign = 1.0 if rng.uniform() < 0.7 else -1.0
                    tile[ox : ox + size_cells, oy : oy + size_cells] = sign * h
            field[tx * cells : (tx + 1) * cells, ty * cells : (ty + 1) * cells] = tile
    return field


def terrain_height(heights: torch.Tensor, cell_size: float, origin: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear height at xy [..., 2] -> [...]; outside the field the
    border height extends."""
    H, W = heights.shape
    u = torch.clamp((xy[..., 0] - origin[0]) / cell_size, 0.0, H - 1.001)
    v = torch.clamp((xy[..., 1] - origin[1]) / cell_size, 0.0, W - 1.001)
    u0 = torch.floor(u).to(torch.long)
    v0 = torch.floor(v).to(torch.long)
    fu = u - u0.to(u.dtype)
    fv = v - v0.to(v.dtype)
    h00 = heights[u0, v0]
    h10 = heights[u0 + 1, v0]
    h01 = heights[u0, v0 + 1]
    h11 = heights[u0 + 1, v0 + 1]
    return h00 * (1 - fu) * (1 - fv) + h10 * fu * (1 - fv) + h01 * (1 - fu) * fv + h11 * fu * fv


def terrain_normal(heights: torch.Tensor, cell_size: float, origin: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Unit surface normal [..., 3] at xy [..., 2], from central differences
    one cell wide."""
    eps = cell_size
    ex = xy.new_tensor([eps, 0.0])
    ey = xy.new_tensor([0.0, eps])
    dx = (terrain_height(heights, cell_size, origin, xy + ex)
          - terrain_height(heights, cell_size, origin, xy - ex)) / (2 * eps)
    dy = (terrain_height(heights, cell_size, origin, xy + ey)
          - terrain_height(heights, cell_size, origin, xy - ey)) / (2 * eps)
    n = torch.stack([-dx, -dy, torch.ones_like(dx)], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def height_map_points(num_x: int = 16, num_y: int = 16, spacing: float = 0.25) -> np.ndarray:
    """A centred num_x x num_y grid [P, 2]."""
    gx, gy = np.meshgrid((np.arange(num_x) - (num_x - 1) / 2) * spacing, (np.arange(num_y) - (num_y - 1) / 2) * spacing,
                         indexing="ij")
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1).astype(np.float32)


def walkable_map_from_heightfield(heights: np.ndarray, cell_size: float, max_slope: float = 0.35,
                                  border_cells: int = 4) -> np.ndarray:
    """1 = walkable: cells no steeper than `max_slope`, outside a border
    apron of `border_cells`."""
    gx, gy = np.gradient(np.asarray(heights, np.float64), cell_size)
    walkable = (np.hypot(gx, gy) <= max_slope).astype(np.uint8)
    walkable[:border_cells] = 0
    walkable[-border_cells:] = 0
    walkable[:, :border_cells] = 0
    walkable[:, -border_cells:] = 0
    return walkable


@dataclasses.dataclass(frozen=True)
class GeneratedTerrain:
    """A generated heightfield and its walkable cells on a device."""

    heights: torch.Tensor          # [H, W] m
    walkable_xy: torch.Tensor      # [N, 2] world xy of the walkable cells
    cell_size: float
    origin: torch.Tensor           # [2] world xy of cell (0, 0)

    @classmethod
    def generate(cls, cfg: TerrainConfig, seed: int = 0, origin: tuple | None = None,
                 device=None) -> "GeneratedTerrain":
        """The field of `generate_heightfield`, centred on the world origin
        unless `origin` is given."""
        hm = generate_heightfield(cfg, seed)
        if origin is None:
            origin = (-hm.shape[0] * cfg.cell_size / 2, -hm.shape[1] * cfg.cell_size / 2)
        cx, cy = np.where(walkable_map_from_heightfield(hm, cfg.cell_size, cfg.max_slope) == 1)
        xy = np.stack([origin[0] + cx * cfg.cell_size, origin[1] + cy * cfg.cell_size], axis=-1).astype(np.float32)
        device = resolve_device(device)
        return cls(heights=torch.as_tensor(hm, device=device), walkable_xy=torch.as_tensor(xy, device=device),
                   cell_size=float(cfg.cell_size),
                   origin=torch.as_tensor(np.asarray(origin, np.float32), device=device))

    def sample_valid_locations(self, n: int, generator: torch.Generator | None = None,
                               idx: torch.Tensor | None = None) -> torch.Tensor:
        """[n, 2] spawn points: walkable cells drawn uniformly from
        `generator`, or the cells `idx` [n] the caller drew."""
        if idx is None:
            idx = torch.randint(0, self.walkable_xy.shape[0], (n,), generator=generator,
                                device=self.walkable_xy.device)
        return self.walkable_xy[idx.to(self.walkable_xy.device, torch.long)]
