"""Procedural terrain: a sampled heightmap or analytic fractal value noise.

Port of ``phys/terrain.py``. Both represent the reference's Raisim terrain
(500 x 20 m, 5000 x 500 samples, fractal value noise of 3 octaves,
lacunarity 2, gain 0.25, Environment.hpp:252-265):

* :class:`SampledTerrain` (``cfg.terrain_sampled``, the default): the
  heightmap with a bilinear lookup. One grid is shared by every env; an env's
  own stretch of ground comes from a random (x, y) offset into the map. The
  grid is built once a process by the same float64 numpy code as the JAX
  package's, cast to float32, and kept once a device as a tensor.
* :class:`TerrainParams` (``cfg.terrain_sampled=False``): the value noise
  evaluated at the query points, with a per-env seed and height scale. Its
  hash ``fract(sin(.) * 43758.5453)`` is computed in float32 in the JAX
  order of operations; a one-ulp difference between two ``sin``
  implementations still flips the hash now and then (up to 0.2 m at under
  1 % of points), so the port matches JAX's terrain in its statistics, not
  point for point.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod

MAP_X, MAP_Y = 500.0, 20.0   # metres covered by the grid


class TerrainParams(NamedTuple):
    """Per-env analytic fractal terrain; z_scale 0 is flat ground."""
    z_scale: torch.Tensor   # (B,) height scale (the curriculum writes it)
    seed: torch.Tensor      # (B,) float, decorrelates envs


class SampledTerrain(NamedTuple):
    """Per-env terrain; the grid itself is :func:`grid`, shared."""
    offset: torch.Tensor    # (B, 2) world-to-map offset [m]
    cell: torch.Tensor      # (B,) grid spacing [m]
    z_scale: torch.Tensor   # (B,) height scale (the curriculum writes it)


class TerrainRows(NamedTuple):
    """What the physics kernel reads: the grid and the per-env fields as rows."""
    grid: torch.Tensor      # (ny, nx) float32, contiguous
    offset: torch.Tensor    # (2, B)
    cell: torch.Tensor      # (B,)
    z_scale: torch.Tensor   # (B,)


@functools.lru_cache(maxsize=2)
def fractal_grid(nx: int = 5000, ny: int = 500, sx: float = MAP_X, sy: float = MAP_Y,
                 z_scale: float = 1.0, seed: float = 12.5) -> np.ndarray:
    """The (ny, nx) unscaled heightmap in float32, from float64 value noise
    with the reference's statistics (xSamples/ySamples/octaves/lacunarity/gain
    of Environment.hpp:254-262): the JAX package's ``_fractal_grid``."""
    xs = np.linspace(0.0, sx, nx, dtype=np.float64)
    ys = np.linspace(0.0, sy, ny, dtype=np.float64)
    X, Y = np.meshgrid(xs, ys)

    def hash2(ix, iy):
        h = np.sin(ix * 127.1 + iy * 311.7 + seed * 74.7) * 43758.5453
        return (h - np.floor(h)) * 2.0 - 1.0

    def vnoise(x, y):
        ix, iy = np.floor(x), np.floor(y)
        fx, fy = x - ix, y - iy
        s = lambda f: f * f * f * (f * (f * 6.0 - 15.0) + 10.0)  # noqa: E731
        sx_, sy_ = s(fx), s(fy)
        return (hash2(ix, iy) * (1 - sx_) * (1 - sy_)
                + hash2(ix + 1, iy) * sx_ * (1 - sy_)
                + hash2(ix, iy + 1) * (1 - sx_) * sy_
                + hash2(ix + 1, iy + 1) * sx_ * sy_)

    h = np.zeros_like(X)
    freq, gain = 1.0, 1.0
    for _ in range(3):           # fractalOctaves=3
        h += gain * vnoise(X * freq, Y * freq)
        freq *= 2.0              # fractalLacunarity
        gain *= 0.25             # fractalGain
    return (z_scale * h).astype(np.float32)


@functools.lru_cache(maxsize=4)
def grid(device: torch.device) -> torch.Tensor:
    """The shared heightmap as a contiguous float32 tensor on ``device``."""
    return dev_mod.tensor(fractal_grid(), device).contiguous()


def _cell() -> float:
    return MAP_X / (fractal_grid().shape[1] - 1)


def sampled_fractal(gen: torch.Generator, batch: int, z_scale: float,
                    device) -> SampledTerrain:
    """``batch`` envs on the shared grid, each at a random offset within 40 %
    of the map's extent around its centre (JAX ``sampled_fractal``). ``gen``
    must live on ``device``."""
    ny, nx = fractal_grid().shape
    cell = _cell()
    lim = dev_mod.tensor([(nx - 1) * cell * 0.4, (ny - 1) * cell * 0.4], device)
    center = dev_mod.tensor([(nx - 1) * cell / 2, (ny - 1) * cell / 2], device)
    u = torch.rand((batch, 2), generator=gen, device=device, dtype=dev_mod.DTYPE)
    return at_offsets(center + (-1.0 + 2.0 * u) * lim, z_scale)


def at_offsets(offset: torch.Tensor, z_scale: float) -> SampledTerrain:
    """Envs at the given (B, 2) offsets, every one at ``z_scale``."""
    B = offset.shape[0]
    full = lambda v: torch.full((B,), v, dtype=dev_mod.DTYPE, device=offset.device)  # noqa: E731
    return SampledTerrain(offset=offset.to(dev_mod.DTYPE), cell=full(_cell()),
                          z_scale=full(z_scale))


def flat(batch: int, device) -> SampledTerrain:
    """Ground at height 0 everywhere, as a terrain: z_scale 0."""
    return at_offsets(torch.zeros((batch, 2), dtype=dev_mod.DTYPE, device=device), 0.0)


def fractal(gen: torch.Generator, batch: int, z_scale: float, device) -> TerrainParams:
    """``batch`` envs of analytic terrain, each with a seed uniform in [0, 1000)
    (JAX ``fractal``). ``gen`` must live on ``device``."""
    u = torch.rand((batch,), generator=gen, device=device, dtype=dev_mod.DTYPE)
    return with_seeds(1000.0 * u, z_scale)


def with_seeds(seed: torch.Tensor, z_scale: float) -> TerrainParams:
    """Analytic terrain of the given (B,) seeds, every env at ``z_scale``."""
    seed = seed.to(dev_mod.DTYPE).contiguous()
    return TerrainParams(z_scale=torch.full_like(seed, z_scale), seed=seed)


def _hash2(ix: torch.Tensor, iy: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    h = torch.sin(ix * 127.1 + iy * 311.7 + seed * 74.7) * 43758.5453
    return (h - torch.floor(h)) * 2.0 - 1.0


def _value_noise(x: torch.Tensor, y: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    ix, iy = torch.floor(x), torch.floor(y)
    fx, fy = x - ix, y - iy
    # smootherstep keeps C2 continuity so normals are well-defined
    sx = fx * fx * fx * (fx * (fx * 6.0 - 15.0) + 10.0)
    sy = fy * fy * fy * (fy * (fy * 6.0 - 15.0) + 10.0)
    v00 = _hash2(ix, iy, seed)
    v10 = _hash2(ix + 1, iy, seed)
    v01 = _hash2(ix, iy + 1, seed)
    v11 = _hash2(ix + 1, iy + 1, seed)
    return (v00 * (1 - sx) * (1 - sy) + v10 * sx * (1 - sy)
            + v01 * (1 - sx) * sy + v11 * sx * sy)


def analytic_height(seed: torch.Tensor, z_scale: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """The JAX package's analytic ``height``, operation for operation: 3
    octaves (Environment.hpp:261) of value noise, lacunarity 2, gain 0.25.
    ``seed`` and ``z_scale`` broadcast against the points."""
    h = torch.zeros_like(x)
    freq, gain = 1.0, 1.0
    for _ in range(3):
        h = h + gain * _value_noise(x * freq, y * freq, seed)
        freq *= 2.0
        gain *= 0.25
    return z_scale * h


def rows(tp: SampledTerrain | TerrainParams) -> TerrainRows | TerrainParams:
    """The kernel's view of ``tp``: the grid on its device and the offsets as
    rows; an analytic terrain's (B,) rows, contiguous."""
    if isinstance(tp, TerrainParams):
        return TerrainParams(z_scale=tp.z_scale.contiguous(), seed=tp.seed.contiguous())
    return TerrainRows(grid=grid(tp.offset.device), offset=tp.offset.T.contiguous(),
                       cell=tp.cell.contiguous(), z_scale=tp.z_scale.contiguous())


def _bilinear(g: torch.Tensor, ox, oy, cell, z_scale, x, y) -> torch.Tensor:
    """The JAX package's ``_sampled_height``, operation for operation."""
    ny, nx = g.shape
    gx = torch.clamp((x + ox) / cell, 0.0, nx - 1.001)
    gy = torch.clamp((y + oy) / cell, 0.0, ny - 1.001)
    ixf, iyf = torch.floor(gx), torch.floor(gy)
    fx, fy = gx - ixf, gy - iyf
    ix, iy = ixf.long(), iyf.long()
    h00 = g[iy, ix]
    h10 = g[iy, ix + 1]
    h01 = g[iy + 1, ix]
    h11 = g[iy + 1, ix + 1]
    return z_scale * (h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy)
                      + h01 * (1 - fx) * fy + h11 * fx * fy)


def height(tp: SampledTerrain | TerrainRows | TerrainParams, x: torch.Tensor,
           y: torch.Tensor) -> torch.Tensor:
    """Terrain height under (x, y): (B,) points against (B,) envs, or (B, k)
    points against the same envs."""
    if isinstance(tp, TerrainRows):
        return _bilinear(tp.grid, tp.offset[0], tp.offset[1], tp.cell, tp.z_scale, x, y)
    per_env = lambda t: t.reshape(t.shape + (1,) * (x.dim() - t.dim()))  # noqa: E731
    if isinstance(tp, TerrainParams):
        return analytic_height(per_env(tp.seed), per_env(tp.z_scale), x, y)
    return _bilinear(grid(x.device), per_env(tp.offset[..., 0]), per_env(tp.offset[..., 1]),
                     per_env(tp.cell), per_env(tp.z_scale), x, y)


def normal(tp: SampledTerrain | TerrainParams, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Unit surface normal (..., 3) from central differences; (0, 0, 1) on
    flat ground."""
    eps = 1e-3
    dhdx = (height(tp, x + eps, y) - height(tp, x - eps, y)) / (2 * eps)
    dhdy = (height(tp, x, y + eps) - height(tp, x, y - eps)) / (2 * eps)
    n = torch.stack([-dhdx, -dhdy, torch.ones_like(x)], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
