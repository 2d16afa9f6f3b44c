"""Occupancy grid over the scene volume: ray culling without MLP evaluation
(counterpart of smpl_nerf_tpu/ops/occupancy.py).

The density field is baked once into a dense G^3 voxel grid (G^3 coarse-net
evaluations, about a quarter of one 128x128 coarse pass at G=64), dilated so
that a probe next to an occupied voxel cannot read zero, and a ray's cull
score becomes the largest grid value among a few probes along it instead of
64 samples through the coarse net. Plain tensor operations: no kernel.

A dense float32 grid is 1 MB at G=64; lookups are gathers from it.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

Aabb = Tuple[Tuple[float, float, float], Tuple[float, float, float]]

# covers the subject region of the reference scenes: cameras orbit at radius
# ~2.4 looking at a human centred near the origin
DEFAULT_AABB: Aabb = ((-2.0, -2.0, -2.0), (2.0, 2.0, 2.0))

# a ray whose largest grid density exceeds this counts as foreground: used for
# cull-budget sizing and saturation detection (a model trained on a white
# background carries about zero density in empty space)
OCC_THRESHOLD = 1e-2


def voxel_size(aabb: Aabb, resolution: int) -> float:
    """Smallest per-axis voxel edge length of the grid over `aabb`."""
    lo = np.asarray(aabb[0], np.float64)
    hi = np.asarray(aabb[1], np.float64)
    return float(np.min((hi - lo) / resolution))


def required_probes(aabb: Aabb, resolution: int, near: float, far: float) -> int:
    """Smallest probe count whose spacing is at most the voxel size, so that
    consecutive probes cannot step over an occupied (dilated) voxel."""
    return max(2, int(np.ceil((far - near) / voxel_size(aabb, resolution))) + 1)


def _bounds(aabb: Aabb, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.tensor(aabb[0], dtype=torch.float32, device=device),
            torch.tensor(aabb[1], dtype=torch.float32, device=device))


def lattice(aabb: Aabb, resolution: int, device=None) -> torch.Tensor:
    """Voxel-centre coordinates [G, G, G, 3] of the grid over `aabb`."""
    lo, hi = _bounds(aabb, device)
    steps = torch.arange(resolution, device=device) + 0.5
    centers = [steps / resolution * (hi[i] - lo[i]) + lo[i] for i in range(3)]
    return torch.stack(torch.meshgrid(*centers, indexing="ij"), -1)


def build_density_grid(density_fn: Callable[[torch.Tensor], torch.Tensor], aabb: Aabb,
                       resolution: int, dilate_voxels: int = 2, device=None) -> torch.Tensor:
    """Bake `density_fn(points [N, 3]) -> sigma [N]` into a [G, G, G] grid,
    max-dilated `dilate_voxels` times so that the culling stays conservative."""
    pts = lattice(aabb, resolution, device).reshape(-1, 3)
    grid = density_fn(pts).reshape(resolution, resolution, resolution)
    grid = torch.clamp(grid, min=0.0)
    for _ in range(dilate_voxels):
        grid = _dilate_max(grid)
    return grid


def _dilate_max(grid: torch.Tensor) -> torch.Tensor:
    """3x3x3 max-pool with edge padding (stride 1), separable per axis."""
    for axis in range(3):
        n = grid.shape[axis]
        p = torch.cat([grid.narrow(axis, 0, 1), grid, grid.narrow(axis, n - 1, 1)], axis)
        grid = torch.maximum(p.narrow(axis, 0, n),
                             torch.maximum(p.narrow(axis, 1, n), p.narrow(axis, 2, n)))
    return grid


def trilinear(grid: torch.Tensor, aabb: Aabb, points: torch.Tensor) -> torch.Tensor:
    """Trilinear grid lookup at `points` [..., 3]; zero outside the aabb."""
    G = grid.shape[0]
    lo, hi = _bounds(aabb, points.device)
    inside = ((points >= lo) & (points <= hi)).all(-1)
    # continuous voxel coordinates: voxel centres sit at u = i + 0.5
    u = torch.clamp((points - lo) / (hi - lo) * G - 0.5, 0.0, G - 1.0)
    i0 = torch.clamp(torch.floor(u).long(), max=G - 2)
    f = u - i0
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]

    def g(dx, dy, dz):
        return grid[x0 + dx, y0 + dy, z0 + dz]

    c00 = g(0, 0, 0) * (1 - fx) + g(1, 0, 0) * fx
    c10 = g(0, 1, 0) * (1 - fx) + g(1, 1, 0) * fx
    c01 = g(0, 0, 1) * (1 - fx) + g(1, 0, 1) * fx
    c11 = g(0, 1, 1) * (1 - fx) + g(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    val = c0 * (1 - fz) + c1 * fz
    return torch.where(inside, val, torch.zeros_like(val))


def nearest(grid: torch.Tensor, aabb: Aabb, points: torch.Tensor) -> torch.Tensor:
    """Nearest-voxel grid lookup at `points` [..., 3]; zero outside the aabb.
    One gather per point; with two dilation voxels it stays conservative."""
    G = grid.shape[0]
    lo, hi = _bounds(aabb, points.device)
    inside = ((points >= lo) & (points <= hi)).all(-1)
    i = torch.clamp(((points - lo) / (hi - lo) * G).to(torch.int32), 0, G - 1).long()
    flat = (i[..., 0] * G + i[..., 1]) * G + i[..., 2]
    val = grid.reshape(-1)[flat]
    return torch.where(inside, val, torch.zeros_like(val))


def probe_distances(near: float, far: float, n_probe: int, device=None) -> torch.Tensor:
    """[n_probe] float32 distances, bit for bit what `jnp.linspace(near, far,
    n_probe)` gives inside the JAX package's jitted renderer: near * (1 - i*r)
    + i * (far*r) with r = 1/(n-1) rounded to float32 (XLA turns the division
    into that reciprocal and folds far*r), then `far` itself. `torch.linspace`
    fills its second half backwards from `far`; either order can put a probe
    one ulp across a voxel face from where the JAX package puts it, and with
    the spacing equal to the voxel size probes sit on the faces."""
    f32 = np.float32
    if n_probe == 1:
        return torch.tensor([near], dtype=torch.float32, device=device)
    i = np.arange(n_probe - 1, dtype=f32)
    r = f32(1) / f32(n_probe - 1)
    t = f32(near) * (f32(1) - i * r) + i * (f32(far) * r)
    return torch.from_numpy(np.append(t, f32(far))).to(device)


def ray_scores(grid: torch.Tensor, aabb: Aabb, origins: torch.Tensor, dirs: torch.Tensor,
               near: float, far: float, n_probe: Optional[int] = None,
               method: str = "nearest") -> torch.Tensor:
    """Largest grid occupancy along each ray [R], from `n_probe` probes.

    The probe spacing (far - near) / (n_probe - 1) must not exceed the voxel
    size, or a ray can step over an occupied voxel unseen. n_probe=None
    derives the smallest safe count (`required_probes`); an explicit count
    that breaks the bound raises.
    """
    if n_probe is None:
        n_probe = required_probes(aabb, grid.shape[0], near, far)
    else:
        spacing = (far - near) / max(n_probe - 1, 1)
        vox = voxel_size(aabb, grid.shape[0])
        if spacing > vox * (1 + 1e-6):
            raise ValueError(
                f"ray_scores: probe spacing {spacing:.4g} exceeds voxel size {vox:.4g} "
                f"(near={near}, far={far}, n_probe={n_probe}, G={grid.shape[0]}): culling "
                f"would not be conservative; use n_probe>="
                f"{required_probes(aabb, grid.shape[0], near, far)} or n_probe=None to "
                "derive it")
    t = probe_distances(near, far, n_probe, origins.device)
    pts = origins[:, None, :] + dirs[:, None, :] * t[None, :, None]
    lookup = nearest if method == "nearest" else trilinear
    return lookup(grid, aabb, pts).amax(-1)
