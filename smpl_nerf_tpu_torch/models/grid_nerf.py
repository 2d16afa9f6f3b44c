"""Multi-resolution dense-grid NeRF (counterpart of smpl_nerf_tpu/models/grid_nerf.py).

Dense feature grids `grid_{res}` [res, res, res, F] (one per level, uniform
+-1e-4 at init, float32 parameters under those names) are read by trilinear
interpolation at each sample's position, normalised from [-bound, bound]^3 to
[0, 1]^3. The levels' features, then the conditioning prefix, feed a small
ReLU trunk (`trunk_{i}`, `trunk_out`, no activation on the last); the sigma
head reads the trunk; the rgb branch (`dir_0` + ReLU, `rgb_out_layer`) reads
the trunk with the direction encoding [sin(2^k d), cos(2^k d)] for k < L,
laid out per frequency as sin then cos over the three coordinates, with no
identity block. The net takes raw rows [prefix || xyz || unit dir]
(`takes_raw`): the net runner hands it positions, not encodings.

Interpolation runs in float32; the trunk and heads in the compute dtype with
flax's Dense rounding. The gathers' backward accumulates into the grids with
index_add_, whose order on a CUDA card is not fixed: two runs can differ in
the last bits of a grid gradient.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from smpl_nerf_tpu_torch.models.render_ray_net import _linear, dense, init_linear_


def trilinear_interpolate(grid: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """grid [R, R, R, F], p [N, 3] in [0, 1] -> [N, F], blended in JAX's order
    (z, then y, then x)."""
    res = grid.shape[0]
    x = torch.clamp(p, 0.0, 1.0) * (res - 1)
    x0 = torch.floor(x).long()
    x1 = torch.clamp(x0 + 1, max=res - 1)
    f = x - x0
    fx, fy, fz = f[:, 0:1], f[:, 1:2], f[:, 2:3]
    flat = grid.reshape(res ** 3, grid.shape[-1])

    def g(ix, iy, iz):
        return flat.index_select(0, (ix * res + iy) * res + iz)

    c000 = g(x0[:, 0], x0[:, 1], x0[:, 2])
    c001 = g(x0[:, 0], x0[:, 1], x1[:, 2])
    c010 = g(x0[:, 0], x1[:, 1], x0[:, 2])
    c011 = g(x0[:, 0], x1[:, 1], x1[:, 2])
    c100 = g(x1[:, 0], x0[:, 1], x0[:, 2])
    c101 = g(x1[:, 0], x0[:, 1], x1[:, 2])
    c110 = g(x1[:, 0], x1[:, 1], x0[:, 2])
    c111 = g(x1[:, 0], x1[:, 1], x1[:, 2])
    c00 = c000 * (1 - fz) + c001 * fz
    c01 = c010 * (1 - fz) + c011 * fz
    c10 = c100 * (1 - fz) + c101 * fz
    c11 = c110 * (1 - fz) + c111 * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def direction_encoding(dirs: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[N, 3] -> [N, 6 L]: per frequency 2^k, sin of the three coordinates,
    then cos."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=torch.float32, device=dirs.device)
    s = dirs[..., None, :] * freqs[:, None]
    return torch.stack([torch.sin(s), torch.cos(s)], -2).reshape(*dirs.shape[:-1], -1)


class GridNerf(nn.Module):
    takes_raw = True

    def __init__(self, levels: Sequence[int] = (8, 16, 32, 64), features: int = 4,
                 width: int = 64, n_layers: int = 3, dir_freqs: int = 4,
                 additional_input_dim: int = 0, bound: float = 1.6,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.levels = tuple(int(r) for r in levels)
        self.features = int(features)
        self.width = int(width)
        self.n_layers = int(n_layers)
        self.dir_freqs = int(dir_freqs)
        self.additional_input_dim = int(additional_input_dim)
        self.bound = float(bound)
        self.compute_dtype = compute_dtype
        dev = "cpu" if device is None else device
        for res in self.levels:
            grid = torch.empty((res, res, res, self.features), dtype=torch.float32)
            grid.uniform_(-1e-4, 1e-4, generator=generator)
            setattr(self, f"grid_{res}", nn.Parameter(grid.to(dev)))
        in_dim = len(self.levels) * self.features + self.additional_input_dim
        for i in range(self.n_layers - 1):
            setattr(self, f"trunk_{i}", _linear(in_dim if i == 0 else width, width, device))
        self.trunk_out = _linear(in_dim if self.n_layers == 1 else width, width, device)
        self.sigma_out_layer = _linear(width, 1, device)
        self.dir_0 = _linear(width + 6 * self.dir_freqs, width // 2, device)
        self.rgb_out_layer = _linear(width // 2, 3, device)
        for layer in self.modules():
            if isinstance(layer, nn.Linear):
                init_linear_(layer, generator)

    def grids(self):
        return [getattr(self, f"grid_{res}") for res in self.levels]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        add = self.additional_input_dim
        pos = x[..., add:add + 3]
        dirs = x[..., add + 3:add + 6]
        p01 = (pos / self.bound + 1.0) * 0.5          # [-bound, bound] -> [0, 1]
        feats = [trilinear_interpolate(grid, p01) for grid in self.grids()]
        if add:
            feats.append(x[..., :add])                # the prefix comes after the grids
        h = torch.cat(feats, -1).to(cdt)
        for i in range(self.n_layers - 1):
            h = torch.relu(dense(getattr(self, f"trunk_{i}"), h, cdt))
        h = dense(self.trunk_out, h, cdt)
        sigma = dense(self.sigma_out_layer, h, cdt)
        h = torch.cat([h, direction_encoding(dirs, self.dir_freqs).to(cdt)], -1)
        h = torch.relu(dense(self.dir_0, h, cdt))
        rgb = dense(self.rgb_out_layer, h, cdt)
        return torch.cat([rgb, sigma], -1).float()
