"""Grid-encoded NeRFs: the multi-resolution dense-grid net (counterpart of
smpl_nerf_tpu/models/grid_nerf.py) and Instant-NGP's hash-grid net (port only).

`GridNerf` (--grid_encoding 1). Dense feature grids `grid_{res}` [res, res,
res, F] (one per level, uniform +-1e-4 at init, float32 parameters under those
names) are read by trilinear interpolation at each sample's position,
normalised from [-bound, bound]^3 to [0, 1]^3. The levels' features, then the
conditioning prefix, feed a small ReLU trunk (`trunk_{i}`, `trunk_out`, no
activation on the last); the sigma head reads the trunk; the rgb branch
(`dir_0` + ReLU, `rgb_out_layer`) reads the trunk with the direction encoding
[sin(2^k d), cos(2^k d)] for k < L, laid out per frequency as sin then cos over
the three coordinates, with no identity block. The net takes raw rows [prefix
|| xyz || unit dir] (`takes_raw`): the net runner hands it positions, not
encodings.

Interpolation runs in float32; the trunk and heads in the compute dtype with
flax's Dense rounding. The gathers' backward accumulates into the grids with
index_add_, whose order on a CUDA card is not fixed: two runs can differ in
the last bits of a grid gradient.

`HashGridNerf` (--grid_encoding 2) is `GridNerf`'s counterpart at Instant-NGP's
published sizes (HashGridSpec, hash_grid_encode, spherical_harmonics_4); its
docstring lists where it departs from the paper.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from smpl_nerf_tpu_torch import tracing
from smpl_nerf_tpu_torch.models.render_ray_net import _linear, dense, init_linear_

# Instant-NGP's NeRF sizes (section 5.4 of the paper), which --grid_encoding 2
# builds: L levels, T = 2^log2_hashmap_size entries a hashed level, N_min, N_max
NGP_SIZES = {"n_levels": 16, "log2_hashmap_size": 19, "base_resolution": 16,
             "max_resolution": 2048}

# hash_grid_encode's calls from HashGridNerf and the table lookups they made
# (rows x levels x 8 corners), counted from the shapes (no device sync)
encode_calls = 0
lookups = 0


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


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """The sizes of a multiresolution hash encoding (Mueller et al., "Instant
    Neural Graphics Primitives with a Multiresolution Hash Encoding", 2022,
    section 3): level l has resolution N_l and `sizes[l]` table entries of
    `features` floats; every level lives in one table [sum(sizes), F] at
    `offsets[l]`. A level is dense (index 1:1) where its (N_l + 1)^3 vertices
    fit its entries, else hashed into `hashmap_size` (T, a power of two)."""
    resolutions: Tuple[int, ...]
    sizes: Tuple[int, ...]
    hashmap_size: int
    features: int
    primes: Tuple[int, int, int] = (1, 2654435761, 805459861)

    @classmethod
    def published(cls, n_levels: int, features: int, log2_hashmap_size: int,
                  base_resolution: int, max_resolution: int) -> "HashGridSpec":
        """N_l = floor(N_min b^l), b = exp((ln N_max - ln N_min) / (L - 1)), in
        float64; a level holds min((N_l + 1)^3, T) entries."""
        T = 2 ** int(log2_hashmap_size)
        b = (math.exp((math.log(max_resolution) - math.log(base_resolution)) / (n_levels - 1))
             if n_levels > 1 else 1.0)
        res = tuple(int(math.floor(base_resolution * b ** level)) for level in range(n_levels))
        return cls(res, tuple(min((n + 1) ** 3, T) for n in res), T, int(features))

    @property
    def dense(self) -> Tuple[bool, ...]:
        return tuple((n + 1) ** 3 <= size for n, size in zip(self.resolutions, self.sizes))

    @property
    def offsets(self) -> Tuple[int, ...]:
        return tuple(sum(self.sizes[:level]) for level in range(len(self.sizes)))

    @property
    def entries(self) -> int:
        return sum(self.sizes)


@functools.lru_cache(maxsize=None)
def _level_constants(spec: HashGridSpec, device: torch.device):
    """Per-level constants on `device`, made once (a copy per call would block
    the host until the device drains): resolutions (float32), the dense
    strides [L, 3], the primes [3], which levels are dense, the offsets."""
    res = torch.tensor(spec.resolutions, dtype=torch.float32)
    n1 = torch.tensor(spec.resolutions, dtype=torch.int64) + 1
    out = (res, torch.stack([torch.ones_like(n1), n1, n1 * n1], -1),
           torch.tensor(spec.primes, dtype=torch.int64), torch.tensor(spec.dense),
           torch.tensor(spec.offsets, dtype=torch.int64))
    return tuple(t.to(device) for t in out)


def hash_grid_encode(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """[N, 3] positions in [0, 1]^3 (clamped there) -> [N, L*F] float32 features,
    level by level, of the table [spec.entries, F].

    At level l the point x N_l lies in the cell whose lower corner is
    floor(x N_l), capped at N_l - 1 so that the far face blends onto its own
    vertices; its 8 corners c = lower + {0, 1}^3 (x the slowest bit) index a
    dense level as c0 + c1 (N_l + 1) + c2 (N_l + 1)^2 and a hashed one as
    (c0 pi0 xor c1 pi1 xor c2 pi2) mod T. The products and the xor run in int64:
    T is a power of two, so the low bits are those of uint32 arithmetic. The
    corners are blended by trilinear weights (wx wy) wz in float32. Every level
    and corner in one gather (`index_select`, whose backward is index_add_).

    The benchmark and the tests plant faults by replacing this module global:
    HashGridNerf calls it by name.
    """
    res, strides, primes, dense_levels, offsets = _level_constants(spec, x.device)
    n = x.shape[0]
    pos = x.float().clamp(0.0, 1.0)[:, None, :] * res[:, None]                # [N, L, 3]
    lower = torch.minimum(torch.floor(pos), (res - 1.0)[:, None])
    frac = pos - lower
    c = lower.long()
    corners = torch.stack([c, c + 1], -1)                                     # [N, L, 3, 2]

    def combine(terms, op):        # [N, L, 3, 2] -> [N, L, 2, 2, 2] over the 8 corners
        return op(op(terms[:, :, 0, :, None, None], terms[:, :, 1, None, :, None]),
                  terms[:, :, 2, None, None, :])

    dense_index = combine(corners * strides[:, :, None], torch.add)
    hashed = combine(corners * primes[:, None], torch.bitwise_xor) & (spec.hashmap_size - 1)
    index = torch.where(dense_levels[:, None, None, None], dense_index, hashed)
    index = index + offsets[:, None, None, None]
    w1 = torch.stack([1.0 - frac, frac], -1)
    weights = combine(w1, torch.mul).reshape(n, -1, 8, 1)
    feats = table.index_select(0, index.reshape(-1)).view(n, -1, 8, table.shape[-1])
    return (weights * feats).sum(2).reshape(n, -1)


def spherical_harmonics_4(d: torch.Tensor) -> torch.Tensor:
    """[N, 3] unit directions -> [N, 16]: the real spherical harmonics of bands
    0-3 (tiny-cuda-nn's SphericalHarmonics encoding of degree 4), float32."""
    x, y, z = d.float().unbind(-1)
    xy, xz, yz, x2, y2, z2 = x * y, x * z, y * z, x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x,
        1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999, -1.0925484305920792 * xz,
        0.54627421529603959 * x2 - 0.54627421529603959 * y2,
        0.59004358992664352 * y * (-3.0 * x2 + y2), 2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2), 0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2), 1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2)], -1)


def _bias_free(in_dim: int, out_dim: int, device) -> nn.Linear:
    return nn.utils.skip_init(nn.Linear, in_dim, out_dim, bias=False,
                              device="cpu" if device is None else device)


def _product(layer: nn.Linear, h: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """h @ W^T with flax's rounding of a bias-free Dense at `compute_dtype`."""
    if compute_dtype == torch.float32:
        return F.linear(h, layer.weight)
    return torch.matmul(h.to(compute_dtype), layer.weight.to(compute_dtype).t())


class HashGridNerf(nn.Module):
    """Instant-NGP's NeRF field (section 5.4 and Table 1 of the paper) on raw rows
    [prefix || xyz || unit dir] (`takes_raw`).

    The position, mapped from [-bound, bound]^3 to [0, 1]^3 as p (0.5 / bound) +
    0.5, is encoded by
    `hash_grid_encode` (the table `hash_table` [spec.entries, F], uniform
    +-1e-4 at init); the prefix, if any, follows the L*F features. The density
    MLP (`density_0` + ReLU, `density_out`: width -> 16) gives h, whose first
    output is log-space density: sigma = exp(h_0), in float32. The colour MLP
    reads [spherical_harmonics_4(dir), h] (`color_0`, `color_1`, each + ReLU,
    `color_out` -> 3); the sigmoid comes in raw2outputs. Output [rgb, sigma].
    The MLPs have no biases, as tiny-cuda-nn's fully fused MLPs; their kernels
    are flax's lecun-normal init. The span `pass.encode` holds the encoding; the
    module counters `encode_calls` and `lookups` count it.

    Departures from the paper: a coarse and a fine field (NGP marches one field
    through an occupancy grid); the MLPs in the compute dtype with flax's Dense
    rounding (bf16 in place of NGP's fp16); samples outside the box clamped to
    its border; raw2outputs' ReLU and sigma noise act on sigma = exp(h_0) (NGP
    takes a truncated exp and no noise); no offset of half a cell, which
    tiny-cuda-nn adds to every level's positions.
    """
    takes_raw = True
    geometry_features = 16

    def __init__(self, spec: HashGridSpec, width: int = 64, additional_input_dim: int = 0,
                 bound: float = 1.6, compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        self.width = int(width)
        self.additional_input_dim = int(additional_input_dim)
        self.bound = float(bound)
        self.compute_dtype = compute_dtype
        table = torch.empty((spec.entries, spec.features), dtype=torch.float32)
        table.uniform_(-1e-4, 1e-4, generator=generator)
        self.hash_table = nn.Parameter(table.to("cpu" if device is None else device))
        encoded = len(spec.resolutions) * spec.features + self.additional_input_dim
        g = self.geometry_features
        self.density_0 = _bias_free(encoded, width, device)
        self.density_out = _bias_free(width, g, device)
        self.color_0 = _bias_free(16 + g, width, device)
        self.color_1 = _bias_free(width, width, device)
        self.color_out = _bias_free(width, 3, device)
        for layer in (self.density_0, self.density_out, self.color_0, self.color_1,
                      self.color_out):
            init_linear_(layer, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        global encode_calls, lookups
        cdt = self.compute_dtype
        add = self.additional_input_dim
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        # [-bound, bound] -> [0, 1] by one product and one sum, which round alike
        # on every device (a division by a scalar is a product by its
        # reciprocal on the card, one ulp off the CPU's quotient: 1.2e-4 of a
        # cell at N = 2048, which moves the tables' gradients by ~1e-3)
        p01 = x[:, add:add + 3] * (0.5 / self.bound) + 0.5
        encode_calls += 1
        lookups += x.shape[0] * len(self.spec.resolutions) * 8
        with tracing.span("pass.encode"):
            feats = hash_grid_encode(p01, self.hash_table, self.spec)
        if add:
            feats = torch.cat([feats, x[:, :add].float()], -1)
        h = torch.relu(_product(self.density_0, feats.to(cdt), cdt))
        h = _product(self.density_out, h, cdt)
        sigma = torch.exp(h[:, :1].float())
        c = torch.cat([spherical_harmonics_4(x[:, add + 3:add + 6]).to(cdt), h], -1)
        c = torch.relu(_product(self.color_0, c, cdt))
        c = torch.relu(_product(self.color_1, c, cdt))
        rgb = _product(self.color_out, c, cdt)
        return torch.cat([rgb.float(), sigma], -1).reshape(*lead, 4)
