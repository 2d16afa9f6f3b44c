"""Alpha-composite volume rendering (counterpart of smpl_nerf_tpu/core/integrate.py).

Keeps the reference's parity-relevant quirks:
  * dists: z-diffs with 1e10 appended, scaled by ||direction|| per sample
    ([R, S, 3] directions) or per ray ([R, 3]),
  * color = sigmoid(raw[..., :3]), alpha = 1 - exp(-relu(sigma) * dist),
  * exclusive cumprod of (1 - alpha + 1e-10) for transmittance,
  * optional gaussian sigma noise (training only, drawn from a generator),
  * white-background compositing rgb += (1 - acc),
  * the single-sample path returns sigmoid(rgb) directly.

`raw2outputs_segmented` is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class RenderOutputs(NamedTuple):
    rgb: torch.Tensor        # [R, 3]
    weights: torch.Tensor    # [R, S]
    density: torch.Tensor    # [R, S] (alpha per sample)
    depth: torch.Tensor      # [R]
    acc: torch.Tensor        # [R]


def raw2outputs(raw: torch.Tensor, z_vals: torch.Tensor, samples_directions: torch.Tensor,
                sigma_noise_std: float = 0.0, white_background: bool = False,
                generator: Optional[torch.Generator] = None) -> RenderOutputs:
    """Integrate raw MLP outputs [R, S, 4] along rays.

    samples_directions: [R, S, 3] or [R, 3]; only the norm is used. Noise is
    added only when a generator is given and sigma_noise_std > 0.
    """
    rgb = torch.sigmoid(raw[..., :3])
    if z_vals.shape[-1] == 1:
        r = rgb.reshape(raw.shape[0], 3)
        ones = torch.ones((raw.shape[0], 1), dtype=raw.dtype, device=raw.device)
        return RenderOutputs(r, ones, ones, z_vals[..., 0], ones[..., 0])

    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    if samples_directions.dim() == z_vals.dim():   # [R, 3] per-ray direction
        dists = dists * torch.linalg.norm(samples_directions, dim=-1, keepdim=True)
    else:                                          # [R, S, 3] per-sample direction
        dists = dists * torch.linalg.norm(samples_directions, dim=-1)

    sigma = raw[..., 3]
    if generator is not None and sigma_noise_std > 0.0:
        noise = torch.randn(sigma.shape, generator=generator, dtype=sigma.dtype,
                            device=generator.device).to(sigma.device)
        sigma = sigma + sigma_noise_std * noise
    density = 1.0 - torch.exp(-torch.relu(sigma) * dists)

    one_minus = 1.0 - density + 1e-10
    exclusive = torch.cat([torch.ones_like(one_minus[..., :1]), one_minus[..., :-1]], -1)
    weights = density * torch.cumprod(exclusive, -1)

    rgb_out = torch.sum(weights[..., None] * rgb, -2)
    depth = torch.sum(weights * z_vals, -1)
    acc = torch.sum(weights, -1)
    if white_background:
        rgb_out = rgb_out + (1.0 - acc[..., None])
    return RenderOutputs(rgb_out, weights, density, depth, acc)
