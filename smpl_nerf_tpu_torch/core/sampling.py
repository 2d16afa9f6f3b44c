"""Ray sampling: coarse disparity-linear bins + inverse-CDF fine sampling.

Counterpart of smpl_nerf_tpu/core/sampling.py, with the reference quirks that
affect PSNR parity:
  * coarse bins are disparity-linear with ONE shared jitter per ray; eval mode
    (no generator) uses jitter 0.5, the bin centres,
  * fine sampling uses DETERMINISTIC u (see `fine_u`), not stratified noise,
  * pdf from weights[..., 1:-1] + 1e-5, cdf prepended with 0, searchsorted
    side='right', denominators < 1e-5 replaced by 1,
  * the fine-sampling inputs are detached, and the concatenated z are sorted.

`sample_pdf` here is the plain PyTorch version of the sample_pdf CUDA kernel
(ops/sample_pdf_cuda.py); `fine_sampling(use_pallas=True)` routes to that
kernel's wrapper, which takes this plain version for CPU tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from smpl_nerf_tpu_torch.core import integrate


def coarse_bins(near: float, far: float, number_samples: int, device=None) -> torch.Tensor:
    """Disparity-linear bin centers [S]."""
    t_vals = torch.linspace(0.0, 1.0, number_samples, device=device)
    return 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)


def coarse_sampling(ray_translation: torch.Tensor, ray_direction: torch.Tensor,
                    near: float, far: float, number_samples: int,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ray_samples [..., S, 3], z_vals [..., S]).

    With a generator, one uniform jitter is drawn PER RAY and shared across
    that ray's bins; without one the jitter is 0.5 (deterministic eval mode).
    """
    device = ray_translation.device
    z = coarse_bins(near, far, number_samples, device)
    mids = 0.5 * (z[1:] + z[:-1])
    upper = torch.cat([mids, z[-1:]], -1)
    lower = torch.cat([z[:1], mids], -1)
    batch_shape = ray_translation.shape[:-1]
    if generator is not None:
        jitter = integrate.draw(torch.rand, batch_shape + (1,), generator).to(device)
    else:
        jitter = torch.full(batch_shape + (1,), 0.5, device=device)
    z_vals = lower + (upper - lower) * jitter
    ray_samples = ray_translation[..., None, :] + ray_direction[..., None, :] * z_vals[..., :, None]
    return ray_samples, z_vals


def fine_u_step(number_fine_samples: int) -> float:
    """The float32 step of u: 1/(F-1) rounded to float32 once."""
    return float(np.float32(1.0) / np.float32(max(number_fine_samples - 1, 1)))


def fine_u(number_fine_samples: int, device=None) -> torch.Tensor:
    """u_f = f * step in float32, f = 0..F-1.

    The CUDA kernel computes the same product per sample (the Pallas kernel's
    `q * (1/(F-1))` form), so kernel and plain version use bit-identical u.
    It can differ from `linspace(0, 1, F)` in the last bit of a few entries.
    """
    step = torch.tensor(fine_u_step(number_fine_samples), dtype=torch.float32, device=device)
    return torch.arange(number_fine_samples, dtype=torch.float32, device=device) * step


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor,
               number_fine_samples: int) -> torch.Tensor:
    """Inverse-CDF sampling of `number_fine_samples` per ray.

    bins: [R, K] bin positions (z midpoints), weights: [R, K-1] -> [R, F].
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)     # [R, K]

    u = fine_u(number_fine_samples, bins.device)
    u = u.expand(cdf.shape[:-1] + (number_fine_samples,)).contiguous()

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, torch.clamp(below, max=bins.shape[-1] - 1))
    bins_above = torch.gather(bins, -1, torch.clamp(above, max=bins.shape[-1] - 1))

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def fine_sampling(ray_translation: torch.Tensor, samples_directions: torch.Tensor,
                  z_vals: torch.Tensor, weights: torch.Tensor,
                  number_fine_samples: int,
                  use_pallas: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge coarse z with inverse-CDF fine z and rebuild the 3D sample points.

    Returns (z_vals [R, Sc+Sf], samples [R, Sc+Sf, 3]). `use_pallas` keeps the
    JAX flag's name: True routes to the sample_pdf CUDA kernel's wrapper.
    """
    z_vals_mid = (0.5 * (z_vals[..., 1:] + z_vals[..., :-1])).detach()
    inner_weights = weights[..., 1:-1].detach()
    if use_pallas:
        from smpl_nerf_tpu_torch.ops.sample_pdf_cuda import sample_pdf_fused
        z_samples = sample_pdf_fused(z_vals_mid.contiguous(), inner_weights.contiguous(),
                                     number_fine_samples)
    else:
        z_samples = sample_pdf(z_vals_mid, inner_weights, number_fine_samples)
    z_samples = z_samples.detach()
    z_all, _ = torch.sort(torch.cat([z_vals, z_samples], -1), -1)
    ray_samples_fine = (ray_translation[..., None, :]
                        + samples_directions[..., None, :] * z_all[..., :, None])
    return z_all, ray_samples_fine
