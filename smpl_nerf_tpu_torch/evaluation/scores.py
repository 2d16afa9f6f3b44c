"""Image quality scores (counterpart of smpl_nerf_tpu/evaluation/scores.py):
MSE, PSNR and the from-scratch SSIM (11x11 gaussian window of sigma 1.5, VALID
padding, one convolution per channel, k1 = 0.01, k2 = 0.03).

`rlpips` (the seeded untrained VGG16 distance) and `lpips` (which needs the
licensed VGG16 weights) are not ported yet; `print_scores` says so by name.

SSIM's variance terms are differences E[x^2] - mu^2 that cancel
catastrophically in reduced precision (SSIM windows above 1 on near-constant
backgrounds), so `ssim` computes in float32 and forbids TF32 in its
convolutions, whatever the process-wide setting is.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _tensor(x, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           dtype=torch.float32, device=device)


def img2mse(x, y) -> torch.Tensor:
    return torch.mean((_tensor(x) - _tensor(y)) ** 2)


def img2psnr(x, y) -> torch.Tensor:
    return -10.0 * torch.log(img2mse(x, y)) / math.log(10.0)


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(x, y, kernel_size: int = 11, kernel_sigma: float = 1.5, data_range: float = 1.0,
         k1: float = 0.01, k2: float = 0.03, device=None) -> torch.Tensor:
    """SSIM over [N, H, W, C] (or [H, W, C]) images in [0, data_range]."""
    x, y = _tensor(x, device), _tensor(y, device)
    if x.dim() == 3:
        x, y = x[None], y[None]
    x = (x / data_range).permute(0, 3, 1, 2)          # NCHW for conv2d
    y = (y / data_range).permute(0, 3, 1, 2)
    c = x.shape[1]
    kernel = _gaussian_kernel(kernel_size, kernel_sigma, x.device)[None, None].repeat(c, 1, 1, 1)

    def dconv(img):
        return F.conv2d(img, kernel, groups=c)        # depthwise, VALID

    with torch.backends.cudnn.flags(allow_tf32=False):
        c1, c2 = k1 ** 2, k2 ** 2
        mu1, mu2 = dconv(x), dconv(y)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        sigma1_sq = dconv(x * x) - mu1_sq
        sigma2_sq = dconv(y * y) - mu2_sq
        sigma12 = dconv(x * y) - mu1_mu2
    cs = (2.0 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ss = (2.0 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1) * cs
    return torch.mean(ss)


def print_scores(renders, truths, device=None) -> dict:
    """MSE / PSNR / SSIM over [N,H,W,3] batches, printed and returned."""
    out = {"mse": float(img2mse(renders, truths)),
           "psnr": float(img2psnr(renders, truths)),
           "ssim": float(ssim(renders, truths, device=device))}
    print("rlpips and lpips skipped: not ported yet to smpl_nerf_tpu_torch "
          "(mse, psnr and ssim reported)")
    print(" ".join(f"{k}: {v:.4f}" if abs(v) >= 1e-3 else f"{k}: {v:.3e}"
                   for k, v in out.items()))
    return out
