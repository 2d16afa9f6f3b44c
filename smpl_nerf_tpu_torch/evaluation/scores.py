"""Image quality scores (counterpart of smpl_nerf_tpu/evaluation/scores.py):
MSE, PSNR, the from-scratch SSIM (11x11 gaussian window of sigma 1.5, VALID
padding, one convolution per channel, k1 = 0.01, k2 = 0.03), and the LPIPS
distance on VGG16 features: `rlpips` on a fixed-seed untrained VGG16 (its
weights drawn by numpy exactly as the JAX package draws them, so both
packages score with the same net) and `lpips` with the licensed weights of a
local `lpips_vgg16.npz` (None without it; nothing is downloaded).

SSIM's variance terms are differences E[x^2] - mu^2 that cancel
catastrophically in reduced precision (SSIM windows above 1 on near-constant
backgrounds), so `ssim` computes in float32 and forbids TF32 in its
convolutions, whatever the process-wide setting is; the VGG16 convolutions
forbid it too, as the JAX package runs them at Precision.HIGHEST.
"""
from __future__ import annotations

import functools
import math
import os
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F


def _tensor(x, device=None) -> torch.Tensor:
    """float32 tensor of an array. Arrays are copied: a numpy view with a
    negative stride (a channel flip `[..., ::-1]`) is no tensor's storage."""
    return torch.as_tensor(np.array(x, dtype=np.float32) if not isinstance(x, torch.Tensor)
                           else x, dtype=torch.float32, device=device)


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


# ---------------------------------------------------------------- LPIPS

_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512]
# conv indices after whose relu LPIPS taps features (relu1_2, relu2_2,
# relu3_3, relu4_3, relu5_3; reference scores.py:183-201)
_TAP_LAYERS = {1, 3, 6, 9, 12}
_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
_DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__), "lpips_vgg16.npz")


class Vgg16Features:
    """VGG16 convolutional features, weights in the JAX package's layout.

    Keys: conv{i}_kernel [kh, kw, in, out] and conv{i}_bias, optionally
    lin{j}_weight [C] for the LPIPS linear heads (uniform weights otherwise).
    """

    def __init__(self, weights: Mapping[str, object]):
        self.weights = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in weights.items()}
        self.has_lin = any(k.startswith("lin") for k in weights)

    @classmethod
    def load(cls, path: str = _DEFAULT_WEIGHTS) -> Optional["Vgg16Features"]:
        """The net of a local npz file, or None when there is none."""
        if not os.path.exists(path):
            return None
        with np.load(path) as data:
            return cls({k: data[k] for k in data.files})

    @classmethod
    def random(cls, seed: int = 0) -> "Vgg16Features":
        """The fixed-seed He-initialised (untrained) VGG16 of rLPIPS: the same
        numpy draws, in the same order, as the JAX package's
        `Vgg16Features.random`. Its values rank methods on the same data and
        are not comparable with published LPIPS numbers."""
        rng = np.random.default_rng(seed)
        weights = {}
        cin, conv_i = 3, 0
        for v in _VGG16_CFG:
            if v == "M":
                continue
            std = np.sqrt(2.0 / (3 * 3 * cin))
            weights[f"conv{conv_i}_kernel"] = rng.normal(0.0, std, (3, 3, cin, v)).astype(
                np.float32)
            weights[f"conv{conv_i}_bias"] = np.zeros((v,), np.float32)
            cin, conv_i = v, conv_i + 1
        return cls(weights)

    def to(self, device) -> "Vgg16Features":
        """The same net with its tensors on `device`."""
        return Vgg16Features({k: v.to(device) for k, v in self.weights.items()})

    def features(self, img: torch.Tensor):
        """img [N, H, W, 3] in [0, 1] -> the tapped features, each [N, C, h, w].

        NCHW convolutions with SAME padding (1) and 2x2 VALID max pools; cuDNN
        runs them in full float32 (`enabled=True` because `cudnn.flags`
        otherwise turns cuDNN off)."""
        mean = torch.as_tensor(_IMAGENET_MEAN, device=img.device)
        std = torch.as_tensor(_IMAGENET_STD, device=img.device)
        x = ((img - mean) / std).permute(0, 3, 1, 2)
        taps = []
        conv_i = 0
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            for v in _VGG16_CFG:
                if v == "M":
                    x = F.max_pool2d(x, 2)
                    continue
                kernel = self.weights[f"conv{conv_i}_kernel"].permute(3, 2, 0, 1)
                x = torch.relu(F.conv2d(x, kernel, self.weights[f"conv{conv_i}_bias"],
                                        padding=1))
                if conv_i in _TAP_LAYERS:
                    taps.append(x)
                conv_i += 1
        return taps


@torch.no_grad()
def _lpips_from_net(net: Vgg16Features, x, y, batch: int = 8, device=None) -> float:
    x, y = _tensor(x, device), _tensor(y, device)
    if x.dim() == 3:
        x, y = x[None], y[None]
    net = net.to(x.device)
    total, count = 0.0, 0
    for s in range(0, x.shape[0], batch):    # chunks: a tap holds N*H*W*64 floats
        fx, fy = net.features(x[s:s + batch]), net.features(y[s:s + batch])
        per = 0.0
        for j, (a, b) in enumerate(zip(fx, fy)):
            a = a / torch.clamp(torch.linalg.norm(a, dim=1, keepdim=True), min=1e-10)
            b = b / torch.clamp(torch.linalg.norm(b, dim=1, keepdim=True), min=1e-10)
            d = (a - b) ** 2
            lin = net.weights.get(f"lin{j}_weight") if net.has_lin else None
            if lin is not None:
                per = per + torch.mean(torch.sum(d * lin[None, :, None, None], 1))
            else:
                per = per + torch.mean(torch.sum(d, 1) / d.shape[1])
        m = int(x[s:s + batch].shape[0])
        total += float(per) * m
        count += m
    return total / max(count, 1)


def lpips(x, y, weights_path: str = _DEFAULT_WEIGHTS, device=None) -> Optional[float]:
    """LPIPS distance between [N, H, W, 3] image batches in [0, 1]; None
    without the weights file."""
    net = Vgg16Features.load(weights_path)
    if net is None:
        return None
    return _lpips_from_net(net, x, y, device=device)


@functools.lru_cache(maxsize=1)
def _random_net(seed: int) -> Vgg16Features:
    return Vgg16Features.random(seed)


def rlpips(x, y, seed: int = 0, device=None) -> float:
    """LPIPS on the fixed-seed UNTRAINED VGG16 (see Vgg16Features.random):
    deterministic and self-contained, for ranking methods on the same data."""
    return _lpips_from_net(_random_net(seed), x, y, device=device)


def print_scores(renders, truths, device=None) -> dict:
    """MSE / PSNR / SSIM / rLPIPS / LPIPS over [N, H, W, 3] batches, printed
    and returned, as the JAX package's `print_scores`: rlpips for images of at
    least 32 px a side (the four max pools need that much) unless
    SMPL_NERF_TPU_NO_RLPIPS is set, lpips when the weights file exists; a
    column that is absent for another reason than the variable says why."""
    out = {"mse": float(img2mse(renders, truths)),
           "psnr": float(img2psnr(renders, truths)),
           "ssim": float(ssim(renders, truths, device=device))}
    shape = np.shape(renders)
    hw = shape[-3:-1] if len(shape) >= 3 else (0, 0)
    if min(hw) >= 32 and not os.environ.get("SMPL_NERF_TPU_NO_RLPIPS"):
        out["rlpips"] = rlpips(renders, truths, device=device)
    elif min(hw) < 32:
        print(f"rlpips skipped: images are {hw[0]}x{hw[1]} but the 4-maxpool "
              "VGG stack needs >= 32px per side")
    lp = lpips(renders, truths, device=device)
    if lp is not None:
        out["lpips"] = lp
    else:
        print("LPIPS skipped: no local VGG16 weights "
              f"(expected at {_DEFAULT_WEIGHTS}); rlpips (untrained-VGG, "
              "ranking-only) reported instead where present")
    print(" ".join(f"{k}: {v:.4f}" if abs(v) >= 1e-3 else f"{k}: {v:.3e}"
                   for k, v in out.items()))
    return out
