"""CNN pose regressor (counterpart of smpl_nerf_tpu/models/smpl_estimator.py).

Image [N, H, W, 3] in [0, 1] -> `human_size` joint angles: five blocks of
conv 3x3 (SAME padding), BatchNorm, ReLU and 2x2 max-pool (16, 32, 64, 128,
128 channels), then FC 500 + ReLU, dropout 0.25, FC human_size. The
convolutions are `torch.nn.Conv2d` (cuDNN on the card, without TF32:
`_platform.set_matmul_precision`); the JAX package runs them as plain XLA too.

Held to flax's numbers: the input is NHWC as flax takes it and is permuted to
NCHW inside; the last block's output is permuted back to NHWC before the
flatten, so `fc1` holds flax's kernel rows in flax's order. `FlaxBatchNorm2d`
normalises with the biased batch variance E[x^2] - E[x]^2 (clipped at 0) in
training, and updates its running statistics as flax does: momentum 0.99 on
the old value, and the biased variance (torch's BatchNorm2d would store the
unbiased one). Layer names conv{i}, bn{i}, fc1, fc2; BatchNorm's scale and
bias are `weight` / `bias`, its statistics `running_mean` / `running_var`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from smpl_nerf_tpu_torch.models.render_ray_net import _linear, init_linear_

WIDTHS = (16, 32, 64, 128, 128)
FC_WIDTH = 500
DROPOUT = 0.25


class FlaxBatchNorm2d(nn.Module):
    """BatchNorm over N, H, W of NCHW input, with flax's statistics."""

    def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean((0, 2, 3))
            var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[None, :, None, None]) * mul[None, :, None, None] \
            + self.bias[None, :, None, None]


class SmplEstimator(nn.Module):
    def __init__(self, human_size: int = 2, image_size=(128, 128), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, w = image_size
        chans = (3,) + WIDTHS
        for i in range(len(WIDTHS)):
            setattr(self, f"conv{i}", nn.utils.skip_init(
                nn.Conv2d, chans[i], chans[i + 1], 3, padding=1,
                device="cpu" if device is None else device))
            setattr(self, f"bn{i}", FlaxBatchNorm2d(chans[i + 1], device=device))
            h, w = h // 2, w // 2
        self.fc1 = _linear(h * w * WIDTHS[-1], FC_WIDTH, device)
        self.dropout = nn.Dropout(DROPOUT)
        self.fc2 = _linear(FC_WIDTH, int(human_size), device)
        for i in range(len(WIDTHS)):
            conv = getattr(self, f"conv{i}")
            init_linear_(conv, generator, conv.weight[0].numel())   # fan-in 3 * 3 * in
        init_linear_(self.fc1, generator)
        init_linear_(self.fc2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, 3] -> [N, human_size] joint angles (radians)."""
        o = x.to(self.fc1.weight.dtype).permute(0, 3, 1, 2)
        for i in range(len(WIDTHS)):
            o = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(o)))
            o = F.max_pool2d(o, 2, 2)
        o = o.permute(0, 2, 3, 1).reshape(o.shape[0], -1)        # flax's NHWC flatten
        o = self.dropout(torch.relu(self.fc1(o)))
        return self.fc2(o)
