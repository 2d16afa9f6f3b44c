"""Ray-bending warp field MLP (counterpart of smpl_nerf_tpu/models/warp_field_net.py).

Linear(pos_enc+pose_enc -> W) -> ReLU -> Linear(W -> 3): a per-sample 3D warp
conditioned on the encoded sample position and the encoded human pose. Layer
names `linear1` / `linear2` follow the reference torch module.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from smpl_nerf_tpu_torch.models.render_ray_net import _linear, dense, init_linear_


class WarpFieldNet(nn.Module):
    def __init__(self, width: int = 256, positions_dim: int = 60, pose_dim: int = 24,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.width = int(width)
        self.positions_dim = int(positions_dim)
        self.pose_dim = int(pose_dim)
        self.compute_dtype = compute_dtype
        self.linear1 = _linear(self.positions_dim + self.pose_dim, self.width, device)
        self.linear2 = _linear(self.width, 3, device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_linear_(self.linear1, generator)
        init_linear_(self.linear2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        o = torch.relu(dense(self.linear1, x.to(cdt), cdt))
        return dense(self.linear2, o, cdt).float()
