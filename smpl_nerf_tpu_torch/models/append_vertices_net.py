"""RenderRayNet with an SMPL-vertex embedding sub-network (counterpart of
smpl_nerf_tpu/models/append_vertices_net.py).

Input rows [positions || vertices (flat, V*3) || directions]. The vertices go
through `vertices_net` (Linear + ReLU layers, the last `vertex_embedding_dim`
wide), and the embedding is concatenated with the positions before the trunk
(the reference computed it and dropped it; this is the intended design the
JAX package implements). Trunk and heads as RenderRayNet, with its layer
names. The training factory builds the per-image `VertexEmbedder` form
instead (`training/factory.py`), as the JAX factory does, so only the tests
reach this module.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from smpl_nerf_tpu_torch.models.render_ray_net import _linear, dense, init_linear_


class AppendVerticesNet(nn.Module):
    def __init__(self, n_layers: int = 8, width: int = 256, positions_dim: int = 60,
                 directions_dim: int = 24, vertices_dim: int = 6890 * 3,
                 vertex_embedding_dim: int = 64, vertices_net_depth: int = 2,
                 skips: Sequence[int] = (4,), use_directional_input: bool = True,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.positions_dim = int(positions_dim)
        self.directions_dim = int(directions_dim)
        self.vertices_dim = int(vertices_dim)
        self.skips = tuple(int(s) for s in skips)
        self.use_directional_input = bool(use_directional_input)
        self.compute_dtype = compute_dtype
        widths = [width] * (vertices_net_depth - 1) + [vertex_embedding_dim]
        ins = [self.vertices_dim] + widths[:-1]
        self.vertices_net = nn.ModuleList([_linear(i, o, device) for i, o in zip(ins, widths)])
        trunk_in = self.positions_dim + vertex_embedding_dim
        self.positions_pose_input = _linear(trunk_in, width, device)
        self.positional_net = nn.ModuleList([
            _linear(width + (trunk_in if i in self.skips else 0), width, device)
            for i in range(int(n_layers) - 1)])
        self.additional_linear_layer = _linear(width, width, device)
        self.sigma_out_layer = _linear(width, 1, device)
        dw = width // 2
        self.directional_input = _linear(
            width + (self.directions_dim if self.use_directional_input else 0), dw, device)
        self.directional_net = nn.ModuleList([_linear(dw, dw, device)])
        self.rgb_out_layer = _linear(dw, 3, device)
        for layer in self.modules():
            if isinstance(layer, nn.Linear):
                init_linear_(layer, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        p, v = self.positions_dim, self.vertices_dim
        positions = x[..., :p].to(cdt)
        vertices = x[..., p:p + v].to(cdt)
        directions = x[..., x.shape[-1] - self.directions_dim:].to(cdt)
        for layer in self.vertices_net:
            vertices = torch.relu(dense(layer, vertices, cdt))
        trunk_in = torch.cat([positions, vertices], -1)
        o = torch.relu(dense(self.positions_pose_input, trunk_in, cdt))
        for i, layer in enumerate(self.positional_net):
            if i in self.skips:
                o = torch.cat([o, trunk_in], -1)
            o = torch.relu(dense(layer, o, cdt))
        o = dense(self.additional_linear_layer, o, cdt)
        sigma = dense(self.sigma_out_layer, o, cdt)
        if self.use_directional_input:
            o = torch.cat([o, directions], -1)
        o = dense(self.directional_input, o, cdt)
        o = torch.relu(dense(self.directional_net[0], o, cdt))
        rgb = dense(self.rgb_out_layer, o, cdt)
        return torch.cat([rgb, sigma], -1).float()
