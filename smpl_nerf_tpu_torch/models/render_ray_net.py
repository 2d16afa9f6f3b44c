"""The NeRF MLP and its SIREN variant (counterpart of
smpl_nerf_tpu/models/render_ray_net.py: RenderRayNet, SirenRenderRayNet).

Layer names follow the reference torch module, so a reference-layout
state_dict (`model_coarse.pt`) loads with `load_state_dict` unchanged:

  input [positions(+additional) || directions]
  -> Linear(pos+add -> W) + ReLU                        (positions_pose_input)
  -> (n_layers-1) x Linear(W -> W) + ReLU, with skip-concat of the raw
     positions(+additional) input before layer i for i in `skips`
                                                        (positional_net.{i})
  -> Linear(W -> W), NO activation                      (additional_linear_layer)
  -> sigma head Linear(W -> 1)                          (sigma_out_layer)
  -> Linear(W + dir -> W/2), NO activation              (directional_input)
  -> Linear(W/2 -> W/2) + ReLU                          (directional_net.0)
  -> rgb head Linear(W/2 -> 3)                          (rgb_out_layer)
  output [rgb, sigma] raw (activations live in core.integrate.raw2outputs).

`compute_dtype=torch.bfloat16` rounds where flax `nn.Dense(dtype=bfloat16)`
does: inputs and weights to bf16, the product rounded to bf16, then the bf16
bias added in bf16. Parameters stay float32.

`SirenRenderRayNet` has the same layers and names; its trunk
(positions_pose_input, positional_net.{i}) and directional_net.0 apply
sin(omega_0 * x) where RenderRayNet applies ReLU, and its skips default to
none. Its init is SIREN's (uniform +-1/fan_in on the first layer, +-sqrt(6 /
fan_in) / omega_0 on the other sine layers and additional_linear_layer, zero
biases); the heads (sigma_out_layer, directional_input, rgb_out_layer) keep
the lecun-normal init. In bf16 the sine is taken of the layer's bf16 output
and rounded to bf16, so the two packages can part by one bf16 rounding of
sin(30 x) per activation.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class Dense(nn.Linear):
    """nn.Linear whose product rounds as flax's Dense does (`dense`).

    `full_weight` / `full_bias` are the whole [out, in] weight and bias that
    the fused kernels take. parallel/tp.py splits a trunk layer by swapping
    in a subclass that overrides the three."""

    def dense(self, h: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
        if compute_dtype == torch.float32:
            return F.linear(h, self.weight, self.bias)
        y = torch.matmul(h.to(compute_dtype), self.weight.to(compute_dtype).t())
        return y + self.bias.to(compute_dtype)

    def full_weight(self) -> torch.Tensor:
        return self.weight

    def full_bias(self) -> torch.Tensor:
        return self.bias


def _linear(in_dim: int, out_dim: int, device) -> Dense:
    # no torch-default init here: reset_parameters draws from a generator
    return nn.utils.skip_init(Dense, in_dim, out_dim,
                              device="cpu" if device is None else device)


def init_linear_(layer: nn.Module, generator: Optional[torch.Generator],
                 fan_in: Optional[int] = None) -> None:
    """Flax's Dense init: lecun-normal kernel, zero bias (if it has one). As flax's
    `variance_scaling(1, "fan_in", "truncated_normal")`: a standard normal
    truncated to [-2, 2] (its std is 0.8796...), scaled to std sqrt(1 /
    fan_in). `fan_in` defaults to a Linear's (the weight's second
    dimension); a convolution passes its own.

    The truncated draw is an inverse-CDF draw on the CPU (a seed gives the
    same weights on every device): u uniform in (Phi(-2), Phi(2)), then
    Phi^-1(u) = sqrt(2) erfinv(2u - 1).
    """
    fan_in = layer.weight.shape[1] if fan_in is None else fan_in
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    w = torch.empty(layer.weight.shape, dtype=torch.float32)
    lo = math.erf(-2.0 / math.sqrt(2.0))                 # 2 Phi(-2) - 1
    w.uniform_(lo, -lo, generator=generator).erfinv_().mul_(math.sqrt(2.0))
    w.clamp_(-2.0, 2.0).mul_(std)
    with torch.no_grad():
        layer.weight.copy_(w)
        if layer.bias is not None:
            layer.bias.zero_()


def init_uniform_(layer: nn.Linear, bound: float,
                  generator: Optional[torch.Generator]) -> None:
    """Kernel uniform in [-bound, bound], zero bias (drawn on the CPU)."""
    w = torch.empty(layer.weight.shape, dtype=torch.float32)
    w.uniform_(-bound, bound, generator=generator)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.zero_()


def dense(layer: Dense, h: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Linear with flax Dense rounding at `compute_dtype` (`Dense.dense`)."""
    return layer.dense(h, compute_dtype)


class RenderRayNet(nn.Module):
    def __init__(self, n_layers: int = 8, width: int = 256, positions_dim: int = 60,
                 directions_dim: int = 24, additional_input_dim: int = 0,
                 skips: Sequence[int] = (4,), use_directional_input: bool = True,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_layers = int(n_layers)
        self.width = int(width)
        self.positions_dim = int(positions_dim)
        self.directions_dim = int(directions_dim)
        self.additional_input_dim = int(additional_input_dim)
        self.skips = tuple(int(s) for s in skips)
        self.use_directional_input = bool(use_directional_input)
        self.compute_dtype = compute_dtype

        pos_dim = self.positions_dim + self.additional_input_dim
        self.positions_pose_input = _linear(pos_dim, width, device)
        self.positional_net = nn.ModuleList([
            _linear(width + (pos_dim if i in self.skips else 0), width, device)
            for i in range(self.n_layers - 1)])
        self.additional_linear_layer = _linear(width, width, device)
        self.sigma_out_layer = _linear(width, 1, device)
        dw = width // 2
        self.directional_input = _linear(
            width + (self.directions_dim if self.use_directional_input else 0), dw, device)
        self.directional_net = nn.ModuleList([_linear(dw, dw, device)])
        self.rgb_out_layer = _linear(dw, 3, device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in self.modules():
            if isinstance(layer, nn.Linear):
                init_linear_(layer, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        pos_dim = self.positions_dim + self.additional_input_dim
        positions_pose = x[..., :pos_dim].to(cdt)
        directions = x[..., x.shape[-1] - self.directions_dim:].to(cdt)

        act = self.activation
        o = act(dense(self.positions_pose_input, positions_pose, cdt))
        for i, layer in enumerate(self.positional_net):
            if i in self.skips:
                o = torch.cat([o, positions_pose], -1)
            o = act(dense(layer, o, cdt))
        o = dense(self.additional_linear_layer, o, cdt)
        sigma = dense(self.sigma_out_layer, o, cdt)
        if self.use_directional_input:
            o = torch.cat([o, directions], -1)
        o = dense(self.directional_input, o, cdt)
        o = act(dense(self.directional_net[0], o, cdt))
        rgb = dense(self.rgb_out_layer, o, cdt)
        return torch.cat([rgb, sigma], -1).float()

    def activation(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x)


class SirenRenderRayNet(RenderRayNet):
    """RenderRayNet with sine activations and the SIREN init. The fused
    kernels compute ReLU, so the net runner sends it through its plain
    forward only."""

    def __init__(self, n_layers: int = 8, width: int = 256, positions_dim: int = 60,
                 directions_dim: int = 24, additional_input_dim: int = 0,
                 skips: Sequence[int] = (), use_directional_input: bool = True,
                 omega_0: float = 30.0, compute_dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        self.omega_0 = float(omega_0)
        super().__init__(n_layers, width, positions_dim, directions_dim,
                         additional_input_dim, skips, use_directional_input, compute_dtype,
                         device, generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        super().reset_parameters(generator)
        # torch's weight is [out, in]: fan_in is its second dimension
        first = self.positions_pose_input
        init_uniform_(first, 1.0 / first.weight.shape[1], generator)
        for layer in (*self.positional_net, self.additional_linear_layer,
                      self.directional_net[0]):
            init_uniform_(layer, (6.0 / layer.weight.shape[1]) ** 0.5 / self.omega_0,
                          generator)

    def activation(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sin(self.omega_0 * x)
