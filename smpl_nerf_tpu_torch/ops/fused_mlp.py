"""RenderRayNet as one flat parameter list (counterpart of smpl_nerf_tpu/ops/fused_mlp.py).

`MlpSpec` is the static topology of a RenderRayNet; `flatten_params` turns a
net into (kernel [in, out], bias) pairs in `_param_order`, the layout both
fused forwards read. `reference_forward` is the plain PyTorch version of the
v1 kernel (pre-encoded rows [prefix || pos_enc || dir_enc] -> [N, 4]).

The v1 kernel itself (`fused_mlp._pallas_forward`, for nets with a
conditioning prefix) is not ported yet: on CUDA, --use_fused_mlp=1 raises.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class MlpSpec:
    """Static topology of a RenderRayNet."""
    n_layers: int = 8
    width: int = 256
    positions_dim: int = 60
    directions_dim: int = 24
    additional_input_dim: int = 0
    skips: Tuple[int, ...] = (4,)
    use_directional_input: bool = True
    dtype: str = "bfloat16"   # compute precision

    @property
    def pos_block(self) -> int:
        return self.positions_dim + self.additional_input_dim

    @property
    def in_dim(self) -> int:
        return self.pos_block + self.directions_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def _param_order(spec: MlpSpec) -> Sequence[str]:
    names = ["positions_pose_input"]
    names += [f"positional_net_{i}" for i in range(spec.n_layers - 1)]
    names += ["additional_linear_layer", "sigma_out_layer", "directional_input",
              "directional_net_0", "rgb_out_layer"]
    return names


def _module_layer(net: torch.nn.Module, name: str) -> torch.nn.Linear:
    if name.startswith("positional_net_"):
        return net.positional_net[int(name[len("positional_net_"):])]
    if name == "directional_net_0":
        return net.directional_net[0]
    return getattr(net, name)


def flatten_params(spec: MlpSpec, net: torch.nn.Module) -> Tuple[torch.Tensor, ...]:
    """RenderRayNet -> flat (kernel [in, out], bias) * layers, in _param_order."""
    flat = []
    for name in _param_order(spec):
        layer = _module_layer(net, name)
        flat.append(layer.weight.t())
        flat.append(layer.bias)
    return tuple(flat)


def dense_f32(layers, name: str, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """h @ kernel in `dtype` operands with float32 accumulation, + f32 bias.

    Products of bf16 values are exact in float32, so an f32 product of the
    bf16-rounded operands is the `preferred_element_type=float32` dot.
    """
    k, b = layers[name]
    return torch.matmul(h.float(), k.to(dtype).float()) + b.float()


def trunk_forward(spec: MlpSpec, flat, pos: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """The RenderRayNet body on encoded inputs, rounding to spec.dtype after
    each ReLU, after additional_linear_layer and after directional_input."""
    cdt = spec.torch_dtype
    it = iter(flat)
    layers = {name: (next(it), next(it)) for name in _param_order(spec)}

    def dense(name, h):
        return dense_f32(layers, name, h, cdt)

    o = torch.relu(dense("positions_pose_input", pos)).to(cdt)
    for i in range(spec.n_layers - 1):
        if i in spec.skips:
            o = torch.cat([o, pos], -1)
        o = torch.relu(dense(f"positional_net_{i}", o)).to(cdt)
    o = dense("additional_linear_layer", o).to(cdt)
    sigma = dense("sigma_out_layer", o)
    if spec.use_directional_input:
        o = torch.cat([o, dirs], -1)
    o = dense("directional_input", o).to(cdt)
    o = torch.relu(dense("directional_net_0", o)).to(cdt)
    rgb = dense("rgb_out_layer", o)
    return torch.cat([rgb, sigma], -1).float()


def reference_forward(spec: MlpSpec, flat, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the v1 fused forward: pre-encoded rows [N, in_dim] -> [N, 4]."""
    cdt = spec.torch_dtype
    pos = x[..., :spec.pos_block].to(cdt)
    dirs = x[..., spec.in_dim - spec.directions_dim:].to(cdt)
    return trunk_forward(spec, flat, pos, dirs)


def spec_from_model(model) -> MlpSpec:
    """MlpSpec of a models.RenderRayNet."""
    dtype = {v: k for k, v in _DTYPES.items()}[model.compute_dtype]
    return MlpSpec(
        n_layers=model.n_layers, width=model.width,
        positions_dim=model.positions_dim, directions_dim=model.directions_dim,
        additional_input_dim=model.additional_input_dim,
        skips=tuple(model.skips),
        use_directional_input=bool(model.use_directional_input),
        dtype=dtype)
