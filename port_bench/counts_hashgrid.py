"""Operations of a smpl_nerf step on hash-grid fields (frozen yardstick): what
`train.hashgrid.mfu_pct` divides by the card's peak.

`flags` are the configuration's flags with its `hash_grid` group under that
key, as the traffic records them. The work is the published work at the
configuration's sizes, counted the same whatever kernel (or library call)
does it, per row (a sample through a net):

* each field's MLPs (Instant-NGP, section 5.4): density L F -> W -> 16, colour
  (16 + 16) -> W -> W -> 3, no biases: `mlp_macs` multiply-adds;
* the encoding's trilinear blend: L levels x 8 corners x F features
  multiply-adds (`blend_macs`); the index arithmetic and the gathers are
  memory work, not counted;
* the smpl_nerf warp field: Linear(in -> W) + Linear(W -> 3) (counts.py);
* a training step does forward + backward = 3x the forward's operations (the
  input and the weight gradients; the blend's backward scatters the features'
  gradient and takes the weights', as many multiply-adds twice); an
  evaluation pass (validation) the forward alone; 2 FLOP a multiply-add.

Peak: counts.PEAK_BF16_FLOPS (one NVIDIA H100 SXM, dense bf16, 989 TFLOP/s).
"""
from __future__ import annotations

from port_bench import counts

PEAK_BF16_FLOPS = counts.PEAK_BF16_FLOPS
GEOMETRY = 16
SH_COEFFICIENTS = 16


def mlp_macs(flags: dict) -> int:
    """Multiply-adds per row of one field's density and colour MLPs."""
    W = int(flags["grid_width"])
    enc = int(flags["hash_grid"]["n_levels"]) * int(flags["grid_features"])
    return enc * W + W * GEOMETRY + (SH_COEFFICIENTS + GEOMETRY) * W + W * W + W * 3


def blend_macs(flags: dict) -> int:
    """Multiply-adds per row of the trilinear blend over every level."""
    return int(flags["hash_grid"]["n_levels"]) * 8 * int(flags["grid_features"])


def macs_per_row(flags: dict) -> int:
    """A row's multiply-adds: its field, its blend and the warp field."""
    return mlp_macs(flags) + blend_macs(flags) + counts.macs_per_sample(flags)["warp"]


def forward_flops(flags: dict, rays: int) -> float:
    """FLOPs of the coarse and fine passes' forward over `rays` rays."""
    s = counts.samples_per_ray(flags)
    return 2.0 * rays * (s["coarse"] + s["fine"]) * macs_per_row(flags)


def train_flops(flags: dict, rays: int) -> float:
    """Forward + backward FLOPs of a training step over `rays` rays."""
    return 3.0 * forward_flops(flags, rays)
