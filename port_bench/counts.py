"""Operations, bytes and peaks the per-layer shares divide by (frozen yardstick).

The work is the published work of the configuration's widths at the cell's
shapes, counted the same whatever kernel (or library call) does it:

* `mlp_macs`: multiply-adds per sample of a RenderRayNet, every layer and
  both heads (the count under the kernel table of PERF.md);
* the smpl_nerf warp field: Linear(in -> W) + Linear(W -> 3) per sample, in
  the coarse and in the fine pass;
* a training step does forward + backward = 3x the forward's operations
  (6 FLOP per multiply-add); an evaluation pass (validation, a view) 2 FLOP;
* kernel B's work is its nets' forward, kernel C's 3x that (C recomputes the
  forward, then takes dH and dW).

Peak: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no sparsity, at the
700 W power limit): 989 TFLOP/s in bf16.
"""
from __future__ import annotations

from typing import Dict

PEAK_BF16_FLOPS = 989e12


def mlp_macs(n_layers: int, width: int, positions_dim: int, directions_dim: int,
             additional_input_dim: int, skips, use_directional_input: bool = True) -> int:
    """Multiply-adds per sample of a RenderRayNet (every layer, both heads)."""
    W, P, D, add = width, positions_dim, directions_dim, additional_input_dim
    macs = (P + add) * W
    macs += sum((W + (P + add if i in skips else 0)) * W for i in range(n_layers - 1))
    macs += W * W + W                                            # additional layer, sigma head
    macs += (W + (D if use_directional_input else 0)) * (W // 2)
    macs += (W // 2) * (W // 2) + (W // 2) * 3                   # directional_net_0, rgb head
    return macs


def _dims(flags: dict) -> dict:
    lp, ld = int(flags["number_frequencies_postitional"]), int(
        flags["number_frequencies_directional"])
    pos = 3 * (2 * lp + int(flags["use_identity_positional"]))
    dirs = 3 * (2 * ld + int(flags["use_identity_directional"]))
    per_joint = ((2 * int(flags["number_frequencies_pose"]) + int(flags["use_identity_pose"]))
                 if int(flags["human_pose_encoding"]) else 1)
    add = {"append_smpl_params": 69 * per_joint,
           "append_to_nerf": 2 * per_joint}.get(flags["model_type"], 0)
    warp_in = ((pos if int(flags["human_pose_encoding"]) else 3) + 2 * per_joint
               if flags["model_type"] == "smpl_nerf" else 0)
    return {"pos": pos, "dir": dirs, "add": add, "warp_in": warp_in}


def macs_per_sample(flags: dict) -> Dict[str, int]:
    """{'coarse', 'fine', 'warp'}: multiply-adds per sample of each net
    ('warp' 0 without a warp field)."""
    d = _dims(flags)
    use_dir = bool(int(flags.get("use_directional_input", 1)))
    coarse = mlp_macs(int(flags["netdepth"]), int(flags["netwidth"]), d["pos"], d["dir"],
                      d["add"], [int(s) for s in flags["skips"]], use_dir)
    fine = mlp_macs(int(flags["netdepth_fine"]), int(flags["netwidth_fine"]), d["pos"],
                    d["dir"], d["add"], [int(s) for s in flags["skips_fine"]], use_dir)
    ww = int(flags["netwidth_warp"])
    warp = d["warp_in"] * ww + ww * 3 if d["warp_in"] else 0
    return {"coarse": coarse, "fine": fine, "warp": warp}


def samples_per_ray(flags: dict) -> Dict[str, int]:
    """{'coarse', 'fine'}: rows each pass sends through its net per ray."""
    nc, nf = int(flags["number_coarse_samples"]), int(flags["number_fine_samples"])
    return {"coarse": nc, "fine": nc + nf if int(flags["run_fine"]) else 0}


def net_forward_flops(flags: dict, rays: int) -> float:
    """FLOPs of the coarse and fine RenderRayNets' forward over `rays` rays."""
    m, s = macs_per_sample(flags), samples_per_ray(flags)
    return 2.0 * rays * (s["coarse"] * m["coarse"] + s["fine"] * m["fine"])


def forward_flops(flags: dict, rays: int) -> float:
    """FLOPs of every net's forward (both RenderRayNets and the warp field)."""
    m, s = macs_per_sample(flags), samples_per_ray(flags)
    return net_forward_flops(flags, rays) + 2.0 * rays * (s["coarse"] + s["fine"]) * m["warp"]


def train_flops(flags: dict, rays: int) -> float:
    """Forward + backward FLOPs of a training step over `rays` rays."""
    return 3.0 * forward_flops(flags, rays)
