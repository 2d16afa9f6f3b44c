"""Sample-axis (sequence-parallel) volume rendering over the mesh (counterpart of
smpl_nerf_tpu/parallel/sample_axis.py).

Rays split over the data axis (parallel/mesh.py); this splits the SAMPLES of
every ray over a mesh axis ('model' by default): each rank integrates its own
contiguous block of the sample axis, and the blocks compose associatively
(core.integrate.compose_segments), the volumetric analog of blockwise / ring
attention. A ray costs one all-gather of (3 + 1 + 1 + 1) floats per rank: the
block's rgb, transmittance, depth and acc.

JAX's function takes the global arrays and shards them under shard_map; one
process per device here, so each rank passes its own block (`segment` cuts it
from a global array) and gets back the whole ray's rgb / depth / acc and its
block's weights and density.
"""
from __future__ import annotations

from typing import Optional

import torch

from smpl_nerf_tpu_torch.core import integrate
from smpl_nerf_tpu_torch.core.integrate import RenderOutputs
from smpl_nerf_tpu_torch.parallel.mesh import Mesh


def segment(x: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """This rank's block of the sample axis (dim 1) of a global [R, S, ...] array."""
    _, j, n = mesh.axis(axis)
    S = x.shape[1]
    if S % n:
        raise ValueError(f"{S} samples do not split over a {n}-way '{axis}' axis")
    return x[:, j * (S // n):(j + 1) * (S // n)]


def sample_parallel_raw2outputs(mesh: Mesh, raw: torch.Tensor, z_vals: torch.Tensor,
                                dists: torch.Tensor, sigma_noise_std: float = 0.0,
                                white_background: bool = False,
                                generator: Optional[torch.Generator] = None,
                                axis: str = "model") -> RenderOutputs:
    """Volume-integrate with the sample axis split over mesh axis `axis`.

    raw [R, s, 4], z_vals / dists [R, s]: this rank's block of s = S / n
    samples. `dists` must be cut from the global dists (`global_dists`: the
    interval to the next block's first sample, the 1e10 sentinel, the
    |direction| scaling). Returns rgb / depth / acc of the whole ray and this
    block's weights and density.
    """
    group, j, n = mesh.axis(axis)
    seg_rgb, seg_T, seg_depth, seg_acc, local_w, density = integrate.segment_summaries(
        raw, z_vals, dists, 1, sigma_noise_std, generator)
    rgb, T, depth, acc = seg_rgb[:, 0], seg_T[:, 0], seg_depth[:, 0], seg_acc[:, 0]
    if group is not None:
        all_rgb, all_T, all_depth, all_acc = integrate.gather_segments(group, rgb, T, depth, acc)
    else:
        all_rgb, all_T, all_depth, all_acc = rgb[:, None], T[:, None], depth[:, None], acc[:, None]
    rgb_out, depth, acc, prefix = integrate.compose_prefix(all_rgb, all_T, all_depth, all_acc)
    weights = local_w[:, 0] * prefix[:, j, None]
    if white_background:
        rgb_out = rgb_out + (1.0 - acc[..., None])
    return RenderOutputs(rgb_out, weights, density, depth, acc)


def global_dists(z_vals: torch.Tensor, samples_directions: torch.Tensor) -> torch.Tensor:
    """The dists raw2outputs uses (the 1e10 sentinel and the |direction| scaling)."""
    return integrate.sample_dists(z_vals, samples_directions)
