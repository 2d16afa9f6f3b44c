"""Alpha-composite volume rendering (counterpart of smpl_nerf_tpu/core/integrate.py).

Keeps the reference's parity-relevant quirks:
  * dists: z-diffs with 1e10 appended, scaled by ||direction|| per sample
    ([R, S, 3] directions) or per ray ([R, 3]),
  * color = sigmoid(raw[..., :3]), alpha = 1 - exp(-relu(sigma) * dist),
  * exclusive cumprod of (1 - alpha + 1e-10) for transmittance,
  * optional gaussian sigma noise (training only, drawn from a generator),
  * white-background compositing rgb += (1 - acc),
  * the single-sample path returns sigmoid(rgb) directly.

`raw2outputs_segmented` integrates the sample axis in segments that compose
associatively (`compose_segments`), the same sums as `raw2outputs` (same
epsilons): locally as a reshape, or with `group` over a process group whose
ranks each hold one contiguous block of the samples (parallel/sample_axis.py).
Where the JAX function takes a mesh axis name under shard_map, the port takes
the group: each process is one device.

Under data parallelism a `RowDraws` stands in for the generator: jitter and
sigma noise are drawn for the whole global batch, and this rank keeps its
rows, so the world size does not change the numbers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.distributed as dist


class RenderOutputs(NamedTuple):
    rgb: torch.Tensor        # [R, 3]
    weights: torch.Tensor    # [R, S]
    density: torch.Tensor    # [R, S] (alpha per sample)
    depth: torch.Tensor      # [R]
    acc: torch.Tensor        # [R]


class RowDraws(NamedTuple):
    """A generator whose draws cover a global batch of `n` rows, of which
    this rank keeps rows [lo, hi) (`draw`)."""
    generator: torch.Generator
    lo: int
    hi: int
    n: int

    @property
    def device(self) -> torch.device:
        return self.generator.device


Draws = Union[torch.Generator, RowDraws]


def draw(fn, shape, generator: Draws, dtype=torch.float32) -> torch.Tensor:
    """fn(shape) (torch.rand / torch.randn) from `generator`, on its device.
    A RowDraws draws the global rows and returns its own."""
    if isinstance(generator, RowDraws):
        full = fn((generator.n,) + tuple(shape[1:]), generator=generator.generator,
                  dtype=dtype, device=generator.device)
        return full[generator.lo:generator.hi]
    return fn(tuple(shape), generator=generator, dtype=dtype, device=generator.device)


def raw2outputs(raw: torch.Tensor, z_vals: torch.Tensor, samples_directions: torch.Tensor,
                sigma_noise_std: float = 0.0, white_background: bool = False,
                generator: Optional[torch.Generator] = None) -> RenderOutputs:
    """Integrate raw MLP outputs [R, S, 4] along rays.

    samples_directions: [R, S, 3] or [R, 3]; only the norm is used. Noise is
    added only when a generator is given and sigma_noise_std > 0.
    """
    rgb = torch.sigmoid(raw[..., :3])
    if z_vals.shape[-1] == 1:
        r = rgb.reshape(raw.shape[0], 3)
        ones = torch.ones((raw.shape[0], 1), dtype=raw.dtype, device=raw.device)
        return RenderOutputs(r, ones, ones, z_vals[..., 0], ones[..., 0])

    dists = sample_dists(z_vals, samples_directions)
    sigma = raw[..., 3]
    if generator is not None and sigma_noise_std > 0.0:
        noise = draw(torch.randn, sigma.shape, generator, sigma.dtype).to(sigma.device)
        sigma = sigma + sigma_noise_std * noise
    density = 1.0 - torch.exp(-torch.relu(sigma) * dists)

    one_minus = 1.0 - density + 1e-10
    exclusive = torch.cat([torch.ones_like(one_minus[..., :1]), one_minus[..., :-1]], -1)
    weights = density * torch.cumprod(exclusive, -1)

    rgb_out = torch.sum(weights[..., None] * rgb, -2)
    depth = torch.sum(weights * z_vals, -1)
    acc = torch.sum(weights, -1)
    if white_background:
        rgb_out = rgb_out + (1.0 - acc[..., None])
    return RenderOutputs(rgb_out, weights, density, depth, acc)


def compose_segments(rgb_a, trans_a, rgb_b, trans_b):
    """Compose two front-to-back segments (accumulated rgb, remaining
    transmittance T): rgb = rgb_a + T_a * rgb_b, T = T_a * T_b. Associative,
    which is what lets the sample axis split."""
    return rgb_a + trans_a[..., None] * rgb_b, trans_a * trans_b


def sample_dists(z_vals: torch.Tensor, samples_directions: torch.Tensor,
                 next_z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """raw2outputs' dists: z-diffs, then the interval to `next_z` [R, 1] (the
    next segment's first sample) or the 1e10 sentinel, scaled by |direction|
    (per ray [R, 3] or per sample [R, S, 3])."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    last = torch.full_like(dists[..., :1], 1e10) if next_z is None else next_z - z_vals[..., -1:]
    dists = torch.cat([dists, last], -1)
    if samples_directions.dim() == z_vals.dim():
        return dists * torch.linalg.norm(samples_directions, dim=-1, keepdim=True)
    return dists * torch.linalg.norm(samples_directions, dim=-1)


def segment_summaries(raw, z_vals, dists, num_segments: int = 1, sigma_noise_std: float = 0.0,
                      generator: Optional[Draws] = None):
    """Each of `num_segments` equal blocks of the sample axis integrated on its
    own: (rgb [R, P, 3], T [R, P], depth [R, P], acc [R, P], the local
    weights [R, P, seg], density [R, S])."""
    R, S = z_vals.shape
    if S % num_segments:
        raise ValueError(f"{S} samples do not split into {num_segments} segments")
    seg = S // num_segments
    rgb = torch.sigmoid(raw[..., :3])
    sigma = raw[..., 3]
    if generator is not None and sigma_noise_std > 0.0:
        sigma = sigma + sigma_noise_std * draw(torch.randn, sigma.shape, generator,
                                               sigma.dtype).to(sigma.device)
    density = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    one_minus = (1.0 - density + 1e-10).reshape(R, num_segments, seg)
    exclusive = torch.cat([torch.ones_like(one_minus[..., :1]), one_minus[..., :-1]], -1)
    local_w = density.reshape(R, num_segments, seg) * torch.cumprod(exclusive, -1)
    seg_rgb = torch.sum(local_w[..., None] * rgb.reshape(R, num_segments, seg, 3), -2)
    seg_T = torch.prod(one_minus, -1)
    seg_depth = torch.sum(local_w * z_vals.reshape(R, num_segments, seg), -1)
    seg_acc = torch.sum(local_w, -1)
    return seg_rgb, seg_T, seg_depth, seg_acc, local_w, density


def compose_prefix(seg_rgb, seg_T, seg_depth, seg_acc):
    """Segments [R, P] composed front to back: (rgb, depth, acc, the exclusive
    prefix transmittance in front of each segment [R, P])."""
    prefix = torch.cumprod(torch.cat([torch.ones_like(seg_T[..., :1]), seg_T[..., :-1]], -1), -1)
    return (torch.sum(prefix[..., None] * seg_rgb, -2), torch.sum(prefix * seg_depth, -1),
            torch.sum(prefix * seg_acc, -1), prefix)


def gather_segments(group, *parts):
    """Every rank's [R, ...] summaries side by side in rank order: [R, n, ...]."""
    n = dist.get_world_size(group)
    out = []
    for t in parts:
        bufs = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(bufs, t.contiguous(), group=group)
        out.append(torch.stack(bufs, 1))
    return out


def raw2outputs_segmented(raw: torch.Tensor, z_vals: torch.Tensor,
                          samples_directions: torch.Tensor, num_segments: int,
                          sigma_noise_std: float = 0.0, white_background: bool = False,
                          generator: Optional[Draws] = None, group=None) -> RenderOutputs:
    """Volume integration over `num_segments` segments of the sample axis.

    Local mode (group None): raw [R, S, 4] / z_vals [R, S] whole, the segments
    a reshape, dists from the whole z_vals: the same result as raw2outputs.
    With `group`, this rank holds the samples of its block of the axis (the
    ranks' blocks in rank order make the whole axis); its last interval runs
    to the next rank's first sample (one all-gather of the first z), its
    blocks are composed locally and then over the group (one all-gather of the
    (rgb, T, depth, acc) summaries). weights and density come back for this
    rank's samples; rgb, depth and acc for the whole ray.
    """
    R, S = z_vals.shape
    next_z = None
    if group is not None:
        (firsts,) = gather_segments(group, z_vals[:, :1])
        j, n = dist.get_rank(group), dist.get_world_size(group)
        next_z = firsts[:, j + 1] if j + 1 < n else None
    dists = sample_dists(z_vals, samples_directions, next_z)
    seg_rgb, seg_T, seg_depth, seg_acc, local_w, density = segment_summaries(
        raw, z_vals, dists, num_segments, sigma_noise_std, generator)
    rgb_out, depth, acc, prefix = compose_prefix(seg_rgb, seg_T, seg_depth, seg_acc)
    weights = (local_w * prefix[..., None]).reshape(R, S)
    if group is not None:
        # this rank's whole block as one segment, composed over the group
        all_rgb, all_T, all_depth, all_acc = gather_segments(
            group, rgb_out, torch.prod(seg_T, -1), depth, acc)
        rgb_out, depth, acc, ranks_prefix = compose_prefix(all_rgb, all_T, all_depth, all_acc)
        weights = weights * ranks_prefix[:, dist.get_rank(group), None]
    if white_background:
        rgb_out = rgb_out + (1.0 - acc[..., None])
    return RenderOutputs(rgb_out, weights, density, depth, acc)
