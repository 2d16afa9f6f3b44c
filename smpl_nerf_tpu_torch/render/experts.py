"""KiloNeRF-style expert distillation and serving (counterpart of
smpl_nerf_tpu/render/experts.py): one big trunk -> a voxel grid of tiny MLPs.

Pieces:
  * `distill_experts`: fit stacked experts to any teacher field
    `teacher_fn(pos [N,3], dirs [N,3]) -> raw [N,4]` by sampled regression
    (arXiv:2103.13744), one Adam loop over all experts at once;
  * `expert_raw_fn` and its `_tiled` / `_culled` / `_bucketed` / `_compact`
    forms: the distilled drop-in for the trunk, and the matching
    `render_rays_with_experts*` renderers (integration is the main path's
    `raw2outputs`);
  * `grid_occupancy` / `cell_occupancy` / `dilate_occupancy` /
    `compact_field`: empty-space skipping at the expert level;
  * `finetune_experts`: photometric fine-tuning on training rays through the
    tiled (or bucketed) path;
  * `save_field` / `load_field`: `field.npz` with the keys the JAX package's
    tools/distill_run.py writes (w0 b0 w1 b1 aabb_min aabb_max grid l_pos
    l_dir), so a field crosses between the two packages in both directions.

`use_kernel=True` sends the tiled stream through the fused CUDA kernel
(ops/expert_tiles.py): forward-only, so training never passes it.

Randomness comes from an explicit `torch.Generator` on the field's device.
The batch draws (`sample_distill_batch`, `sample_finetune_batch`) are apart
from the steps (`distill_step`, `finetune_step`), so a test can feed both
packages the same numpy batch.
"""
from __future__ import annotations

import dataclasses
import math
import os
from functools import partial
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from smpl_nerf_tpu_torch.core.encoding import PositionalEncoder
from smpl_nerf_tpu_torch.core.integrate import RenderOutputs, raw2outputs
from smpl_nerf_tpu_torch.ops.expert_tiles import encoded_dim, expert_tiles_forward
from smpl_nerf_tpu_torch.parallel import ep


class ExpertField(NamedTuple):
    """A distilled voxel-expert radiance field."""
    experts: ep.ExpertMLP
    aabb_min: torch.Tensor   # [3]
    aabb_max: torch.Tensor   # [3]
    grid: int                # experts = grid^3
    l_pos: int               # positional-encoding frequencies (positions)
    l_dir: int               # positional-encoding frequencies (directions)


class CompactExpertField(NamedTuple):
    """An ExpertField restricted to its OCCUPIED cells: only occupied cells
    keep an expert. E_occ is fixed on the host."""
    experts: ep.ExpertMLP           # [E_occ, ...]
    remap: torch.Tensor             # [E + 1] int64: voxel id (or the E out-of-AABB
    #                                 sentinel) -> compact id; empty cells and the
    #                                 sentinel map to E_occ (the skip id)
    aabb_min: torch.Tensor
    aabb_max: torch.Tensor
    grid: int
    l_pos: int
    l_dir: int


Field = Union[ExpertField, CompactExpertField]


def _local_coords(field, pos: torch.Tensor) -> torch.Tensor:
    # cell-local coordinates: each expert sees its own cell mapped to [0,1)^3,
    # so the encoding's frequencies resolve detail inside the cell
    u = (pos - field.aabb_min) / (field.aabb_max - field.aabb_min)
    return u * field.grid - torch.floor(torch.clamp(u * field.grid, 0, field.grid - 1e-4))


def _encode(field, pos: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    pe_p = PositionalEncoder(field.l_pos, True)
    pe_d = PositionalEncoder(field.l_dir, True)
    return torch.cat([pe_p.encode(_local_coords(field, pos)), pe_d.encode(dirs)], -1)


def expert_raw_fn(field: ExpertField, pos: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """raw [N,4] from the distilled field: the trunk drop-in (dense gathers)."""
    ids = ep.voxel_expert_ids(pos, field.aabb_min, field.aabb_max, field.grid)
    return ep.expert_apply(field.experts, _encode(field, pos, dirs), ids)


def _route(field, pos: torch.Tensor):
    """Compact-aware routing: (ids, n_route) with ids in [0, n_route] and
    n_route the skip id. ExpertField: skip = out of the AABB;
    CompactExpertField: skip = out of the AABB or an empty cell (the remap)."""
    E = field.grid ** 3
    inside = torch.all((pos >= field.aabb_min) & (pos <= field.aabb_max), -1)
    vox = ep.voxel_expert_ids(pos, field.aabb_min, field.aabb_max, field.grid)
    ids = torch.where(inside, vox, torch.full_like(vox, E))
    remap = getattr(field, "remap", None)
    if remap is None:
        return ids, E
    return remap[ids], field.experts.w0.shape[0]


def _tiles(field, pos_slots, dirs_slots, plan, tile, compute_dtype, use_kernel):
    """raw [L, 4] of the plan's slots: the fused kernel, or encode + tiles_apply."""
    if use_kernel:
        return expert_tiles_forward(
            field.experts, _local_coords(field, pos_slots).contiguous(),
            dirs_slots.contiguous(), plan.valid, plan.tile_expert, l_pos=field.l_pos,
            l_dir=field.l_dir, tile=tile, compute_dtype=compute_dtype)
    return ep.tiles_apply(field.experts, _encode(field, pos_slots, dirs_slots), plan,
                          compute_dtype=compute_dtype)


def expert_raw_fn_tiled(field: Field, pos: torch.Tensor, dirs: torch.Tensor, budget: int,
                        tile: int = 256, compute_dtype: Optional[torch.dtype] = None,
                        use_kernel: bool = False):
    """raw [N,4] through the sorted-tile plan on the RAW sample stream: no
    [E, capacity] tensor, weights gathered once per tile, and only the padded
    stream is encoded. Returns (raw [N,4], overflow [N])."""
    ids, n_route = _route(field, pos)
    plan = ep.sorted_tile_plan(ids, n_route, budget, tile)
    out_slots = _tiles(field, pos[plan.tok], dirs[plan.tok], plan, tile, compute_dtype,
                       use_kernel)
    return ep.plan_take(plan, out_slots), plan.overflow


def culled_plan(field: Field, pos: torch.Tensor, budget: int, tile: int = 256):
    """The routing of `expert_raw_fn_culled`: (compaction of the in-field
    samples, sorted-tile plan on the compact stream, source sample of each of
    the plan's [budget] slots)."""
    ids, n_route = _route(field, pos)
    comp = ep.compact_stream(ids < n_route, budget)
    ids_c = torch.where(comp.valid, ids[comp.src], torch.full_like(comp.src, n_route))
    plan = ep.sorted_tile_plan(ids_c, n_route, budget, tile)
    return comp, plan, comp.src[plan.tok]


def expert_raw_fn_culled(field: Field, pos: torch.Tensor, dirs: torch.Tensor, budget: int,
                         tile: int = 256, compute_dtype: Optional[torch.dtype] = None,
                         use_kernel: bool = False):
    """Cull-then-route serving: the in-field samples are first compacted
    (`ep.compact_stream`, one cumsum and one scatter), and the sort, the plan,
    the encoding and the MLP all run on the compact [budget] stream; results
    map back through one gather. Same `budget` as the tiled path (it bounds
    real tokens + padding, so it bounds the compact stream too). Returns
    (raw [N,4], n_overflow scalar): compaction drops + plan drops."""
    comp, plan, src = culled_plan(field, pos, budget, tile)
    out_slots = _tiles(field, pos[src], dirs[src], plan, tile, compute_dtype, use_kernel)
    out_c = ep.plan_take(plan, out_slots)                                  # [budget, O]
    raw = out_c[torch.clamp(comp.pos, 0, budget - 1)] * comp.kept[:, None].to(out_c.dtype)
    return raw, plan.overflow.sum() + comp.n_dropped


def _flat_samples(origins, dirs, z_vals):
    pos = origins[:, None, :] + z_vals[..., None] * dirs[:, None, :]
    R, S = z_vals.shape
    return pos.reshape(-1, 3), dirs[:, None, :].expand(R, S, 3).reshape(-1, 3)


def render_rays_with_experts_tiled(field: Field, origins: torch.Tensor, dirs: torch.Tensor,
                                   z_vals: torch.Tensor, budget: int, tile: int = 256,
                                   white_background: bool = False,
                                   compute_dtype: Optional[torch.dtype] = None,
                                   use_kernel: bool = False) -> tuple:
    """Tiled-serving renderer (full or compact field). Returns (RenderOutputs,
    n_overflow): callers must check n_overflow == 0 and raise the budget
    otherwise."""
    pos, d_flat = _flat_samples(origins, dirs, z_vals)
    raw, overflow = expert_raw_fn_tiled(field, pos, d_flat, budget, tile,
                                        compute_dtype=compute_dtype, use_kernel=use_kernel)
    outs = raw2outputs(raw.reshape(*z_vals.shape, 4), z_vals, dirs,
                       white_background=white_background)
    return outs, overflow.sum()


def render_rays_with_experts_culled(field: Field, origins: torch.Tensor, dirs: torch.Tensor,
                                    z_vals: torch.Tensor, budget: int, tile: int = 256,
                                    white_background: bool = False,
                                    compute_dtype: Optional[torch.dtype] = None,
                                    use_kernel: bool = False) -> tuple:
    """Cull-then-route twin of `render_rays_with_experts_tiled` (same contract)."""
    pos, d_flat = _flat_samples(origins, dirs, z_vals)
    raw, n_over = expert_raw_fn_culled(field, pos, d_flat, budget, tile,
                                       compute_dtype=compute_dtype, use_kernel=use_kernel)
    outs = raw2outputs(raw.reshape(*z_vals.shape, 4), z_vals, dirs,
                       white_background=white_background)
    return outs, n_over


def expert_raw_fn_bucketed(field: Field, pos: torch.Tensor, dirs: torch.Tensor,
                           capacity: int, compute_dtype: Optional[torch.dtype] = None):
    """raw [N,4] through the sorted-bucket path (`ep.expert_apply_bucketed`).
    Samples outside the AABB (and, for a compact field, in empty cells) go to
    the skip id and use no capacity. Returns (raw [N,4], overflow [N])."""
    ids, _ = _route(field, pos)
    res = ep.expert_apply_bucketed(field.experts, _encode(field, pos, dirs), ids, capacity,
                                   compute_dtype=compute_dtype)
    return res.out, res.overflow


# empty-space skipping with buckets: the remap of `_route` sends empty cells to the skip id
expert_raw_fn_compact = expert_raw_fn_bucketed


def render_rays_with_experts_bucketed(field: Field, origins: torch.Tensor, dirs: torch.Tensor,
                                      z_vals: torch.Tensor, capacity: int,
                                      white_background: bool = False,
                                      compute_dtype: Optional[torch.dtype] = None) -> tuple:
    """Bucketed-serving twin of `render_rays_with_experts`. Returns
    (RenderOutputs, n_overflow)."""
    pos, d_flat = _flat_samples(origins, dirs, z_vals)
    raw, overflow = expert_raw_fn_bucketed(field, pos, d_flat, capacity,
                                           compute_dtype=compute_dtype)
    outs = raw2outputs(raw.reshape(*z_vals.shape, 4), z_vals, dirs,
                       white_background=white_background)
    return outs, overflow.sum()


# the compact field's twin is the same function: only the routing differs
render_rays_with_experts_compact = render_rays_with_experts_bucketed


def render_rays_with_experts(field: ExpertField, origins: torch.Tensor, dirs: torch.Tensor,
                             z_vals: torch.Tensor,
                             white_background: bool = False) -> RenderOutputs:
    """Volume-render rays straight from the distilled field (dense gathers)."""
    pos, d_flat = _flat_samples(origins, dirs, z_vals)
    raw = expert_raw_fn(field, pos, d_flat).reshape(*z_vals.shape, 4)
    return raw2outputs(raw, z_vals, dirs, white_background=white_background)


# ------------------------------------------------------------- field files

def field_to(field: Field, device) -> Field:
    """The field with every tensor on `device`."""
    return type(field)(*(ep.ExpertMLP(*(w.to(device) for w in v)) if isinstance(v, ep.ExpertMLP)
                         else v.to(device) if isinstance(v, torch.Tensor) else v
                         for v in field))


def save_field(path: str, field: ExpertField) -> None:
    """Write `field.npz` (float32 numpy; keys w0 b0 w1 b1 aabb_min aabb_max
    grid l_pos l_dir) through a temporary file, so a cut write leaves no
    truncated field behind."""
    tmp = path + ".tmp.npz"          # savez keeps names that end in .npz
    np.savez(tmp, **{k: v.detach().cpu().numpy() for k, v in field.experts._asdict().items()},
             aabb_min=field.aabb_min.cpu().numpy(), aabb_max=field.aabb_max.cpu().numpy(),
             grid=field.grid, l_pos=field.l_pos, l_dir=field.l_dir)
    os.replace(tmp, path)


def load_field(path: str, device="cpu") -> ExpertField:
    """Read a `field.npz` written by `save_field` or by the JAX package."""
    with np.load(path) as z:
        experts = ep.ExpertMLP(*(torch.tensor(np.asarray(z[k], np.float32), device=device)
                                 for k in ("w0", "b0", "w1", "b1")))
        return ExpertField(experts,
                           torch.tensor(np.asarray(z["aabb_min"], np.float32), device=device),
                           torch.tensor(np.asarray(z["aabb_max"], np.float32), device=device),
                           int(z["grid"]), int(z["l_pos"]), int(z["l_dir"]))


# ---------------------------------------------------------------- distillation

def sample_distill_batch(generator: torch.Generator, aabb_min: torch.Tensor,
                         aabb_max: torch.Tensor, grid: int, batch: int,
                         occ_ids: Optional[torch.Tensor] = None, bias_frac: float = 0.5):
    """`batch` positions uniform in the AABB and random unit directions. With
    `occ_ids` (ids of occupied cells), `bias_frac` of the positions are drawn
    uniformly inside occupied cells instead."""
    device = aabb_min.device

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)

    pos = aabb_min + (aabb_max - aabb_min) * uniform(batch, 3)
    if occ_ids is not None:
        cid = occ_ids[torch.randint(0, occ_ids.shape[0], (batch,), generator=generator,
                                    device=device)]
        corner = torch.stack([cid // (grid * grid), (cid // grid) % grid, cid % grid], -1).float()
        pos_b = aabb_min + (corner + uniform(batch, 3)) * ((aabb_max - aabb_min) / grid)
        pos = torch.where(uniform(batch, 1) < bias_frac, pos_b, pos)
    d = torch.randn((batch, 3), generator=generator, device=device)
    return pos, d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-9)


def distill_step(field: ExpertField, params, optimizer: torch.optim.Optimizer,
                 pos: torch.Tensor, dirs: torch.Tensor, target: torch.Tensor,
                 ch_scale: torch.Tensor) -> torch.Tensor:
    """One Adam step of `params` (the four expert tensors, leaves that require
    grad) on the per-channel-normalised MSE against the teacher's `target`."""
    ids = ep.voxel_expert_ids(pos, field.aabb_min, field.aabb_max, field.grid)
    x = _encode(field, pos, dirs)
    optimizer.zero_grad(set_to_none=True)
    loss = torch.mean(((ep.expert_apply(ep.ExpertMLP(*params), x, ids) - target) / ch_scale) ** 2)
    loss.backward()
    optimizer.step()
    return loss.detach()


def _trainable(experts: ep.ExpertMLP):
    return [w.detach().clone().requires_grad_(True) for w in experts]


def distill_experts(teacher_fn: Callable, aabb_min, aabb_max, grid: int,
                    generator: torch.Generator, *, hidden: int = 32, l_pos: int = 4,
                    l_dir: int = 2, n_steps: int = 1000, batch: int = 4096, lr: float = 1e-3,
                    occupied=None, bias_frac: float = 0.5,
                    history: Optional[list] = None) -> tuple:
    """Fit a grid^3 stacked-expert field to the teacher by sampled regression,
    on the generator's device. Returns (ExpertField, final loss).

    Every step draws `batch` positions and unit directions, queries the
    teacher, and Adam-steps ALL experts jointly on the per-channel-normalised
    MSE of the raw [rgb, sigma] outputs (each sample touches only its own
    cell's expert). The channel scales come from one probe batch and stay
    fixed. `occupied` [grid^3] bool turns on occupancy-biased sampling. A
    `history` list receives (step, loss) at every heartbeat.
    """
    device = generator.device
    aabb_min = torch.as_tensor(np.asarray(aabb_min, np.float32), device=device)
    aabb_max = torch.as_tensor(np.asarray(aabb_max, np.float32), device=device)
    experts = ep.init_experts(generator, grid ** 3, encoded_dim(l_pos, l_dir), hidden, 4)
    field = ExpertField(experts, aabb_min, aabb_max, grid, l_pos, l_dir)
    params = _trainable(experts)
    optimizer = torch.optim.Adam(params, lr=lr, eps=1e-8)
    occ_ids = (torch.as_tensor(np.where(np.asarray(occupied, bool))[0], device=device)
               if occupied is not None else None)
    sample = partial(sample_distill_batch, generator, aabb_min, aabb_max, grid, batch, occ_ids,
                     bias_frac)
    with torch.no_grad():
        ch_scale = torch.clamp(torch.std(teacher_fn(*sample()), dim=0, unbiased=False),
                               min=1e-3)
    loss = torch.tensor(float("inf"))
    hb = max(1, n_steps // 20)   # heartbeat: a long fit must not look hung
    for i in range(n_steps):
        pos, dirs = sample()
        with torch.no_grad():
            target = teacher_fn(pos, dirs)
        loss = distill_step(field, params, optimizer, pos, dirs, target, ch_scale)
        if (i + 1) % hb == 0 or i + 1 == n_steps:
            print(f"  distill step {i + 1}/{n_steps} nmse {float(loss):.4f}", flush=True)
            if history is not None:
                history.append((i + 1, float(loss)))
    return field._replace(experts=ep.ExpertMLP(*(p.detach() for p in params))), float(loss)


# ------------------------------------------------------------------- occupancy

@torch.no_grad()
def grid_occupancy(raw_fn: Callable, aabb_min, aabb_max, grid: int, samples_per_axis: int = 3,
                   sigma_thresh: float = 1.0, chunk: int = 262144, device="cpu") -> np.ndarray:
    """[grid^3] bool (host numpy): does any lattice probe inside each cell
    clear `sigma_thresh` raw density, for any field
    `raw_fn(pos [N,3], dirs [N,3]) -> raw [N,4]`. Cell order is
    (x*g + y)*g + z, the id layout of `ep.voxel_expert_ids`.

    Probes with three spread directions and keeps the max sigma per point: a
    distilled expert feeds the direction encoding into the same tiny net, so
    its sigma can drift with view. `chunk` bounds memory only.
    """
    g, k = grid, samples_per_axis
    lo = np.asarray(torch.as_tensor(aabb_min).cpu(), np.float32)
    hi = np.asarray(torch.as_tensor(aabb_max).cpu(), np.float32)
    cell = (hi - lo) / g
    ax = np.arange(g, dtype=np.float32)
    corners = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    off = (np.arange(k, dtype=np.float32) + 0.5) / k       # strictly inside the cell
    lattice = np.stack(np.meshgrid(off, off, off, indexing="ij"), -1).reshape(-1, 3)
    pts = ((corners[:, None, :] + lattice[None, :, :]) * cell + lo).reshape(-1, 3)
    probe_dirs = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0],
                               [0.0, -0.7071068, -0.7071068]], device=device)
    sig = []
    for i in range(0, len(pts), chunk):
        p = torch.as_tensor(pts[i:i + chunk], device=device)
        s = None
        for pd in probe_dirs:
            si = raw_fn(p, pd.expand(p.shape))[:, 3]
            s = si if s is None else torch.maximum(s, si)
        sig.append(s.cpu().numpy())
    sigma = np.concatenate(sig).reshape(g ** 3, k ** 3)
    return sigma.max(axis=1) > sigma_thresh


def cell_occupancy(field: ExpertField, samples_per_axis: int = 3,
                   sigma_thresh: float = 1.0) -> np.ndarray:
    """[E] bool: `grid_occupancy` of the distilled field itself, so the mask
    is consistent with what serving would render."""
    return grid_occupancy(partial(expert_raw_fn, field), field.aabb_min, field.aabb_max,
                          field.grid, samples_per_axis, sigma_thresh,
                          device=field.aabb_min.device)


def dilate_occupancy(occupied, grid: int) -> np.ndarray:
    """One-cell 6-neighbourhood dilation (numpy, host): guards thin
    structures the probe lattice might straddle."""
    occ = np.asarray(occupied, bool).reshape(grid, grid, grid)
    out = occ.copy()
    for axis in range(3):
        fwd = [slice(None)] * 3
        bwd = [slice(None)] * 3
        fwd[axis] = slice(1, None)
        bwd[axis] = slice(None, -1)
        out[tuple(fwd)] |= occ[tuple(bwd)]   # +1 shift, no wrap
        out[tuple(bwd)] |= occ[tuple(fwd)]   # -1 shift, no wrap
    return out.reshape(-1)


def compact_field(field: ExpertField, occupied) -> CompactExpertField:
    """Drop empty cells' experts; build the id remap on the host. Empty cells
    and the out-of-AABB sentinel both remap to the compact skip id E_occ."""
    occupied = np.asarray(occupied, bool)
    E = field.grid ** 3
    idx = np.where(occupied)[0]
    if idx.size == 0:
        raise ValueError("no occupied cells — sigma_thresh too high?")
    remap = np.full(E + 1, idx.size, np.int64)
    remap[idx] = np.arange(idx.size)
    device = field.aabb_min.device
    sel = torch.as_tensor(idx, device=device)
    return CompactExpertField(ep.ExpertMLP(*(w[sel] for w in field.experts)),
                              torch.as_tensor(remap, device=device), field.aabb_min,
                              field.aabb_max, field.grid, field.l_pos, field.l_dir)


# ------------------------------------------------------------------ fine-tuning

@dataclasses.dataclass(frozen=True)
class CosineDecay:
    """optax.cosine_decay_schedule(init, steps, alpha): the rate of update
    `count` (0 for the first) falls from `init` to `init * alpha`."""
    init: float
    steps: int
    alpha: float = 0.0

    def __call__(self, count: int) -> float:
        t = min(count, self.steps) / self.steps
        return self.init * ((1.0 - self.alpha) * 0.5 * (1.0 + math.cos(math.pi * t))
                            + self.alpha)


def sample_finetune_batch(generator: torch.Generator, n_rays: int, batch: int, n_samples: int,
                          near: float, far: float):
    """Ray indices [batch] and stratified depths [batch, n_samples]: one
    uniform draw inside each of `n_samples` equal bins of [near, far]."""
    device = generator.device
    idx = torch.randint(0, n_rays, (batch,), generator=generator, device=device)
    lo = torch.linspace(near, far, n_samples + 1, device=device)[:-1]
    z = lo[None] + (far - near) / n_samples * torch.rand((batch, n_samples),
                                                         generator=generator, device=device)
    return idx, z


def finetune_step(field: Field, params, optimizer: torch.optim.Optimizer, o: torch.Tensor,
                  d: torch.Tensor, c: torch.Tensor, z: torch.Tensor, *, budget: int = 0,
                  capacity: int = 0, tile: int = 32, white_background: bool = False):
    """One Adam step of `params` on the pixel MSE of rays (o, d) with colours
    c at depths z, rendered through the tiled (`budget`) or the bucketed
    (`capacity`) path. Returns (loss, n_overflow)."""
    optimizer.zero_grad(set_to_none=True)
    current = field._replace(experts=ep.ExpertMLP(*params))
    if budget:
        outs, n_over = render_rays_with_experts_tiled(current, o, d, z, budget, tile,
                                                      white_background=white_background)
    else:
        outs, n_over = render_rays_with_experts_bucketed(current, o, d, z, capacity,
                                                         white_background=white_background)
    loss = torch.mean((outs.rgb - c) ** 2)
    loss.backward()
    optimizer.step()
    return loss.detach(), n_over


def finetune_experts(field: Field, origins, dirs, rgb, generator: torch.Generator, *,
                     near: float, far: float, n_samples: int, capacity: int = 0,
                     budget: int = 0, tile: int = 32, n_steps: int = 1000, batch: int = 4096,
                     lr: Union[float, Callable[[int], float]] = 5e-4,
                     white_background: bool = False, checkpoint_path: Optional[str] = None,
                     checkpoint_every: int = 0, history: Optional[list] = None):
    """Photometric fine-tuning of the distilled experts on training rays
    (arXiv:2103.13744 §3.3). origins/dirs/rgb are the train split's ray
    arrays [N,3]; every step draws `batch` rays, stratified-samples
    `n_samples` depths, renders through a serving path and Adam-steps the
    experts on the pixel MSE. Overflowed samples render as empty space; their
    count is accumulated and returned.

    Pass `budget` (> 0, a multiple of `tile`) to train through the sorted-tile
    path, which also takes a CompactExpertField; `capacity` (> 0) selects the
    bucketed path. Exactly one must be set. `lr` is a rate or a function of
    the update count (`CosineDecay`).

    `checkpoint_path` + `checkpoint_every`: every `checkpoint_every` steps the
    whole training state (weights, Adam moments, step, overflow count,
    generator state) is written atomically; a rerun with the same arguments
    resumes the same step, moments and random stream. A checkpoint of other
    steps, shapes, dtypes, lr or batch is stale and ignored. A `history` list
    receives (step, loss) at every heartbeat of this call.

    Returns (field, final_loss, total_overflow).
    """
    if bool(budget) == bool(capacity):
        raise ValueError("set exactly one of budget (tiled) / capacity (bucketed)")
    device = generator.device
    origins, dirs, rgb = (torch.as_tensor(a, dtype=torch.float32, device=device)
                          for a in (origins, dirs, rgb))
    field = field_to(field, device)
    params = _trainable(field.experts)
    lr_at = lr if callable(lr) else (lambda count: lr)
    optimizer = torch.optim.Adam(params, lr=lr_at(0), eps=1e-8)
    total_over = torch.zeros((), dtype=torch.int64, device=device)
    names = ("w0", "b0", "w1", "b1")
    key = {"n_steps": n_steps, "batch": batch, "lr": repr(lr),
           "dtypes": " ".join(str(p.dtype) for p in params)}

    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as z:
            ok = (all(k in z and str(z[k]) == str(v) for k, v in key.items())
                  and all(f"{n}{s}" in z and z[f"{n}{s}"].shape == tuple(p.shape)
                          for n, p in zip(names, params) for s in ("", "_m", "_v")))
            if ok:
                state = {"state": {}, "param_groups": optimizer.state_dict()["param_groups"]}
                with torch.no_grad():
                    for i, (n, p) in enumerate(zip(names, params)):
                        p.copy_(torch.as_tensor(z[n]))
                        state["state"][i] = {
                            "step": torch.tensor(float(z["step"])),
                            "exp_avg": torch.as_tensor(z[f"{n}_m"]).to(device),
                            "exp_avg_sq": torch.as_tensor(z[f"{n}_v"]).to(device)}
                optimizer.load_state_dict(state)
                total_over += int(z["total_over"])
                generator.set_state(torch.as_tensor(z["generator"]))
                start = int(z["step"])
        if ok:
            print(f"  resumed fine-tune checkpoint at step {start}/{n_steps}", flush=True)
        else:
            print(f"  stale fine-tune checkpoint {checkpoint_path} ignored", flush=True)

    def save_checkpoint(step):
        arrays = {}
        for i, (n, p) in enumerate(zip(names, params)):
            moments = optimizer.state[p]
            arrays[n] = p.detach().cpu().numpy()
            arrays[f"{n}_m"] = moments["exp_avg"].cpu().numpy()
            arrays[f"{n}_v"] = moments["exp_avg_sq"].cpu().numpy()
        tmp = checkpoint_path + ".tmp.npz"       # savez keeps names that end in .npz
        np.savez(tmp, step=step, total_over=int(total_over),
                 generator=generator.get_state().cpu().numpy(), **key, **arrays)
        os.replace(tmp, checkpoint_path)         # atomic: no truncated checkpoint

    loss = torch.tensor(float("inf"))
    hb = max(1, n_steps // 20)   # heartbeat: a long fit must not look hung
    for i in range(start, n_steps):
        for group in optimizer.param_groups:
            group["lr"] = lr_at(i)
        idx, z = sample_finetune_batch(generator, origins.shape[0], batch, n_samples, near, far)
        loss, n_over = finetune_step(field, params, optimizer, origins[idx], dirs[idx],
                                     rgb[idx], z, budget=budget, capacity=capacity, tile=tile,
                                     white_background=white_background)
        total_over += n_over        # accumulates on the device: no sync per step
        if (i + 1) % hb == 0 or i + 1 == n_steps:
            print(f"  finetune step {i + 1}/{n_steps} mse {float(loss):.6f}", flush=True)
            if history is not None:
                history.append((i + 1, float(loss)))
        if (checkpoint_path and checkpoint_every and (i + 1) % checkpoint_every == 0
                and (i + 1) < n_steps):
            save_checkpoint(i + 1)
    if checkpoint_path and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)   # phase done: the caller saves the field
    return (field._replace(experts=ep.ExpertMLP(*(p.detach() for p in params))), float(loss),
            int(total_over))
