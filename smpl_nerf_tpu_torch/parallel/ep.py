"""Spatially-decomposed NeRF experts, the single-device half (counterpart of
smpl_nerf_tpu/parallel/ep.py).

Experts are stacked tiny 2-layer ReLU MLPs (weights [E, ...]) assigned by the
voxel cell of the sample position. Four ways to evaluate the mixture, all with
the same contract (out[i] = MLP_{expert_ids[i]}(x[i])):

  * `expert_apply`: every token gathers its expert's weights (the dense
    reference; differentiable, used by distillation);
  * `expert_apply_bucketed`: sort tokens by expert, scatter them into
    [E, capacity, D] buckets, one batched product per layer;
  * `expert_apply_tiled` (`sorted_tile_plan` + `tiles_apply` + `plan_take`):
    sort tokens by expert and pad each expert's run to a multiple of `tile`,
    so every tile holds one expert's tokens and the weights are gathered once
    per tile. This is the serving path; ops/expert_tiles.py fuses the
    encoding and both layers of `tiles_apply` into one CUDA kernel;
  * `compact_stream`: stable O(N) compaction of the tokens worth routing,
    ahead of the sort.

Shapes are static given (`capacity` | `budget`, `tile`): tokens that do not
fit come back flagged in `overflow` / `n_dropped`, never silently lost. Tokens
with expert id >= E are skipped: zero output, no capacity used, no overflow.

Where JAX scatters with out-of-range indices dropped, the scatters here aim
the dropped writes at one spare slot that is sliced off: torch raises on an
out-of-range index, and a CUDA scatter with duplicate indices is unordered,
so the duplicates are confined to the spare slot and real slots stay unique.
Index tensors are int64; `TilePlan.tile_expert` is int32, as the kernel reads it.

`expert_parallel_apply` is the sharded form over a mesh axis: tokens and
experts split over the axis, tokens routed to the rank that owns their expert
in capacity-bounded buckets, two all_to_alls (there and back), the same skip
and overflow contract. One process per device: each rank passes its own
tokens, and the stacked experts whole (as JAX's global arrays); it evaluates
its own block of them, and the experts' gradient comes back whole on every
rank (summed over the axis), as the pipeline's does (parallel/pp.py).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class ExpertMLP(NamedTuple):
    """Stacked 2-layer ReLU expert MLPs: [E, D, H], [E, H], [E, H, O], [E, O]."""
    w0: torch.Tensor
    b0: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor


def init_experts(generator: torch.Generator, n_experts: int, d_in: int, d_hidden: int,
                 d_out: int, dtype: torch.dtype = torch.float32) -> ExpertMLP:
    """He-normal kernels and zero biases, drawn from `generator` on its device."""
    device = generator.device
    w0 = torch.randn((n_experts, d_in, d_hidden), generator=generator, dtype=dtype,
                     device=device) * math.sqrt(2.0 / d_in)
    w1 = torch.randn((n_experts, d_hidden, d_out), generator=generator, dtype=dtype,
                     device=device) * math.sqrt(2.0 / d_hidden)
    return ExpertMLP(w0, torch.zeros((n_experts, d_hidden), dtype=dtype, device=device),
                     w1, torch.zeros((n_experts, d_out), dtype=dtype, device=device))


def voxel_expert_ids(points: torch.Tensor, aabb_min, aabb_max, grid: int) -> torch.Tensor:
    """Assign each point [N, 3] to a cell of a grid^3 voxel partition of the
    AABB (points outside clamp to the border cell)."""
    lo = torch.as_tensor(aabb_min, dtype=points.dtype, device=points.device)
    hi = torch.as_tensor(aabb_max, dtype=points.dtype, device=points.device)
    u = (points - lo) / (hi - lo)
    # the cast truncates toward zero BEFORE the clip, as JAX's astype(int32) does
    cell = torch.clamp((u * grid).to(torch.int32), 0, grid - 1).long()
    return (cell[..., 0] * grid + cell[..., 1]) * grid + cell[..., 2]


def _mlp(x, w0, b0, w1, b1):
    """Batched over the leading (expert) dim: x [E, C, D] -> [E, C, O]."""
    return torch.relu(x @ w0 + b0[:, None, :]) @ w1 + b1[:, None, :]


def expert_apply(experts: ExpertMLP, x: torch.Tensor, expert_ids: torch.Tensor) -> torch.Tensor:
    """Dense reference: out[i] = MLP_{expert_ids[i]}(x[i]), per-token weight gathers."""
    h = torch.relu(torch.einsum("nd,ndh->nh", x, experts.w0[expert_ids])
                   + experts.b0[expert_ids])
    return torch.einsum("nh,nho->no", h, experts.w1[expert_ids]) + experts.b1[expert_ids]


class EPResult(NamedTuple):
    out: torch.Tensor       # [N, O]; zeros where overflowed
    overflow: torch.Tensor  # [N] bool; True = token did not fit


def _cast(experts: ExpertMLP, dtype: Optional[torch.dtype]) -> ExpertMLP:
    return experts if dtype is None else ExpertMLP(*(w.to(dtype) for w in experts))


def expert_apply_bucketed(experts: ExpertMLP, x: torch.Tensor, expert_ids: torch.Tensor,
                          capacity: int, compute_dtype: Optional[torch.dtype] = None) -> EPResult:
    """Sort + static [E, capacity, D] buckets, one batched product per layer.

    Tokens with expert_ids == E are skipped (zero output, no capacity, no
    overflow). Tokens past `capacity` in their bucket come back in `overflow`.
    `compute_dtype` casts activations and weights for the bucket products; the
    output is cast back to the input dtype.
    """
    E = experts.w0.shape[0]
    N, D = x.shape
    C = int(capacity)
    out_dtype = x.dtype
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    experts = _cast(experts, compute_dtype)
    ar_n = torch.arange(N, device=x.device)
    sorted_ids, order = torch.sort(expert_ids, stable=True)
    starts = torch.searchsorted(sorted_ids, torch.arange(E, device=x.device))      # [E]
    pos = ar_n - starts[torch.clamp(sorted_ids, 0, E - 1)]
    skip = sorted_ids >= E
    keep = (pos < C) & ~skip
    slot_e = torch.where(keep, sorted_ids, torch.full_like(sorted_ids, E))  # E = spare row
    slot_c = torch.clamp(pos, 0, C - 1)
    buckets = torch.zeros((E + 1, C, D), dtype=x.dtype, device=x.device)
    buckets = buckets.index_put((slot_e, slot_c), x[order])[:E]
    out_b = _mlp(buckets, *experts)                                                # [E, C, O]
    out_sorted = out_b[torch.clamp(slot_e, 0, E - 1), slot_c] * keep[:, None].to(out_b.dtype)
    out = torch.zeros((N, out_b.shape[-1]), dtype=out_b.dtype, device=x.device)
    out = out.index_put((order,), out_sorted)
    overflow = torch.zeros((N,), dtype=torch.bool, device=x.device)
    overflow = overflow.index_put((order,), ~keep & ~skip)
    return EPResult(out.to(out_dtype), overflow)


class StreamCompaction(NamedTuple):
    """O(N) stable compaction of a token stream (see `compact_stream`)."""
    src: torch.Tensor        # [K] original token index per compact slot
    pos: torch.Tensor        # [N] compact slot of each original token
    valid: torch.Tensor      # [K] bool: slot holds a real token
    kept: torch.Tensor       # [N] bool: token landed in the compact stream
    n_dropped: torch.Tensor  # [] kept tokens past k_budget (overflow)


def compact_stream(keep: torch.Tensor, k_budget: int) -> StreamCompaction:
    """Stable-compact the tokens where `keep` is True into a static [k_budget]
    stream with one cumsum and one scatter. Tokens past `k_budget` are counted
    in `n_dropped`."""
    N = keep.shape[0]
    device = keep.device
    pos = torch.cumsum(keep.to(torch.int64), 0) - 1                        # [N]
    kept = keep & (pos < k_budget)
    slot = torch.where(kept, pos, torch.full_like(pos, k_budget))          # miss -> spare slot
    src = torch.zeros((k_budget + 1,), dtype=torch.int64, device=device)
    src = src.index_put((slot,), torch.arange(N, device=device))[:k_budget]
    n_keep = keep.sum()
    return StreamCompaction(
        src=src, pos=pos,
        valid=torch.arange(k_budget, device=device) < n_keep,
        kept=kept,
        n_dropped=torch.clamp(n_keep - k_budget, min=0))


class TilePlan(NamedTuple):
    """Static-shape routing plan of `expert_apply_tiled` ([L] = budget or [N]
    arrays). Callers gather their token features with `tok`, run
    `tiles_apply` and map results back with `plan_take`."""
    tok: torch.Tensor          # [L] source token index per padded slot
    valid: torch.Tensor        # [L] bool: slot holds a real token
    tile_expert: torch.Tensor  # [L // tile] int32 expert id per tile
    slot_of: torch.Tensor      # [N] padded slot of each token (garbage if skip)
    take: torch.Tensor         # [N] bool: token is real AND within budget
    overflow: torch.Tensor     # [N] bool: real token past the slot budget


def sorted_tile_plan(expert_ids: torch.Tensor, n_experts: int, budget: int,
                     tile: int = 256) -> TilePlan:
    """Route tokens into a run-padded sorted stream of single-expert tiles.

    Tokens are sorted by expert and each expert's run is padded to a multiple
    of `tile`, so runs start at tile-aligned offsets and every tile holds one
    expert's tokens: slots used = real tokens + at most tile-1 padding per
    non-empty expert. Tokens with expert_ids >= n_experts are skipped (sorted
    last, no slots). `budget` (a multiple of `tile`) bounds the padded stream;
    real tokens past it are flagged in `overflow`. Tiles past the used stream
    carry the last expert's id and only invalid slots.
    """
    if budget % tile:
        raise ValueError(f"budget={budget} must be a multiple of tile={tile}")
    E = n_experts
    N = expert_ids.shape[0]
    device = expert_ids.device
    expert_ids = expert_ids.long()
    sorted_ids, order = torch.sort(expert_ids, stable=True)       # skip ids sort last
    starts = torch.searchsorted(sorted_ids, torch.arange(E + 1, device=device))  # starts[E]=n_real
    counts = starts[1:] - starts[:-1]                             # [E]
    padded = torch.div(counts + tile - 1, tile, rounding_mode="floor") * tile
    pstarts = torch.cat([torch.zeros((1,), dtype=counts.dtype, device=device),
                         torch.cumsum(padded, 0)])                # [E+1], tile-aligned
    n_tiles = budget // tile
    tile_expert = torch.clamp(
        torch.searchsorted(pstarts, torch.arange(n_tiles, device=device) * tile, right=True) - 1,
        0, E - 1)
    e_s = torch.repeat_interleave(tile_expert, tile)              # [L]
    off = torch.arange(budget, device=device) - pstarts[e_s]
    src = starts[e_s] + off
    valid = (off >= 0) & (off < counts[e_s])
    tok = order[torch.clamp(src, 0, N - 1)]
    # inverse map: padded slot of each ORIGINAL token
    inv = torch.zeros((N,), dtype=torch.int64, device=device)
    inv = inv.index_put((order,), torch.arange(N, device=device))
    e_tok = torch.clamp(expert_ids, 0, E - 1)
    slot_of = pstarts[e_tok] + (inv - starts[e_tok])
    real = expert_ids < E
    in_budget = slot_of < budget
    return TilePlan(tok, valid, tile_expert.to(torch.int32), slot_of,
                    take=real & in_budget, overflow=real & ~in_budget)


def tiles_apply(experts: ExpertMLP, x_slots: torch.Tensor, plan: TilePlan,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Evaluate the tiled mixture: x_slots [L, D] (features already gathered
    into plan order, e.g. x[plan.tok]) -> [L, O]. Weights are gathered once
    per tile; invalid slots are zeroed on input and output. Differentiable in
    the experts (fine-tuning trains through it)."""
    out_dtype = x_slots.dtype
    if compute_dtype is not None:
        x_slots = x_slots.to(compute_dtype)
    experts = _cast(experts, compute_dtype)
    L, D = x_slots.shape
    te = plan.tile_expert.long()
    n_tiles = te.shape[0]
    xt = (x_slots * plan.valid[:, None].to(x_slots.dtype)).reshape(n_tiles, L // n_tiles, D)
    o = _mlp(xt, experts.w0[te], experts.b0[te], experts.w1[te], experts.b1[te])
    o = o.reshape(L, o.shape[-1])
    return (o * plan.valid[:, None].to(o.dtype)).to(out_dtype)


def plan_take(plan: TilePlan, out_slots: torch.Tensor) -> torch.Tensor:
    """Map tiled outputs [L, O] back to token order [N, O] (zeros for skipped
    or over-budget tokens)."""
    L = out_slots.shape[0]
    out = out_slots[torch.clamp(plan.slot_of, 0, L - 1)]
    return out * plan.take[:, None].to(out.dtype)


def expert_apply_tiled(experts: ExpertMLP, x: torch.Tensor, expert_ids: torch.Tensor,
                       budget: int, tile: int = 256,
                       compute_dtype: Optional[torch.dtype] = None) -> EPResult:
    """Drop-in for `expert_apply_bucketed` through the sorted-tile plan: same
    contract (skip id == E, overflow flagged), no [E, capacity] tensor."""
    plan = sorted_tile_plan(expert_ids, experts.w0.shape[0], budget, tile)
    out_slots = tiles_apply(experts, x[plan.tok], plan, compute_dtype=compute_dtype)
    return EPResult(plan_take(plan, out_slots), plan.overflow)


class _AllToAll(torch.autograd.Function):
    """all_to_all over dim 0 ([n, ...]: block i goes to rank i, block i of the
    result came from rank i); its transpose is the same exchange."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    ins = list(t.contiguous().unbind(0))
    outs = [torch.empty_like(b) for b in ins]
    dist.all_to_all(outs, [b.contiguous() for b in ins], group=group)
    return torch.stack(outs)


def expert_parallel_apply(mesh, experts: ExpertMLP, x: torch.Tensor, expert_ids: torch.Tensor,
                          capacity: int, axis: str = "model") -> EPResult:
    """MoE-routed expert evaluation with experts and tokens split over `axis`.

    x [N_l, D] / expert_ids [N_l]: this rank's tokens; experts: the stacked
    experts whole [E, ...], of which rank j evaluates block j (E / n of them).
    `capacity` bounds the tokens per (source rank, expert) bucket; E must
    divide by the axis size. Tokens with expert_ids == E are skipped (zero
    output, overflow False, no capacity); tokens past the capacity come back
    flagged in `overflow` with zero output. Returns this rank's tokens.
    Ranking within a bucket is expert_apply_bucketed's sort / searchsorted.
    """
    from smpl_nerf_tpu_torch.parallel import tp
    group, j, n = mesh.axis(axis)
    E = experts.w0.shape[0]
    n_l, D = x.shape
    O = experts.w1.shape[-1]
    if E % n:
        raise ValueError(f"E={E} and N={n_l * n} must divide the {n}-way axis")
    e_local, C = E // n, int(capacity)
    if group is not None:      # the experts' gradient summed over the axis: whole everywhere
        experts = ExpertMLP(*(tp.copy_to_model(w, group) for w in experts))
    own = ExpertMLP(*(w[j * e_local:(j + 1) * e_local] for w in experts))
    device = x.device
    ids = expert_ids.long()
    sorted_ids, order = torch.sort(ids, stable=True)
    starts = torch.searchsorted(sorted_ids, torch.arange(E, device=device))
    pos_sorted = torch.arange(n_l, device=device) - starts[torch.clamp(sorted_ids, 0, E - 1)]
    pos = torch.zeros((n_l,), dtype=torch.int64, device=device).index_put((order,), pos_sorted)
    skip = ids >= E
    keep = (pos < C) & ~skip
    slot_e = torch.where(keep, ids, torch.full_like(ids, E))       # E = spare row
    slot_c = torch.clamp(pos, 0, C - 1)
    buckets = torch.zeros((E + 1, C, D), dtype=x.dtype, device=device)
    buckets = buckets.index_put((slot_e, slot_c), x)[:E]
    send = buckets.reshape(n, e_local, C, D)
    recv = send if group is None else _AllToAll.apply(send, group)   # [n, e_local, C, D]
    toks = recv.transpose(0, 1).reshape(e_local, n * C, D)
    out_tok = _mlp(toks, *own)                                       # [e_local, n*C, O]
    back = out_tok.reshape(e_local, n, C, O).transpose(0, 1)
    got = back if group is None else _AllToAll.apply(back, group)    # [n, e_local, C, O]
    got = got.reshape(E, C, O)
    out = got[torch.clamp(slot_e, 0, E - 1), slot_c] * keep[:, None].to(x.dtype)
    return EPResult(out, ~keep & ~skip)
