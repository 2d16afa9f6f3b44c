"""Kernels A (sample_pdf) and E (expert tiles) as they are scheduled on the
card, emulated step by step on the CPU, against the count rule, the plain
versions and the JAX package's Pallas kernels in interpret mode.

A (numpy, csrc/sample_pdf.cu): one warp per ray. Lane l runs the contiguous
entries [l*C, l*C+C) of the pdf in order (C the least power of two with
32*C >= K-1), a shuffle scan of the lanes' totals gives each lane its offset,
and every entry is raised to the largest last entry of the lanes before it
(a shuffle max-scan), so the cdf is non-decreasing whatever the rounding.
The inversion is a merge: lane l binary-searches the upper bound of its
first sample's u, then walks forward through its run of samples. On a
non-decreasing cdf that gives exactly #{k : cdf_k <= u}, ties included, which
the tests hold on cdfs with runs of equal entries (empty bins, and steps
below an ulp of the running sum) and with u landing exactly on entries.

E (torch, csrc/expert_tiles.cu, bf16 path): each lane's registers are built
with the kernel's formulas (which columns of which rows a lane encodes, in
the kernel's column order with the sines first, where the staging puts each
weight in the B-fragment order, how layer 1's accumulators become layer 2's
A fragment, which lane stores which outputs) and read back through the
layouts of mma.m16n8k16 as PTX defines them; the products per k16 step are
float32 sums of exact products, as the tensor cores' are. The encoding the
lanes assemble must equal the plain version's, columns reordered, bit for
bit.

Tolerances: A's samples match the Pallas kernel to 2e-4 (the bound of
tests/test_torch_port_ops.py: where u equals a cdf entry to float precision
the two cumsums put the sample one bin apart, which moves it by a fraction of
a bin). Against the plain version with empty bins, at most one bin (the
widest), and every sample off by more than 2e-4 is such a flip: its u lies
within the two cdfs' difference of an entry. (The card holds the kernel to a
share of such samples, 0.5 %, over 2048 rays; a few rays of two samples
cannot.) E in float32
follows the plain version up to the order of float32 sums (1e-5 of the
largest output); in bf16 the same holds (2e-6) outside the rows where the
two orders round a hidden activation to different bf16 values. Against the
Pallas kernel 2e-5 in float32 and 5e-2 in bf16, as
tests/test_torch_port_experts.py holds the plain version.
"""
import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smpl_nerf_tpu.ops.expert_tiles_pallas import expert_tiles_forward as j_expert_tiles
from smpl_nerf_tpu.ops.sample_pdf_pallas import sample_pdf_fused as jax_sample_pdf_fused
from smpl_nerf_tpu.parallel import ep as jep
from smpl_nerf_tpu_torch.core import sampling
from smpl_nerf_tpu_torch.ops import expert_tiles
from smpl_nerf_tpu_torch.parallel import ep

PDF_ATOL = 2e-4
F32 = np.float32
HALF_PI = np.float32(np.pi / 2)

# ------------------------------------------------------------------ kernel A


def lane_chunk(n: int) -> int:
    c = 1
    while 32 * c < n:
        c *= 2
    return c


def shift_up(x, by, fill):
    """__shfl_up_sync over the lane axis (last), lanes below `by` keep `fill`."""
    out = np.full_like(x, fill)
    out[..., by:] = x[..., :-by]
    return out


def monotone_cdf(weights: np.ndarray) -> np.ndarray:
    """The kernel's cdf [R, K] from weights [R, K-1], in float32 step by step."""
    R, n = weights.shape
    C = lane_chunk(n)
    idx = np.arange(32)[:, None] * C + np.arange(C)[None, :]          # [32, C] entry index
    live = idx < n
    v = np.zeros((R, 32, C), F32)
    v[:, live] = (weights[:, idx[live]] + F32(1e-5)).astype(F32)
    part = np.zeros((R, 32), F32)
    for i in range(C):
        part = part + v[:, :, i]
    for o in (16, 8, 4, 2, 1):                                          # xor butterfly
        part = part + part[:, np.arange(32) ^ o]
    total = part[:, :1]                                                 # lane 0's, broadcast
    s = np.zeros((R, 32), F32)
    for i in range(C):
        s = np.where(live[None, :, i], s + v[:, :, i] / total, s).astype(F32)
        v[:, :, i] = s
    incl = s.copy()
    for o in (1, 2, 4, 8, 16):
        incl = np.where(np.arange(32) >= o, incl + shift_up(incl, o, 0), incl).astype(F32)
    offset = shift_up(incl, 1, 0)
    top = (offset + s).astype(F32)
    for o in (1, 2, 4, 8, 16):
        top = np.where(np.arange(32) >= o, np.maximum(top, shift_up(top, o, -np.inf)), top)
    floor_below = shift_up(top, 1, 0).astype(F32)
    cdf = np.zeros((R, n + 1), F32)
    entries = np.maximum((offset[:, :, None] + v).astype(F32), floor_below[:, :, None])
    cdf[:, 1 + idx[live]] = entries[:, live]
    return cdf


def run_length(F: int) -> int:
    per_lane = -(-F // 32)
    return (per_lane + 3) // 4 * 4 if F % 4 == 0 else per_lane


def merge_inds(cdf: np.ndarray, F: int) -> np.ndarray:
    """inds [R, F] as the lanes find them: bisect the first sample, then walk."""
    R, K = cdf.shape
    P = run_length(F)
    u_step = F32(1) / F32(max(F - 1, 1))
    inds = np.full((R, F), -1)
    for lane in range(32):
        f0 = lane * P
        if f0 >= F:
            break
        u = F32(f0) * u_step
        lo, hi = np.zeros(R, int), np.full(R, K)
        while (lo < hi).any():
            act = lo < hi
            mid = (lo + hi) >> 1
            le = cdf[np.arange(R), np.minimum(mid, K - 1)] <= u
            lo = np.where(act & le, mid + 1, lo)
            hi = np.where(act & ~le, mid, hi)
        ind = lo
        for f in range(f0, min(f0 + P, F)):
            u = F32(f) * u_step
            while True:
                step = (ind < K) & (cdf[np.arange(R), np.minimum(ind, K - 1)] <= u)
                if not step.any():
                    break
                ind = ind + step
            inds[:, f] = ind
    return inds


def count_inds(cdf: np.ndarray, F: int) -> np.ndarray:
    u = (np.arange(F, dtype=F32) * (F32(1) / F32(max(F - 1, 1)))).astype(F32)
    return (cdf[:, None, :] <= u[None, :, None]).sum(-1)


def merge_samples(bins: np.ndarray, weights: np.ndarray, F: int) -> tuple:
    cdf = monotone_cdf(weights)
    inds = merge_inds(cdf, F)
    K = cdf.shape[1]
    u = (np.arange(F, dtype=F32) * (F32(1) / F32(max(F - 1, 1)))).astype(F32)[None, :]
    below, above = np.maximum(inds - 1, 0), np.minimum(inds, K - 1)
    c0, c1 = np.take_along_axis(cdf, below, 1), np.take_along_axis(cdf, above, 1)
    b0, b1 = np.take_along_axis(bins, below, 1), np.take_along_axis(bins, above, 1)
    denom = (c1 - c0).astype(F32)
    denom = np.where(denom < F32(1e-5), F32(1), denom)
    t = ((u - c0) / denom).astype(F32)
    return (b0 + (t * (b1 - b0)).astype(F32)).astype(F32), cdf, inds


def _pdf_inputs(rng, R, K, empty):
    bins = np.sort(rng.uniform(1, 4, (R, K)).astype(F32), -1)
    weights = rng.uniform(0, 1, (R, K - 1)).astype(F32)
    weights[rng.uniform(size=weights.shape) < empty] = 0.0
    # a few heavy rays: their empty bins step by less than an ulp of the sum
    weights[: R // 4] *= F32(1e4)
    return bins, weights


PDF_K = (2, 3, 63, 64, 65, 1024)
PDF_F = (1, 2, 31, 128, 257)


@pytest.mark.parametrize("K", PDF_K)
@pytest.mark.parametrize("F", PDF_F)
def test_merge_inversion_is_the_count_rule_on_cdfs_with_ties(rng, K, F):
    """Non-decreasing cdfs built from the u grid itself plus random values,
    with runs of equal entries: every u of the grid lands on some entries."""
    R = 24
    u = np.arange(F, dtype=F32) * (F32(1) / F32(max(F - 1, 1)))
    pool = np.concatenate([u, rng.uniform(0, 1, 8).astype(F32), [F32(0), F32(1)]])
    cdf = np.sort(rng.choice(pool, (R, K)), -1).astype(F32)
    cdf[:, 0] = 0.0
    cdf[R // 2:, K // 2:] = cdf[R // 2:, K // 2:K // 2 + 1]     # long runs of one value
    np.testing.assert_array_equal(merge_inds(cdf, F), count_inds(cdf, F))


@pytest.mark.parametrize("K", PDF_K)
@pytest.mark.parametrize("F", PDF_F)
def test_monotone_scan_and_merge_match_the_count_rule_and_the_plain_version(rng, K, F):
    bins, weights = _pdf_inputs(rng, 32, K, empty=0.3)
    got, cdf, inds = merge_samples(bins, weights, F)
    assert (np.diff(cdf, axis=-1) >= 0).all()
    assert cdf[:, 0].max() == 0.0 and np.abs(cdf[:, -1] - 1).max() <= 1e-5
    want_cdf = np.concatenate([np.zeros((32, 1)), np.cumsum(
        (weights + F32(1e-5)).astype(np.float64) / (weights + F32(1e-5)).sum(-1, keepdims=True),
        -1)], -1)
    assert np.abs(cdf - want_cdf).max() <= 1e-5
    np.testing.assert_array_equal(inds, count_inds(cdf, F))
    want = sampling.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), F).numpy()
    err = np.abs(got - want)
    assert err.max() <= np.diff(bins, axis=-1).max()
    # a sample off by more than 2e-4 is a flip: its u lies within the two
    # cdfs' difference of an entry, so the two counts can differ there
    w = torch.from_numpy(weights) + 1e-5
    plain_cdf = torch.cat([torch.zeros(32, 1), torch.cumsum(w / w.sum(-1, keepdim=True), -1)],
                          -1).numpy()
    gap = np.abs(plain_cdf - cdf).max(-1, keepdims=True)                     # per ray
    u = (np.arange(F, dtype=F32) * (F32(1) / F32(max(F - 1, 1)))).astype(F32)
    nearest = np.abs(u[None, :, None] - cdf[:, None, :]).min(-1)              # [R, F]
    off = err > PDF_ATOL
    assert (nearest[off] <= np.broadcast_to(gap, off.shape)[off]).all()


@pytest.mark.parametrize("K", [k for k in PDF_K if k <= 65])
@pytest.mark.parametrize("F", [f for f in PDF_F if f >= 2])
def test_monotone_scan_and_merge_match_the_pallas_kernel_in_interpret_mode(rng, K, F):
    """The Pallas kernel unrolls its K loops at trace time and divides by F-1,
    so K <= 65 and F >= 2 here; larger K and F = 1 are held to the plain
    version above."""
    bins, weights = _pdf_inputs(rng, 16, K, empty=0.0)
    got, _, _ = merge_samples(bins, weights, F)
    want = np.asarray(jax_sample_pdf_fused(jnp.asarray(bins), jnp.asarray(weights), F))
    np.testing.assert_allclose(got, want, atol=PDF_ATOL)


# ------------------------------------------------------------------ kernel E

LANE = torch.arange(32)
G, T = LANE // 4, LANE % 4


def a_position(reg, half):
    """(row, col) of an A element (m16 x k16) held by each lane: PTX's layout."""
    return G + 8 * (reg % 2), 2 * T + half + 8 * (reg // 2)


def b_position(reg, half):
    """(k, n) of a B element (k16 x n8) held by each lane."""
    return 2 * T + half + 8 * reg, G


def c_position(i):
    """(row, col) of accumulator element i (m16 x n8) of each lane."""
    return G + 8 * (i // 2), 2 * T + i % 2


def fragment_half(k, n, n_tiles):
    """The kernel's staging: half-word slot of B element (k, n)."""
    kk = k % 16
    lane = 4 * (n % 8) + (kk % 8) // 2
    return (((k // 16) * n_tiles + n // 8) * 32 + lane) * 4 + (kk // 8) * 2 + kk % 2


def stage_b(w, k_pad, n_pad, cdt):
    """Stage a [k, n] weight as the kernel does (zero padding, rounded), then
    read each k16 x n8 step's fragments back through PTX's B layout."""
    n_tiles = n_pad // 8
    flat = torch.zeros(k_pad * n_pad, dtype=torch.float32)
    k, n = torch.meshgrid(torch.arange(k_pad), torch.arange(n_pad), indexing="ij")
    padded = torch.zeros(k_pad, n_pad)
    padded[:w.shape[0], :w.shape[1]] = w
    flat[fragment_half(k, n, n_tiles).reshape(-1)] = padded.to(cdt).float().reshape(-1)
    steps = torch.zeros(k_pad // 16, n_tiles, 16, 8)
    for s in range(k_pad // 16):
        for nt in range(n_tiles):
            for reg in range(2):                  # the lane's 64-bit load, two registers
                for half in range(2):
                    kb, nb = b_position(reg, half)
                    steps[s, nt, kb, nb] = flat[((s * n_tiles + nt) * 32 + LANE) * 4
                                                + 2 * reg + half]
    return steps


def original_column(c, np_, ns):
    """The kernel's column order (sines first) -> the plain version's column."""
    return np.where(c < np_, 3 + c, np.where(c < ns, 6 + c, np.where(c < ns + 3, c - ns,
                                                                     c - ns + np_)))


def encoded_columns(p, q, cols, l_pos, D):
    """The kernel's `encode_group` for rows (p, q) [N, 3] at kernel columns
    cols [N]: [sines of local | sines of dirs | local | dirs | zeros]."""
    np_, ns = 6 * l_pos, D - 6

    def sin_block(x, c):
        k, within = c // 6, c % 6
        t = x.gather(1, (within % 3)[:, None])[:, 0] * (2.0 ** k).float()
        t = torch.where(within >= 3, t + torch.tensor(HALF_PI), t)
        return torch.sin(t)

    out = torch.where(cols < np_, sin_block(p, cols.clamp(max=max(np_ - 1, 0))),
                      sin_block(q, (cols - np_).clamp(min=0)))
    j = (cols - ns).clamp(0, 5)
    ident = torch.where(j < 3, p.gather(1, j.clamp(max=2)[:, None])[:, 0],
                        q.gather(1, (j - 3).clamp(min=0)[:, None])[:, 0])
    out = torch.where(cols >= ns, ident, out)
    return torch.where(cols < D, out, torch.zeros(()))


def emulate_expert_tiles(experts, local, dirs, valid, tile_expert, *, l_pos, l_dir, tile,
                         compute_dtype=torch.bfloat16):
    """Kernel E's mma schedule, tile by tile and m-tile by m-tile. Returns the
    output [L, O], each tile's assembled encoding [L, KS*16] and the float32
    hidden activations before rounding [L, Hp]."""
    cdt = torch.float32 if compute_dtype is None else compute_dtype
    w0, b0, w1, b1 = experts
    E, D, H = w0.shape
    O = w1.shape[-1]
    L = local.shape[0]
    KS, Hp = -(-D // 16), -(-H // 32) * 32
    out = torch.full((L, O), float("nan"))
    enc_all = torch.zeros(L, KS * 16)
    hidden_all = torch.zeros(L, Hp)
    for ti in range(L // tile):
        base = ti * tile
        if not bool(valid[base:base + tile].any()):
            out[base:base + tile] = 0.0
            continue
        e = int(tile_expert[ti].clamp(0, E - 1))
        order = original_column(np.arange(D), 6 * l_pos, D - 6)   # w0's rows, kernel order
        B0 = stage_b(w0[e][order], KS * 16, Hp, cdt)              # [KS, Hp/8, 16, 8]
        B1 = stage_b(w1[e], Hp, 8, cdt)                           # [Hp/16, 1, 16, 8]
        bias0 = torch.zeros(Hp)
        bias0[:H] = b0[e]
        bias1 = torch.zeros(8)
        bias1[:O] = b1[e]
        for row0 in range(0, tile, 16):
            rows = row0 + torch.arange(16)
            in_tile = rows < tile
            ok = in_tile & valid[(base + rows).clamp(max=L - 1)]
            if not bool(ok.any()):
                out[base + rows[in_tile]] = 0.0
                continue
            # each lane's A registers: rows g, g+8; columns 16s + 8h + 2t, +1
            slot_of = lambda r: (base + row0 + r).clamp(max=L - 1)   # noqa: E731
            A = torch.zeros(KS, 16, 16)
            for s in range(KS):
                for reg in range(4):
                    h, row_sel = reg // 2, reg % 2
                    lane_rows = G + 8 * row_sel
                    live = (row0 + lane_rows) < tile
                    p = torch.where(live[:, None], local[slot_of(lane_rows)], torch.zeros(()))
                    q = torch.where(live[:, None], dirs[slot_of(lane_rows)], torch.zeros(()))
                    for half in range(2):
                        col = 16 * s + 8 * h + 2 * T + half
                        value = encoded_columns(p, q, col, l_pos, D).to(cdt).float()
                        r_, c_ = a_position(reg, half)
                        A[s, r_, c_] = value
            enc_all[base + rows[in_tile]] = A.permute(1, 0, 2).reshape(16, -1)[in_tile]
            acc2 = torch.zeros(16, 8)
            for hc in range(Hp // 32):
                acc = torch.zeros(4, 16, 8)
                for s in range(KS):
                    for j in range(4):
                        acc[j] = acc[j] + A[s] @ B0[s, hc * 4 + j]
                hidden = torch.cat([acc[j] + bias0[hc * 32 + 8 * j:hc * 32 + 8 * j + 8]
                                    for j in range(4)], -1)
                hidden_all[base + rows[in_tile], hc * 32:hc * 32 + 32] = hidden[in_tile]
                # accumulator registers of n8 tiles 2j2, 2j2+1 -> layer 2's A of step j2
                for j2 in range(2):
                    A2 = torch.zeros(16, 16)
                    for j in (2 * j2, 2 * j2 + 1):
                        for row_sel in range(2):
                            reg = 2 * (j % 2) + row_sel
                            for half in range(2):
                                cr, cc = c_position(2 * row_sel + half)
                                value = torch.relu(acc[j][cr, cc] + bias0[hc * 32 + 8 * j + cc])
                                r_, c_ = a_position(reg, half)
                                A2[r_, c_] = value.to(cdt).float()
                    acc2 = acc2 + A2 @ B1[hc * 2 + j2, 0]
            # outputs of rows g (elements 0, 1) and g + 8 (2, 3), + b1, masked;
            # lane t=0 stores row g, t=1 row g+8, each with its partner's half
            lane_out = torch.zeros(32, 4)
            for i in range(4):
                cr, cc = c_position(i)
                lane_out[:, i] = torch.where(ok[cr], acc2[cr, cc] + bias1[cc], torch.zeros(()))
            partner = LANE ^ 1
            send = torch.where((T % 2 == 1)[:, None], lane_out[:, :2], lane_out[:, 2:])
            got = send[partner]
            for lane in range(32):
                g, t = int(G[lane]), int(T[lane])
                if t == 0 and row0 + g < tile:
                    row = torch.cat([lane_out[lane, :2], got[lane]])
                    out[base + row0 + g] = row[:O]
                if t == 1 and row0 + g + 8 < tile:
                    row = torch.cat([got[lane], lane_out[lane, 2:]])
                    out[base + row0 + g + 8] = row[:O]
    return out, enc_all, hidden_all


def _plan(rng, E, n_tokens, tile, budget, all_invalid):
    ids = rng.randint(0, E + 1, n_tokens)                      # E = skip-routed
    plan = ep.sorted_tile_plan(torch.as_tensor(ids), E, budget, tile)
    valid = plan.valid.clone()
    if all_invalid:
        valid[:] = False
    local = torch.tensor(rng.uniform(0, 1, (budget, 3)).astype(F32))
    d = rng.randn(budget, 3).astype(F32)
    dirs = torch.tensor(d / np.linalg.norm(d, axis=-1, keepdims=True))
    return plan, valid, local, dirs


E_CASES = {   # l_pos, l_dir, H, O, E, tile, tokens, budget, all_invalid
    "D42": (4, 2, 32, 4, 27, 32, 300, 1024, False),
    "D30_tile8": (3, 1, 16, 4, 27, 8, 200, 512, False),
    "H20": (4, 2, 20, 4, 27, 64, 300, 1536, False),
    "O3": (3, 1, 16, 3, 27, 32, 300, 1024, False),
    "E1_tile24": (4, 2, 32, 4, 1, 24, 100, 240, False),
    "all_invalid": (3, 1, 16, 4, 27, 32, 100, 512, True),
}


@pytest.mark.parametrize("case", list(E_CASES))
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_expert_tiles_schedule_matches_the_plain_version_and_the_pallas_kernel(rng, case,
                                                                               dtype):
    l_pos, l_dir, H, O, E, tile, n_tokens, budget, all_invalid = E_CASES[case]
    D = expert_tiles.encoded_dim(l_pos, l_dir)
    ws = (rng.randn(E, D, H).astype(F32) * 0.3, rng.randn(E, H).astype(F32) * 0.1,
          rng.randn(E, H, O).astype(F32) * 0.3, rng.randn(E, O).astype(F32) * 0.1)
    experts = ep.ExpertMLP(*(torch.tensor(w) for w in ws))
    plan, valid, local, dirs = _plan(rng, E, n_tokens, tile, budget, all_invalid)
    kw = dict(l_pos=l_pos, l_dir=l_dir, tile=tile, compute_dtype=dtype)
    got, enc, hidden = emulate_expert_tiles(experts, local, dirs, valid, plan.tile_expert, **kw)
    want = expert_tiles.expert_tiles_reference(experts, local, dirs, valid, plan.tile_expert,
                                               **kw)
    assert not bool(torch.isnan(got).any())           # every slot written
    assert bool((got[~valid] == 0).all())
    assert bool(valid.any()) != all_invalid
    cdt = torch.float32 if dtype is None else dtype
    # the encoding the lanes assemble is the plain version's, bit for bit
    ref_enc = torch.cat([expert_tiles._encode_block(local, l_pos),
                         expert_tiles._encode_block(dirs, l_dir)], -1).to(cdt).float()
    computed = torch.zeros(local.shape[0], dtype=torch.bool)
    for ti in range(local.shape[0] // tile):
        if bool(valid[ti * tile:(ti + 1) * tile].any()):
            for row0 in range(0, tile, 16):
                rows = ti * tile + torch.arange(row0, min(row0 + 16, tile))
                if bool(valid[rows].any()):
                    computed[rows] = True
    order = original_column(np.arange(D), 6 * l_pos, D - 6)
    assert sorted(order.tolist()) == list(range(D))
    torch.testing.assert_close(enc[computed, :D], ref_enc[computed][:, order], rtol=0, atol=0)
    assert bool((enc[:, D:] == 0).all())
    if dtype is None:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * max(1.0, float(want.abs().max())))
    else:
        # rows where the two float32 sums round a hidden unit to another bf16 value
        w0r = experts.w0.to(cdt).float()[plan.tile_expert.long().clamp(0, E - 1)]
        ref_hidden = (ref_enc.view(-1, tile, D) @ w0r
                      + experts.b0[plan.tile_expert.long().clamp(0, E - 1)][:, None, :]
                      ).reshape(-1, H)
        flips = (torch.relu(hidden[:, :H]).to(cdt) != torch.relu(ref_hidden).to(cdt)).any(-1)
        same = computed & ~flips
        assert int(same.sum()) >= int(computed.sum()) // 2
        torch.testing.assert_close(got[same], want[same], rtol=0, atol=2e-6)
    j_experts = jep.ExpertMLP(*(jnp.asarray(w) for w in ws))
    j_want = j_expert_tiles(j_experts, jnp.asarray(local.numpy()), jnp.asarray(dirs.numpy()),
                            jnp.asarray(valid.numpy()), jnp.asarray(plan.tile_expert.numpy()),
                            l_pos=l_pos, l_dir=l_dir, tile=tile,
                            compute_dtype=None if dtype is None else jnp.bfloat16,
                            interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_want),
                               **(dict(atol=2e-5, rtol=2e-5) if dtype is None
                                  else dict(atol=5e-2)))
