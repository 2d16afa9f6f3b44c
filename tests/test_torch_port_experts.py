"""The port's distilled-expert layer against the JAX package, on the CPU.

Inputs and weights are made with numpy from a seed and handed to both sides:
`parallel/ep.py` function by function (routing plans field by field,
exactly), the plain version of kernel E against the Pallas kernel in
interpret mode, the serving forms of `render/experts.py`, occupancy and
compaction (exact), one injected-batch Adam step of distillation and of
fine-tuning, the scores, and a `field.npz` written by the JAX side.

Tolerances: float32 paths differ only in summation order (2e-5, the JAX
package's own bound for its kernel, and 1e-4 on rendered rgb). bf16 paths
round at the same places on both sides, but a sum taken in another order can
flip one bf16 rounding (2^-8 relative), which a second layer carries on:
5e-2 absolute on outputs of order 1. The training steps take three injected batches
in a row: each step's loss (1e-5 relative) and gradients (1e-4 relative plus
1e-5 of the tensor's largest gradient, for the summation order) are compared
directly, since a first Adam step alone moves every weight by lr whatever the
gradient's size. The weights after the three steps are held to 2 % of lr:
where a gradient is tiny against Adam's eps the two frameworks' last bits show.
"""
import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smpl_nerf_tpu.evaluation import scores as jscores
from smpl_nerf_tpu.ops.expert_tiles_pallas import expert_tiles_forward as j_expert_tiles
from smpl_nerf_tpu.parallel import ep as jep
from smpl_nerf_tpu.render import experts as jex
from smpl_nerf_tpu_torch.evaluation import scores
from smpl_nerf_tpu_torch.ops import expert_tiles
from smpl_nerf_tpu_torch.parallel import ep
from smpl_nerf_tpu_torch.render import experts as ex

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_ATOL = 5e-2
RGB_ATOL = 1e-4


def _experts_np(rng, E, D, H, O=4):
    return (rng.randn(E, D, H).astype(np.float32) * 0.3, rng.randn(E, H).astype(np.float32) * 0.1,
            rng.randn(E, H, O).astype(np.float32) * 0.3, rng.randn(E, O).astype(np.float32) * 0.1)


def _both_experts(rng, E, D, H, O=4):
    ws = _experts_np(rng, E, D, H, O)
    return (ep.ExpertMLP(*(torch.tensor(w) for w in ws)),
            jep.ExpertMLP(*(jnp.asarray(w) for w in ws)))


def _both_fields(rng, grid=3, hidden=16, l_pos=3, l_dir=1):
    t, j = _both_experts(rng, grid ** 3, ex.encoded_dim(l_pos, l_dir), hidden)
    lo, hi = np.float32([-1.0, -0.9, -1.1]), np.float32([1.0, 1.1, 0.9])
    return (ex.ExpertField(t, torch.tensor(lo), torch.tensor(hi), grid, l_pos, l_dir),
            jex.ExpertField(j, jnp.asarray(lo), jnp.asarray(hi), grid, l_pos, l_dir))


def _points(rng, n, span=1.3):
    pos = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    return pos, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _t(*arrays):
    return tuple(torch.tensor(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _same(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if tol:
        np.testing.assert_allclose(got, np.asarray(want), **tol)
    else:
        np.testing.assert_array_equal(got, np.asarray(want))


# ------------------------------------------------------------------ parallel/ep

def test_init_experts_is_he_normal_with_zero_biases_on_the_generators_device():
    e = ep.init_experts(torch.Generator().manual_seed(3), 50, 42, 32, 4)
    assert [tuple(w.shape) for w in e] == [(50, 42, 32), (50, 32), (50, 32, 4), (50, 4)]
    assert float(e.b0.abs().max()) == 0.0 and float(e.b1.abs().max()) == 0.0
    assert float(e.w0.std()) == pytest.approx(np.sqrt(2 / 42), rel=0.02)
    assert float(e.w1.std()) == pytest.approx(np.sqrt(2 / 32), rel=0.05)
    again = ep.init_experts(torch.Generator().manual_seed(3), 50, 42, 32, 4)
    assert torch.equal(e.w0, again.w0)


def test_voxel_expert_ids_match_jax_inside_outside_and_on_the_border(rng):
    pos, _ = _points(rng, 500, span=1.6)
    pos[:6] = [[-1, -1, -1], [1, 1, 1], [-1.00001, 0, 0], [0.99999, 0, 0], [0, 0, 0], [5, -5, 0.3]]
    lo, hi = np.float32([-1, -1, -1]), np.float32([1, 1, 1])
    for grid in (1, 4, 7):
        got = ep.voxel_expert_ids(torch.tensor(pos), lo, hi, grid)
        _same(got, jep.voxel_expert_ids(jnp.asarray(pos), lo, hi, grid))
        assert got.dtype == torch.int64


def test_expert_apply_matches_jax(rng):
    t, j = _both_experts(rng, 11, 9, 6, 3)
    x = rng.randn(200, 9).astype(np.float32)
    ids = rng.randint(0, 11, 200)
    _same(ep.expert_apply(t, *_t(x, ids)), jep.expert_apply(j, *_j(x, ids)), **F32_TOL)


@pytest.mark.parametrize("capacity", [40, 6])       # 6: some tokens overflow
def test_expert_apply_bucketed_matches_jax_with_skips_and_overflow(rng, capacity):
    E = 9
    t, j = _both_experts(rng, E, 7, 5, 4)
    x = rng.randn(150, 7).astype(np.float32)
    ids = rng.randint(0, E + 1, 150)                # E = the skip id
    got = ep.expert_apply_bucketed(t, *_t(x, ids), capacity)
    want = jep.expert_apply_bucketed(j, *_j(x, ids), capacity)
    _same(got.overflow, want.overflow)
    _same(got.out, want.out, **F32_TOL)
    assert bool(got.overflow.any()) == (capacity == 6)
    assert not bool(got.overflow[torch.tensor(ids) == E].any())
    assert float(got.out[torch.tensor(ids) == E].abs().max()) == 0.0
    # against the dense form where nothing overflowed
    keep = ~got.overflow & (torch.tensor(ids) < E)
    dense = ep.expert_apply(t, torch.tensor(x)[keep], torch.tensor(ids)[keep])
    _same(got.out[keep], dense.numpy(), **F32_TOL)


def test_expert_apply_bucketed_bf16_is_close_to_jax_and_keeps_the_input_dtype(rng):
    t, j = _both_experts(rng, 5, 8, 6, 4)
    x = rng.randn(60, 8).astype(np.float32)
    ids = rng.randint(0, 6, 60)
    got = ep.expert_apply_bucketed(t, *_t(x, ids), 30, compute_dtype=torch.bfloat16)
    want = jep.expert_apply_bucketed(j, *_j(x, ids), 30, compute_dtype=jnp.bfloat16)
    assert got.out.dtype == torch.float32
    _same(got.out, want.out, atol=BF16_ATOL)


@pytest.mark.parametrize("k_budget", [64, 10])      # 10: the stream overflows
def test_compact_stream_matches_jax_field_by_field(rng, k_budget):
    keep = rng.uniform(size=100) < 0.3
    got = ep.compact_stream(torch.tensor(keep), k_budget)
    want = jep.compact_stream(jnp.asarray(keep), k_budget)
    assert int(got.n_dropped) == int(want.n_dropped) == max(int(keep.sum()) - k_budget, 0)
    _same(got.pos, want.pos)
    _same(got.valid, want.valid)
    _same(got.kept, want.kept)
    n_valid = int(got.valid.sum())
    _same(got.src[:n_valid], np.asarray(want.src)[:n_valid])    # slots past it hold no token
    _same(got.src[:n_valid], np.flatnonzero(keep)[:n_valid])


@pytest.mark.parametrize("tile,budget", [(8, 512), (32, 896), (8, 64)])   # 64: over budget
def test_sorted_tile_plan_matches_jax_field_by_field(rng, tile, budget):
    E = 27
    ids = rng.randint(0, E + 1, 300)
    ids[rng.uniform(size=300) < 0.3] = E             # skipped tokens
    ids[ids == 5] = 6                                # an empty expert
    got = ep.sorted_tile_plan(torch.tensor(ids), E, budget, tile)
    want = jep.sorted_tile_plan(jnp.asarray(ids), E, budget, tile)
    for name in got._fields:
        _same(getattr(got, name), getattr(want, name))
    assert got.tile_expert.dtype == torch.int32
    assert bool(got.overflow.any()) == (budget == 64)
    with pytest.raises(ValueError, match="multiple of tile"):
        ep.sorted_tile_plan(torch.tensor(ids), E, budget + 1, tile)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_tiles_apply_plan_take_and_expert_apply_tiled_match_jax(rng, dtype):
    E, tile, budget = 12, 8, 256
    t, j = _both_experts(rng, E, 10, 6, 4)
    x = rng.randn(120, 10).astype(np.float32)
    ids = rng.randint(0, E + 1, 120)
    tol = F32_TOL if dtype is None else dict(atol=BF16_ATOL)
    tdt, jdt = (None, None) if dtype is None else (torch.bfloat16, jnp.bfloat16)
    plan_t = ep.sorted_tile_plan(torch.tensor(ids), E, budget, tile)
    plan_j = jep.sorted_tile_plan(jnp.asarray(ids), E, budget, tile)
    slots_t = ep.tiles_apply(t, torch.tensor(x)[plan_t.tok], plan_t, compute_dtype=tdt)
    slots_j = jep.tiles_apply(j, jnp.asarray(x)[plan_j.tok], plan_j, compute_dtype=jdt)
    _same(slots_t, slots_j, **tol)
    assert float(slots_t[~plan_t.valid].abs().max()) == 0.0
    _same(ep.plan_take(plan_t, slots_t), jep.plan_take(plan_j, slots_j), **tol)
    got = ep.expert_apply_tiled(t, *_t(x, ids), budget, tile, compute_dtype=tdt)
    want = jep.expert_apply_tiled(j, *_j(x, ids), budget, tile, compute_dtype=jdt)
    _same(got.out, want.out, **tol)
    _same(got.overflow, want.overflow)


# --------------------------------------------------- kernel E's plain version

def _plan_inputs(rng, field_t, field_j, n, tile, budget):
    pos, dirs = _points(rng, n, span=1.2)
    ids, n_route = ex._route(field_t, torch.tensor(pos))
    plan = ep.sorted_tile_plan(ids, n_route, budget, tile)
    local = ex._local_coords(field_t, torch.tensor(pos)[plan.tok])
    j_local = jex._local_coords(field_j, jnp.asarray(pos)[plan.tok.numpy()])
    _same(local, j_local, atol=1e-6)
    return plan, local, torch.tensor(dirs)[plan.tok]


@pytest.mark.parametrize("tile,budget", [(8, 512), (32, 1024)])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_expert_tiles_plain_version_matches_the_pallas_kernel_in_interpret_mode(
        rng, tile, budget, dtype):
    field_t, field_j = _both_fields(rng)
    plan, local, dirs = _plan_inputs(rng, field_t, field_j, 300, tile, budget)
    assert not bool(plan.valid[-tile:].any())        # empty trailing tiles are in the stream
    tdt, jdt = (None, None) if dtype is None else (torch.bfloat16, jnp.bfloat16)
    got = expert_tiles.expert_tiles_forward(
        field_t.experts, local, dirs, plan.valid, plan.tile_expert, l_pos=3, l_dir=1, tile=tile,
        compute_dtype=tdt)
    want = j_expert_tiles(field_j.experts, *_j(local, dirs, plan.valid, plan.tile_expert),
                          l_pos=3, l_dir=1, tile=tile, compute_dtype=jdt, interpret=True)
    _same(got, want, **(F32_TOL if dtype is None else dict(atol=BF16_ATOL)))
    assert got.dtype == torch.float32 and float(got[~plan.valid].abs().max()) == 0.0


def test_expert_tiles_plain_version_equals_encode_then_tiles_apply(rng):
    field_t, _ = _both_fields(rng)
    pos, dirs = _t(*_points(rng, 300, span=1.2))
    ids, n_route = ex._route(field_t, pos)
    plan = ep.sorted_tile_plan(ids, n_route, 1024, 32)
    want = ep.tiles_apply(field_t.experts, ex._encode(field_t, pos[plan.tok], dirs[plan.tok]),
                          plan)
    got = expert_tiles.expert_tiles_forward(
        field_t.experts, ex._local_coords(field_t, pos[plan.tok]), dirs[plan.tok], plan.valid,
        plan.tile_expert, l_pos=3, l_dir=1, tile=32)
    _same(got, want.numpy(), **F32_TOL)


def test_expert_tiles_wrapper_refuses_a_ragged_stream(rng):
    field_t, _ = _both_fields(rng)
    local = torch.zeros(20, 3)
    with pytest.raises(ValueError, match="multiple of tile"):
        expert_tiles.expert_tiles_forward(
            field_t.experts, local, local, torch.ones(20, dtype=torch.bool),
            torch.zeros(2, dtype=torch.int32), l_pos=3, l_dir=1, tile=8)


# --------------------------------------------------------------- serving forms

def _rays(rng, R, S):
    o = np.zeros((R, 3), np.float32)
    o[:, 2] = -2.0
    d = rng.randn(R, 3).astype(np.float32) * 0.35 + np.float32([0, 0, 1])
    z = np.broadcast_to(np.linspace(0.5, 4.0, S, dtype=np.float32), (R, S)).copy()
    return o, d, z


def _compact_pair(rng, field_t, field_j):
    occ = rng.uniform(size=field_t.grid ** 3) < 0.5
    return ex.compact_field(field_t, occ), jex.compact_field(field_j, occ)


@pytest.mark.parametrize("form", ["dense", "tiled", "tiled_kernel", "culled", "culled_kernel",
                                  "bucketed", "compact", "tiled_compact", "culled_compact"])
def test_expert_raw_fns_match_jax_with_shared_weights(rng, form):
    field_t, field_j = _both_fields(rng, grid=2, hidden=8)
    cf_t, cf_j = _compact_pair(rng, field_t, field_j)
    pos, dirs = _points(rng, 200, span=1.5)          # some outside the AABB
    pt, pj = _t(pos, dirs), _j(pos, dirs)
    kernel = form.endswith("_kernel")
    ft, fj = (cf_t, cf_j) if "compact" in form else (field_t, field_j)
    if form == "dense":
        got, want, over_t, over_j = (ex.expert_raw_fn(ft, *pt), jex.expert_raw_fn(fj, *pj), 0, 0)
    elif form.startswith("tiled"):
        got, over_t = ex.expert_raw_fn_tiled(ft, *pt, 384, 32, use_kernel=kernel)
        want, over_j = jex.expert_raw_fn_tiled(fj, *pj, 384, 32, use_kernel=kernel)
        over_t, over_j = int(over_t.sum()), int(over_j.sum())
    elif form.startswith("culled"):
        got, over_t = ex.expert_raw_fn_culled(ft, *pt, 384, 32, use_kernel=kernel)
        want, over_j = jex.expert_raw_fn_culled(fj, *pj, 384, 32, use_kernel=kernel)
    else:
        fn_t = ex.expert_raw_fn_bucketed if form == "bucketed" else ex.expert_raw_fn_compact
        fn_j = jex.expert_raw_fn_bucketed if form == "bucketed" else jex.expert_raw_fn_compact
        got, over_t = fn_t(ft, *pt, 64)
        want, over_j = fn_j(fj, *pj, 64)
        over_t, over_j = int(over_t.sum()), int(over_j.sum())
    _same(got, want, **F32_TOL)
    assert int(over_t) == int(over_j) == 0
    assert float(got.abs().max()) > 0


def test_culled_and_tiled_count_their_overflow_like_jax(rng):
    field_t, field_j = _both_fields(rng, grid=2, hidden=8)
    pos, dirs = _points(rng, 400, span=1.0)          # everything inside: 400 real tokens
    _, over_t = ex.expert_raw_fn_culled(field_t, *_t(pos, dirs), 128, 32)
    _, over_j = jex.expert_raw_fn_culled(field_j, *_j(pos, dirs), 128, 32)
    assert int(over_t) == int(over_j) > 0
    _, flags_t = ex.expert_raw_fn_tiled(field_t, *_t(pos, dirs), 128, 32)
    _, flags_j = jex.expert_raw_fn_tiled(field_j, *_j(pos, dirs), 128, 32)
    _same(flags_t, flags_j)


@pytest.mark.parametrize("form", ["dense", "tiled", "tiled_kernel", "culled", "culled_kernel",
                                  "bucketed", "compact"])
@pytest.mark.parametrize("white", [False, True])
def test_render_rays_with_experts_match_jax_with_shared_weights(rng, form, white):
    field_t, field_j = _both_fields(rng, grid=2, hidden=8)
    cf_t, cf_j = _compact_pair(rng, field_t, field_j)
    rays = _rays(rng, 16, 24)
    rt, rj = _t(*rays), _j(*rays)
    kernel = form.endswith("_kernel")
    if form == "dense":
        got = ex.render_rays_with_experts(field_t, *rt, white_background=white)
        want = jex.render_rays_with_experts(field_j, *rj, white_background=white)
        over_t = over_j = 0
    elif form.startswith("tiled"):
        got, over_t = ex.render_rays_with_experts_tiled(field_t, *rt, 640, 32, white,
                                                        use_kernel=kernel)
        want, over_j = jex.render_rays_with_experts_tiled(field_j, *rj, 640, 32, white,
                                                          use_kernel=kernel)
    elif form.startswith("culled"):
        got, over_t = ex.render_rays_with_experts_culled(cf_t, *rt, 640, 32, white,
                                                         use_kernel=kernel)
        want, over_j = jex.render_rays_with_experts_culled(cf_j, *rj, 640, 32, white,
                                                           use_kernel=kernel)
    elif form == "bucketed":
        got, over_t = ex.render_rays_with_experts_bucketed(field_t, *rt, 128, white)
        want, over_j = jex.render_rays_with_experts_bucketed(field_j, *rj, 128, white)
    else:
        got, over_t = ex.render_rays_with_experts_compact(cf_t, *rt, 128, white)
        want, over_j = jex.render_rays_with_experts_compact(cf_j, *rj, 128, white)
    assert int(over_t) == int(over_j) == 0
    _same(got.rgb, want.rgb, atol=RGB_ATOL)
    _same(got.weights, want.weights, atol=RGB_ATOL)
    assert got.rgb.shape == (16, 3) and float(got.acc.max()) > 0.05


def test_render_rays_kernel_path_in_bf16_is_close_to_jax(rng):
    field_t, field_j = _both_fields(rng, grid=2, hidden=8)
    rays = _rays(rng, 16, 24)
    got, _ = ex.render_rays_with_experts_culled(field_t, *_t(*rays), 640, 32,
                                                compute_dtype=torch.bfloat16, use_kernel=True)
    want, _ = jex.render_rays_with_experts_culled(field_j, *_j(*rays), 640, 32,
                                                  compute_dtype=jnp.bfloat16, use_kernel=True)
    _same(got.rgb, want.rgb, atol=BF16_ATOL)


# ------------------------------------------------------- occupancy, compaction

def test_grid_and_cell_occupancy_and_dilation_match_jax_exactly(rng):
    field_t, field_j = _both_fields(rng, grid=3, hidden=8)
    for thresh in (0.0, 0.2):
        got = ex.cell_occupancy(field_t, 2, thresh)
        want = jex.cell_occupancy(field_j, 2, thresh)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ex.dilate_occupancy(got, 3), jex.dilate_occupancy(want, 3))
    assert 0 < got.sum() < 27
    # a chunk smaller than the lattice changes nothing
    small = ex.grid_occupancy(lambda p, d: ex.expert_raw_fn(field_t, p, d), field_t.aabb_min,
                              field_t.aabb_max, 3, 2, 0.2, chunk=50)
    np.testing.assert_array_equal(small, got)
    one = np.zeros(64, bool)
    one[21] = True                                   # cell (1, 1, 1) of a 4^3 grid
    np.testing.assert_array_equal(ex.dilate_occupancy(one, 4), jex.dilate_occupancy(one, 4))
    assert ex.dilate_occupancy(one, 4).sum() == 7


def test_compact_field_matches_jax_exactly_and_refuses_an_empty_mask(rng):
    field_t, field_j = _both_fields(rng, grid=3, hidden=8)
    occ = rng.uniform(size=27) < 0.4
    got, want = ex.compact_field(field_t, occ), jex.compact_field(field_j, occ)
    _same(got.remap, want.remap)
    for a, b in zip(got.experts, want.experts):
        _same(a, b)
    assert got.experts.w0.shape[0] == occ.sum() and int(got.remap[27]) == occ.sum()
    with pytest.raises(ValueError, match="no occupied cells"):
        ex.compact_field(field_t, np.zeros(27, bool))


# ------------------------------------------------------------------- training

def _adam_updated(params_t, lr):
    return torch.optim.Adam(params_t, lr=lr, eps=1e-8)


def _same_grads(params, grads):
    for p, g in zip(params, grads):
        g = np.asarray(g)
        assert np.abs(g).max() > 0
        _same(p.grad, g, rtol=1e-4, atol=1e-5 * np.abs(g).max())


N_ADAM_STEPS = 3


def test_one_injected_batch_adam_step_of_distill_experts_matches_jax(rng):
    field_t, field_j = _both_fields(rng, grid=2, hidden=8)
    ch_scale = np.float32([0.5, 1.0, 2.0, 0.7])
    lr = 1e-3

    tx = optax.adam(lr)
    want = field_j.experts
    opt_state = tx.init(want)
    params = ex._trainable(field_t.experts)
    optimizer = _adam_updated(params, lr)
    for _ in range(N_ADAM_STEPS):
        pos, dirs = _points(rng, 256, span=1.0)
        pos = pos * np.float32([1.0, 0.9, 0.9])          # inside the AABB
        target = rng.randn(256, 4).astype(np.float32)
        pj, dj = _j(pos, dirs)
        ids = jep.voxel_expert_ids(pj, field_j.aabb_min, field_j.aabb_max, field_j.grid)
        x = jex._encode(field_j, pj, dj)

        def loss_fn(e):
            return jnp.mean(((jep.expert_apply(e, x, ids) - target) / ch_scale) ** 2)

        want_loss, grads = jax.value_and_grad(loss_fn)(want)
        updates, opt_state = tx.update(grads, opt_state)
        want = optax.apply_updates(want, updates)

        got_loss = ex.distill_step(field_t, params, optimizer, *_t(pos, dirs, target),
                                   torch.tensor(ch_scale))
        assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-5)
        _same_grads(params, grads)
    for p, w, before in zip(params, want, field_t.experts):
        _same(p, w, atol=0.02 * lr)
        assert float((p.detach() - before).abs().max()) > 0.5 * lr     # it did move


@pytest.mark.parametrize("path", ["tiled", "bucketed"])
def test_one_injected_batch_adam_step_of_finetune_experts_matches_jax(rng, path):
    field_t, field_j = _both_fields(rng, grid=2, hidden=8)
    lr = 5e-4
    kw = dict(budget=512, tile=8) if path == "tiled" else dict(capacity=256)

    tx = optax.adam(lr)
    want = field_j.experts
    opt_state = tx.init(want)
    params = ex._trainable(field_t.experts)
    optimizer = _adam_updated(params, lr)
    for _ in range(N_ADAM_STEPS):
        o, d, z = _rays(rng, 32, 12)
        z = z + rng.uniform(0, 0.2, z.shape).astype(np.float32)
        c = rng.uniform(0, 1, (32, 3)).astype(np.float32)

        def loss_fn(e):
            f = field_j._replace(experts=e)
            if path == "tiled":
                outs, n_over = jex.render_rays_with_experts_tiled(f, *_j(o, d, z), 512, 8)
            else:
                outs, n_over = jex.render_rays_with_experts_bucketed(f, *_j(o, d, z), 256)
            return jnp.mean((outs.rgb - c) ** 2), n_over

        (want_loss, want_over), grads = jax.value_and_grad(loss_fn, has_aux=True)(want)
        updates, opt_state = tx.update(grads, opt_state)
        want = optax.apply_updates(want, updates)

        got_loss, got_over = ex.finetune_step(field_t, params, optimizer, *_t(o, d, c, z), **kw)
        assert int(got_over) == int(want_over) == 0
        assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-5)
        _same_grads(params, grads)
    for p, w in zip(params, want):
        _same(p, w, atol=0.02 * lr)


def test_cosine_decay_matches_optax():
    sched = ex.CosineDecay(1e-4, 50, alpha=0.03)
    want = optax.cosine_decay_schedule(1e-4, 50, alpha=0.03)
    for count in (0, 1, 17, 49, 50, 80):
        assert sched(count) == pytest.approx(float(want(count)), rel=1e-6)


def test_the_batch_draws_are_seeded_uniform_and_biased_where_asked():
    lo, hi = torch.tensor([-1.0, -1.0, -1.0]), torch.tensor([1.0, 1.0, 1.0])
    gen = torch.Generator().manual_seed(0)
    pos, dirs = ex.sample_distill_batch(gen, lo, hi, 4, 4000)
    assert bool(((pos >= lo) & (pos <= hi)).all())
    np.testing.assert_allclose(dirs.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    occ_ids = torch.tensor([21])                     # cell (1, 1, 1): [-0.5, 0]^3
    pos_b, _ = ex.sample_distill_batch(gen, lo, hi, 4, 4000, occ_ids, 0.5)
    share = float(((pos_b >= -0.5) & (pos_b <= 0.0)).all(-1).float().mean())
    assert 0.45 < share < 0.58                       # half biased + 1/64 of the uniform half
    idx, z = ex.sample_finetune_batch(gen, 100, 64, 8, 1.0, 4.0)
    assert int(idx.min()) >= 0 and int(idx.max()) < 100 and z.shape == (64, 8)
    edges = torch.linspace(1.0, 4.0, 9)
    assert bool(((z >= edges[:-1]) & (z <= edges[1:])).all())


def test_distill_and_finetune_learn_a_small_teacher_and_resume_from_a_checkpoint(rng, tmp_path):
    teacher_t, _ = _both_fields(rng, grid=2, hidden=8, l_pos=2, l_dir=1)

    def teacher_fn(p, d):
        return ex.expert_raw_fn(teacher_t, p, d)

    field, loss = ex.distill_experts(teacher_fn, [-1, -0.9, -1.1], [1, 1.1, 0.9], 2,
                                     torch.Generator().manual_seed(0), hidden=8, l_pos=2, l_dir=1,
                                     n_steps=150, batch=512, lr=5e-3)
    assert loss < 0.5                                # from ~1 (normalised) at the start
    o, d, z = _rays(rng, 256, 12)
    with torch.no_grad():
        rgb = ex.render_rays_with_experts(teacher_t, *_t(o, d, z)).rgb.numpy()
    kw = dict(near=0.5, far=4.0, n_samples=12, budget=2048, tile=8, batch=64, lr=2e-3)
    part = str(tmp_path / "ft.part.npz")
    full, full_loss, over = ex.finetune_experts(field, o, d, rgb, torch.Generator().manual_seed(1),
                                                n_steps=20, **kw)
    assert over == 0 and np.isfinite(full_loss)
    with torch.no_grad():
        def mse(f):
            return float(((ex.render_rays_with_experts(f, *_t(o, d, z)).rgb.numpy() - rgb) ** 2)
                         .mean())
        assert mse(full) < mse(field)

    # a run cut after step 10 leaves a checkpoint; the rerun ends where the whole run did
    class Cut(Exception):
        pass

    real_step = ex.finetune_step
    calls = []

    def cutting_step(*a, **k):
        if len(calls) == 10:
            raise Cut
        calls.append(1)
        return real_step(*a, **k)

    ex.finetune_step = cutting_step
    try:
        with pytest.raises(Cut):
            ex.finetune_experts(field, o, d, rgb, torch.Generator().manual_seed(1), n_steps=20,
                                checkpoint_path=part, checkpoint_every=10, **kw)
    finally:
        ex.finetune_step = real_step
    resumed, resumed_loss, _ = ex.finetune_experts(
        field, o, d, rgb, torch.Generator().manual_seed(99), n_steps=20, checkpoint_path=part,
        checkpoint_every=10, **kw)
    assert resumed_loss == pytest.approx(full_loss, rel=1e-5)
    for a, b in zip(resumed.experts, full.experts):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    assert not (tmp_path / "ft.part.npz").exists()   # removed when the phase is done

    # a checkpoint of another lr or batch is stale
    ex.finetune_step = cutting_step
    calls.clear()
    try:
        with pytest.raises(Cut):
            ex.finetune_experts(field, o, d, rgb, torch.Generator().manual_seed(1), n_steps=20,
                                checkpoint_path=part, checkpoint_every=10, **kw)
    finally:
        ex.finetune_step = real_step
    other, _, _ = ex.finetune_experts(field, o, d, rgb, torch.Generator().manual_seed(1),
                                      n_steps=20, checkpoint_path=part, checkpoint_every=10,
                                      **dict(kw, lr=1e-3))
    fresh, _, _ = ex.finetune_experts(field, o, d, rgb, torch.Generator().manual_seed(1),
                                      n_steps=20, **dict(kw, lr=1e-3))
    for a, b in zip(other.experts, fresh.experts):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="exactly one"):
        ex.finetune_experts(field, o, d, rgb, torch.Generator(), near=0.5, far=4.0, n_samples=4)


# ----------------------------------------------------------------- field files

def test_a_field_npz_written_by_the_jax_side_renders_the_same_through_both(rng, tmp_path):
    _, field_j = _both_fields(rng, grid=2, hidden=8)
    path = str(tmp_path / "field.npz")
    # the keys tools/distill_run.py writes
    np.savez(path, **{k: np.asarray(v) for k, v in field_j.experts._asdict().items()},
             aabb_min=np.asarray(field_j.aabb_min), aabb_max=np.asarray(field_j.aabb_max),
             grid=field_j.grid, l_pos=field_j.l_pos, l_dir=field_j.l_dir)
    field_t = ex.load_field(path)
    assert (field_t.grid, field_t.l_pos, field_t.l_dir) == (2, 3, 1)
    rays = _rays(rng, 16, 24)
    got, over = ex.render_rays_with_experts_culled(field_t, *_t(*rays), 640, 32, use_kernel=True)
    want, _ = jex.render_rays_with_experts_culled(field_j, *_j(*rays), 640, 32, use_kernel=True)
    assert int(over) == 0
    _same(got.rgb, want.rgb, atol=RGB_ATOL)

    # and back: what the port writes, the JAX side's loader idiom reads
    back = str(tmp_path / "back.npz")
    ex.save_field(back, field_t)
    with np.load(back) as z:
        assert set(z.files) == {"w0", "b0", "w1", "b1", "aabb_min", "aabb_max", "grid", "l_pos",
                                "l_dir"}
        experts = jep.ExpertMLP(*(jnp.asarray(z[k]) for k in ("w0", "b0", "w1", "b1")))
        again = jex.ExpertField(experts, jnp.asarray(z["aabb_min"]), jnp.asarray(z["aabb_max"]),
                                int(z["grid"]), int(z["l_pos"]), int(z["l_dir"]))
    for a, b in zip(again.experts, field_j.experts):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not (tmp_path / "back.npz.tmp.npz").exists()


# ---------------------------------------------------------------------- scores

def test_mse_psnr_and_ssim_match_jax(rng):
    truth = rng.uniform(0, 1, (2, 24, 20, 3)).astype(np.float32)
    render = np.clip(truth + 0.05 * rng.randn(*truth.shape).astype(np.float32), 0, 1)
    assert float(scores.img2mse(render, truth)) == pytest.approx(
        float(jscores.img2mse(render, truth)), rel=1e-5)
    assert float(scores.img2psnr(render, truth)) == pytest.approx(
        float(jscores.img2psnr(render, truth)), rel=1e-5)
    assert float(scores.ssim(render, truth)) == pytest.approx(
        float(jscores.ssim(render, truth)), abs=1e-5)
    assert float(scores.ssim(render[0], truth[0])) == pytest.approx(
        float(jscores.ssim(render[0], truth[0])), abs=1e-5)
    # a near-constant background: SSIM stays at or below 1 (float32 throughout)
    flat = np.full((1, 16, 16, 3), 0.7, np.float32)
    assert float(scores.ssim(flat, flat + 1e-4)) <= 1.0 + 1e-6
    assert float(scores.ssim(truth, truth)) == pytest.approx(1.0, abs=1e-6)


def test_print_scores_reports_mse_psnr_ssim_and_names_what_is_not_ported(rng, capsys):
    truth = rng.uniform(0, 1, (1, 16, 16, 3)).astype(np.float32)
    out = scores.print_scores(np.clip(truth + 0.1, 0, 1), truth)
    assert set(out) == {"mse", "psnr", "ssim"} and out["psnr"] > 0
    said = capsys.readouterr().out
    # 16 px is too small for the VGG16 of rlpips, and no lpips weights file exists
    assert "rlpips skipped: images are 16x16" in said and "LPIPS skipped" in said
