"""The port's parallel layer in one process against the JAX package's.

No process is spawned: the layout functions take a bare `Mesh(data, model,
rank)` and are held, rank by rank, against the shards JAX places on the
devices of its 8-device virtual CPU mesh (mesh parsing and its errors,
pad_to_multiple, local_row_range, shard_batch, make_global_batch, put_tree,
the tensor-parallel split rule); a world-1 gloo group (a file rendezvous
under tmp_path) runs the rank / world helpers, broadcast_file and the
whole-tensor saves, and the dry run refuses the host unless asked; the
integrators (raw2outputs_segmented at 1 / 2 / 4 segments, compose_segments,
global_dists, sample_parallel_raw2outputs at one rank), the stacked trunk
(stack_trunk / trunk_dense with identity padding, pipeline_trunk and
pp_render_ray_net at one stage, with gradients) and expert_parallel_apply at
one rank run on the same numpy inputs as the JAX functions. Weights go from
the port to JAX with the JAX package's import_torch_state_dict.

Tolerances: float32 rtol 1e-5 (atol 1e-6 where values cross 0).
"""
import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smpl_nerf_tpu.core import integrate as jax_integrate
from smpl_nerf_tpu.models.render_ray_net import RenderRayNet as JaxRenderRayNet
from smpl_nerf_tpu.models.render_ray_net import import_torch_state_dict
from smpl_nerf_tpu.parallel import ep as jax_ep
from smpl_nerf_tpu.parallel import mesh as jax_mesh
from smpl_nerf_tpu.parallel import multihost as jax_multihost
from smpl_nerf_tpu.parallel import pp as jax_pp
from smpl_nerf_tpu.parallel import sample_axis as jax_sa
from smpl_nerf_tpu.parallel import tp as jax_tp
from smpl_nerf_tpu.training import checkpoints as jax_checkpoints
from smpl_nerf_tpu_torch.core import integrate
from smpl_nerf_tpu_torch.models import RenderRayNet
from smpl_nerf_tpu_torch.parallel import dryrun, ep, multihost, pp, sample_axis, tp
from smpl_nerf_tpu_torch.parallel import mesh as mesh_mod
from smpl_nerf_tpu_torch.parallel.mesh import Mesh
from smpl_nerf_tpu_torch.training import checkpoints

LAYOUTS = [(8, 1), (4, 2), (2, 2), (1, 2), (2, 4)]


def close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _device_index(jmesh, i, j):
    return jmesh.devices[i, j]


# ------------------------------------------------------------------- mesh

@pytest.mark.parametrize("shape,want", [("", (8, 1)), ("8", (8, 1)), ("4,2", (4, 2)),
                                        ("2,2", (2, 2)), ("1", (1, 1))])
def test_parse_mesh_shape_as_jax_make_mesh(devices, shape, want):
    assert mesh_mod.parse_mesh_shape(shape, 8) == want
    if want[0] * want[1] <= len(devices):
        jm = jax_mesh.make_mesh(shape)
        assert (jm.shape["data"], jm.shape["model"]) == mesh_mod.parse_mesh_shape(
            shape, len(devices))


@pytest.mark.parametrize("shape", ["", "1", "1,1"])
def test_make_mesh_without_a_group_is_the_single_device(shape):
    m = mesh_mod.make_mesh(shape)
    assert (m.data, m.model, m.rank, m.distributed) == (1, 1, 0, False)
    assert m.data_group is None and m.model_group is None


@pytest.mark.parametrize("shape", ["2", "4,2", "16,2", "1,3"])
def test_make_mesh_larger_than_the_world_raises_jax_message(devices, shape):
    with pytest.raises(ValueError) as want:
        jax_mesh.make_mesh(shape, devices[:1])
    with pytest.raises(ValueError) as got:
        mesh_mod.make_mesh(shape)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,k", [(0, 1), (1, 1), (5, 2), (8, 4), (100, 8), (4097, 3)])
def test_pad_to_multiple(n, k):
    assert mesh_mod.pad_to_multiple(n, k) == jax_mesh.pad_to_multiple(n, k)


# ------------------------------------------------------------ batch rows

@pytest.mark.parametrize("layout", LAYOUTS)
def test_local_row_range_matches_jax_device_spans(devices, layout):
    d, m = layout
    jm = jax_mesh.make_mesh(f"{d},{m}")
    sh = jax_mesh.data_sharding(jm)
    n = 16
    spans = sh.devices_indices_map((n,))
    for i in range(d):
        for j in range(m):
            s = spans[_device_index(jm, i, j)][0]
            want = (s.start or 0, n if s.stop is None else s.stop)
            assert multihost.local_row_range(Mesh(d, m, i * m + j), n) == want
    # one process owns every device: JAX's union is the whole batch
    assert jax_multihost.local_row_range(sh, n) == (0, n)
    if d > 1:
        with pytest.raises(ValueError, match="pad"):
            multihost.local_row_range(Mesh(d, m), n + 1)


@pytest.mark.parametrize("layout", [(4, 2), (2, 1)])
def test_shard_batch_and_make_global_batch_match_jax_shards(devices, rng, layout):
    d, m = layout
    jm = jax_mesh.make_mesh(f"{d},{m}")
    batch = {"rgb": rng.rand(8, 3).astype(np.float32),
             "ray_direction": rng.randn(8, 3).astype(np.float32),
             "goal_verts_itable": rng.randn(3, 5, 3).astype(np.float32)}
    rows = {k: v for k, v in batch.items() if not k.endswith("_itable")}
    j_sharded = jax_mesh.shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, jm)
    j_global = jax_multihost.make_global_batch(rows, jm)
    for i in range(d):
        for j in range(m):
            mesh = Mesh(d, m, i * m + j)
            dev = _device_index(jm, i, j)
            ours = mesh_mod.shard_batch({k: torch.as_tensor(v) for k, v in batch.items()}, mesh)
            ours_g = multihost.make_global_batch(rows, mesh)
            for k in batch:
                want = [s.data for s in j_sharded[k].addressable_shards if s.device == dev][0]
                close(ours[k], want, 0, 0, k)
                if k in rows:
                    want_g = [s.data for s in j_global[k].addressable_shards
                              if s.device == dev][0]
                    close(ours_g[k], want_g, 0, 0, k)


# ----------------------------------------------------------------- tensor parallel

def _nets(width=16, seed=0):
    """A coarse + fine pair of port nets, their state dicts as JAX trees."""
    gen = torch.Generator().manual_seed(seed)
    models = {name: RenderRayNet(3, width, 12, 6, skips=(1,), generator=gen)
              for name in ("model_coarse", "model_fine")}
    params = {name: import_torch_state_dict(
        {k: v.numpy() for k, v in m.state_dict().items()}, 3) for name, m in models.items()}
    return models, params


@pytest.mark.parametrize("shape", ["1,2", "2,4", "2,3", "8,1"])
def test_tp_param_shardings_split_what_jax_splits(devices, shape):
    models, params = _nets()
    jm = jax_mesh.make_mesh(shape)
    j_specs = jax_tp.tp_param_shardings(params, jm)
    ours = tp.tp_param_shardings(models, Mesh(*mesh_mod.parse_mesh_shape(shape, 8)))
    split = 0
    for name, m in models.items():
        tree = j_specs[name]["params"]
        for key in m.state_dict():
            layer, leaf = key.rsplit(".", 1)
            flax_layer = layer.replace("positional_net.", "positional_net_").replace(
                "directional_net.", "directional_net_")
            spec = tree[flax_layer]["kernel" if leaf == "weight" else "bias"].spec
            # a flax kernel [in, out] split on its out dim is a torch weight [out, in] on dim 0
            want = 0 if "model" in tuple(spec) else None
            assert ours[name][key] == want, (name, key, spec)
            split += want is not None
    # 6 trunk layers a net (W=16, the directional ones W/2=8), weight and bias
    assert split == {"1,2": 24, "2,4": 24, "2,3": 0, "8,1": 0}[shape]


@pytest.mark.parametrize("rank", [0, 1])
def test_put_tree_keeps_the_shards_jax_places(devices, rank):
    models, params = _nets()
    jm = jax_mesh.make_mesh("1,2")
    placed = jax_multihost.put_tree(params, jax_tp.tp_param_shardings(params, jm))
    mesh = Mesh(1, 2, rank)
    sds = {n: {k: v.clone() for k, v in m.state_dict().items()} for n, m in models.items()}
    dims = {n: {k: d for k, d in kd.items() if d is not None}
            for n, kd in tp.tp_param_shardings(models, mesh).items()}
    ours = multihost.put_tree(sds, mesh, dims)
    dev = _device_index(jm, 0, rank)
    for name, sd in ours.items():
        for key, value in sd.items():
            layer, leaf = key.rsplit(".", 1)
            flax_layer = layer.replace("positional_net.", "positional_net_").replace(
                "directional_net.", "directional_net_")
            arr = placed[name]["params"][flax_layer]["kernel" if leaf == "weight" else "bias"]
            want = [s.data for s in arr.addressable_shards if s.device == dev][0]
            close(value, np.asarray(want).T if leaf == "weight" else want, 0, 0, key)
    # whole again, and replicated as it was without a process group
    assert tp.gather_tree(ours, Mesh(), dims) is ours
    assert multihost.put_replicated(sds, Mesh()) is sds


def test_place_params_tp_needs_a_group_for_a_model_axis():
    models, _ = _nets()
    with pytest.raises(ValueError, match="process group"):
        tp.place_params_tp(models, Mesh(1, 2, 0))
    assert tp.place_params_tp(models, Mesh()) == {}


# ------------------------------------------------ world-1 group: files and saves

@pytest.fixture()
def world1_group(tmp_path):
    mesh_mod.init_distributed("cpu", f"file://{tmp_path / 'rendezvous'}", rank=0, world=1)
    try:
        yield mesh_mod.make_mesh("", "cpu")
    finally:
        mesh_mod.destroy()


def test_rank_and_world_without_and_with_a_group(tmp_path):
    assert (mesh_mod.is_distributed(), mesh_mod.rank(), mesh_mod.world_size()) == (False, 0, 1)
    dev = mesh_mod.init_distributed("cpu", f"file://{tmp_path / 'rendezvous'}", rank=0, world=1)
    try:
        assert dev == torch.device("cpu") and torch.distributed.get_backend() == "gloo"
        assert (mesh_mod.is_distributed(), mesh_mod.rank(), mesh_mod.world_size()) == (True, 0, 1)
    finally:
        mesh_mod.destroy()
    assert not mesh_mod.is_distributed()


def test_dryrun_runs_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        dryrun.main(["--rank", "0", "--world", "1", "--out", str(tmp_path),
                     "--init_method", f"file://{tmp_path / 'rendezvous'}"])
    assert not mesh_mod.is_distributed()


def test_broadcast_file_returns_rank0_bytes_or_none(world1_group, tmp_path):
    path = tmp_path / "train_state.pt"
    assert checkpoints.broadcast_file(str(path)) is None
    payload = bytes(range(256)) * 3
    path.write_bytes(payload)
    assert checkpoints.broadcast_file(str(path)) == payload


def test_host_tree_and_saves_under_a_group_match_jax_host_tree(world1_group, tmp_path, rng):
    mesh = world1_group
    assert mesh.distributed and (mesh.data, mesh.model) == (1, 1)
    tree = {"a": {"w": rng.randn(4, 3).astype(np.float32)}, "b": rng.randn(5).astype(np.float32)}
    want = jax_checkpoints._host_tree(jax.tree.map(jnp.asarray, tree))
    ours = checkpoints._host_tree({"a": {"w": torch.as_tensor(tree["a"]["w"])},
                                   "b": torch.as_tensor(tree["b"])}, mesh, {"a": {"w": 0}})
    close(ours["a"]["w"], want["a"]["w"], 0, 0)
    close(ours["b"], want["b"], 0, 0)
    models, _ = _nets()
    sds = {n: m.state_dict() for n, m in models.items()}
    checkpoints.save_run(str(tmp_path / "run"), sds, mesh=mesh, dims={})
    for name, sd in checkpoints.load_run(str(tmp_path / "run")).items():
        for key, value in sd.items():
            assert torch.equal(value, sds[name][key])
    checkpoints.save_train_state(str(tmp_path / "run"), {"state": {}}, epoch=3, best_val=0.5,
                                 mesh=mesh)
    data = checkpoints.broadcast_file(str(tmp_path / "run" / checkpoints.TRAIN_STATE))
    state = checkpoints.load_train_state("unused", data=data)
    assert state["epoch"] == 3 and state["best_val"] == 0.5


# ----------------------------------------------------------- the sample axis

def _rays(rng, R=16, S=32, per_sample=False):
    raw = rng.randn(R, S, 4).astype(np.float32)
    z = np.sort(rng.uniform(1, 4, (R, S)).astype(np.float32), -1)
    dirs = rng.randn(*((R, S, 3) if per_sample else (R, 3))).astype(np.float32)
    return raw, z, dirs


@pytest.mark.parametrize("segments", [1, 2, 4])
@pytest.mark.parametrize("white", [False, True])
def test_raw2outputs_segmented_matches_jax_and_raw2outputs(rng, segments, white):
    raw, z, dirs = _rays(rng)
    want = jax_integrate.raw2outputs_segmented(jnp.asarray(raw), jnp.asarray(z),
                                               jnp.asarray(dirs), segments,
                                               white_background=white)
    t = [torch.as_tensor(a) for a in (raw, z, dirs)]
    got = integrate.raw2outputs_segmented(*t, segments, white_background=white)
    plain = integrate.raw2outputs(*t, white_background=white)
    for k in ("rgb", "weights", "density", "depth", "acc"):
        close(getattr(got, k), getattr(want, k), msg=k)
        close(getattr(got, k), getattr(plain, k), msg=k)


def test_compose_segments_matches_jax_and_is_associative(rng):
    parts = [(rng.rand(6, 3).astype(np.float32), rng.rand(6).astype(np.float32))
             for _ in range(3)]
    (ra, ta), (rb, tb), (rc, tc) = [(torch.as_tensor(r), torch.as_tensor(t)) for r, t in parts]
    got = integrate.compose_segments(ra, ta, rb, tb)
    want = jax_integrate.compose_segments(*(jnp.asarray(a) for p in parts[:2] for a in p))
    close(got[0], want[0])
    close(got[1], want[1])
    left = integrate.compose_segments(*integrate.compose_segments(ra, ta, rb, tb), rc, tc)
    right = integrate.compose_segments(ra, ta, *integrate.compose_segments(rb, tb, rc, tc))
    close(left[0], right[0].numpy())
    close(left[1], right[1].numpy())


@pytest.mark.parametrize("per_sample", [False, True])
def test_global_dists_matches_jax(rng, per_sample):
    _, z, dirs = _rays(rng, per_sample=per_sample)
    close(sample_axis.global_dists(torch.as_tensor(z), torch.as_tensor(dirs)),
          jax_sa.global_dists(jnp.asarray(z), jnp.asarray(dirs)))


@pytest.mark.parametrize("white", [False, True])
def test_sample_parallel_raw2outputs_at_one_rank_matches_jax(devices, rng, white):
    raw, z, dirs = _rays(rng)
    dists = jax_sa.global_dists(jnp.asarray(z), jnp.asarray(dirs))
    want = jax.jit(lambda *a: jax_sa.sample_parallel_raw2outputs(
        jax_mesh.make_mesh("1,1"), *a, white_background=white))(
        jnp.asarray(raw), jnp.asarray(z), dists)
    got = sample_axis.sample_parallel_raw2outputs(
        Mesh(), torch.as_tensor(raw), torch.as_tensor(z), torch.tensor(np.asarray(dists)),
        white_background=white)
    for k in ("rgb", "weights", "density", "depth", "acc"):
        close(getattr(got, k), getattr(want, k), msg=k)


# ---------------------------------------------------------------- the pipeline

def _pp_net(rng, n_layers=8, skips=(4,)):
    net = RenderRayNet(n_layers, 16, 6, 4, skips=skips,
                       generator=torch.Generator().manual_seed(int(rng.randint(1 << 30))))
    jnet = JaxRenderRayNet(n_layers=n_layers, width=16, positions_dim=6, directions_dim=4,
                           skips=skips)
    params = import_torch_state_dict({k: v.numpy() for k, v in net.state_dict().items()},
                                     n_layers)
    return net, jnet, params


@pytest.mark.parametrize("n_layers,skips,n_stages", [(8, (4,), 1), (8, (4,), 3), (6, (2,), 4)])
def test_stack_trunk_and_trunk_dense_match_jax_with_identity_padding(rng, n_layers, skips,
                                                                     n_stages):
    net, _, params = _pp_net(rng, n_layers, skips)
    x = rng.randn(8, 6).astype(np.float32)
    k, b, u = pp.stack_trunk(net, n_layers, skips, 6, 16, n_stages=n_stages)
    jk, jb, ju = jax_pp.stack_trunk(params, n_layers, skips, 6, 16, n_stages=n_stages)
    assert k.shape[0] % n_stages == 0 and k.shape[0] == jk.shape[0]
    for got, want in ((k, jk), (b, jb), (u, ju)):
        close(got, want, 0, 0)
    k1, b1, u1 = pp.stack_trunk(net, n_layers, skips, 6, 16)
    dense = pp.trunk_dense(k1, b1, u1, torch.as_tensor(x))
    close(pp.trunk_dense(k, b, u, torch.as_tensor(x)), dense.detach().numpy())
    close(dense, jax_pp.trunk_dense(jk, jb, ju, jnp.asarray(x)))


@pytest.mark.parametrize("n_micro", [1, 4])
def test_pipeline_and_pp_render_ray_net_at_one_stage_match_jax_with_gradients(
        devices, rng, n_micro):
    net, jnet, params = _pp_net(rng)
    x = rng.randn(16, 10).astype(np.float32)
    tgt = rng.rand(16, 4).astype(np.float32)
    jm = jax_mesh.make_mesh("8,1")
    want = jax_pp.pp_render_ray_net(jm, params, jnp.asarray(x), n_layers=8, width=16,
                                    pos_dim=6, dir_dim=4, n_micro=n_micro)
    out = pp.pp_render_ray_net(Mesh(), net, torch.as_tensor(x), n_layers=8, width=16,
                               pos_dim=6, dir_dim=4, n_micro=n_micro)
    close(out, want)
    close(out, jnet.apply(params, jnp.asarray(x)))
    ((out - torch.as_tensor(tgt)) ** 2).mean().backward()
    got = {k: p.grad.clone() for k, p in net.named_parameters()}
    net.zero_grad()
    ((net(torch.as_tensor(x)) - torch.as_tensor(tgt)) ** 2).mean().backward()
    for key, p in net.named_parameters():
        close(got[key], p.grad.numpy(), msg=key)


def test_pipeline_shape_guards_raise_as_jax(rng):
    net, _, params = _pp_net(rng)
    x = torch.as_tensor(rng.randn(16, 10).astype(np.float32))
    k, b, u = pp.stack_trunk(net, 8, (4,), 6, 16)
    with pytest.raises(ValueError, match="not divisible"):
        pp.pipeline_trunk(Mesh(), k, b, u, x[:, :6], n_micro=3)
    with pytest.raises(ValueError, match="pos_dim"):
        pp.pp_render_ray_net(Mesh(), net, x, n_layers=8, width=16, pos_dim=6, dir_dim=3)
    with pytest.raises(ValueError, match="process group"):
        pp.pipeline_trunk(Mesh(1, 2, 0), k, b, u, x[:, :6], n_micro=4)


# -------------------------------------------------------------------- experts

@pytest.mark.parametrize("capacity", [64, 3])
def test_expert_parallel_apply_at_one_rank_matches_jax(devices, rng, capacity):
    E = 8
    experts = jax_ep.init_experts(jax.random.PRNGKey(0), E, 6, 8, 4)
    x = rng.randn(64, 6).astype(np.float32)
    ids = rng.randint(0, E + 1, 64).astype(np.int32)          # id E: skipped
    tgt = rng.rand(64, 4).astype(np.float32)
    jm = jax_mesh.make_mesh("1,1")
    apply = jax.jit(lambda ex: jax_ep.expert_parallel_apply(jm, ex, jnp.asarray(x),
                                                            jnp.asarray(ids), capacity))
    want = apply(experts)
    j_grads = jax.grad(lambda ex: jnp.mean((apply(ex).out - tgt) ** 2))(experts)
    ours = ep.ExpertMLP(*(torch.tensor(np.asarray(w)).requires_grad_(True)
                          for w in experts))
    got = ep.expert_parallel_apply(Mesh(), ours, torch.as_tensor(x),
                                   torch.as_tensor(ids.astype(np.int64)), capacity)
    close(got.out, want.out)
    np.testing.assert_array_equal(got.overflow.numpy(), np.asarray(want.overflow))
    assert got.overflow.any() == (capacity < 64)
    ((got.out - torch.as_tensor(tgt)) ** 2).mean().backward()
    for g, w in zip(j_grads, ours):
        close(w.grad, g)


def test_expert_parallel_apply_guard_raises():
    experts = ep.init_experts(torch.Generator().manual_seed(0), 5, 6, 8, 4)
    with pytest.raises(ValueError, match="process group"):
        ep.expert_parallel_apply(Mesh(1, 2, 0), experts, torch.zeros(4, 6),
                                 torch.zeros(4, dtype=torch.long), 4)
