"""jax->torch checkpoint export (inverse of the import shim).

Proves the migration story both ways: params trained in this framework load
into the reference's torch modules (reference utils.py save_run layout:
model_coarse.pt / model_fine.pt / model_warp_field.pt) and produce identical
forward outputs.
"""
import _torch_threads  # noqa: F401

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smpl_nerf_tpu.models import render_ray_net as rrn_mod
from smpl_nerf_tpu.models import warp_field_net as wfn_mod
from smpl_nerf_tpu.models.render_ray_net import RenderRayNet
from smpl_nerf_tpu.models.warp_field_net import WarpFieldNet
from tests.test_models import _torch_render_ray_net


def test_render_ray_net_export_roundtrip_and_torch_forward(rng):
    n_layers, width, pos_dim, dir_dim = 4, 32, 24, 12
    skips = (1,)
    jnet = RenderRayNet(n_layers=n_layers, width=width, positions_dim=pos_dim,
                        directions_dim=dir_dim, skips=skips)
    x = rng.randn(9, pos_dim + dir_dim).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(3), jnp.asarray(x))
    want = np.asarray(jnet.apply(params, jnp.asarray(x)))

    sd = rrn_mod.export_torch_state_dict(params, n_layers)
    # round-trip: export o import is the identity
    back = rrn_mod.import_torch_state_dict(sd, n_layers)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           params["params"], back["params"])
    # the exported state_dict loads into the reference-topology torch module
    tnet = _torch_render_ray_net(n_layers, width, pos_dim, dir_dim, 0,
                                 list(skips), 1)
    tnet.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    got = tnet(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_warp_field_export_roundtrip(rng):
    net = WarpFieldNet(width=16, positions_dim=6, pose_dim=4)
    x = rng.randn(5, 10).astype(np.float32)
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(x))
    sd = wfn_mod.export_torch_state_dict(params)
    back = wfn_mod.import_torch_state_dict(sd)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           params["params"], back["params"])


def test_export_torch_run_from_checkpoint_dir(tmp_path, rng):
    from smpl_nerf_tpu.training import checkpoints

    n_layers, width, pos_dim, dir_dim = 3, 16, 12, 6
    jnet = RenderRayNet(n_layers=n_layers, width=width, positions_dim=pos_dim,
                        directions_dim=dir_dim, skips=(1,))
    x = rng.randn(4, pos_dim + dir_dim).astype(np.float32)
    params = {
        "model_coarse": jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)),
        "model_fine": jnet.init(jax.random.PRNGKey(1), jnp.asarray(x)),
    }
    run_dir = str(tmp_path / "run")
    checkpoints.save_run(run_dir, params)
    out_dir = str(tmp_path / "torch")
    written = checkpoints.export_torch_run(run_dir, out_dir)
    assert set(written) == {"model_coarse", "model_fine"}
    for name, path in written.items():
        assert os.path.exists(path)
        sd = {k: v.numpy() for k, v in torch.load(path).items()}
        back = rrn_mod.import_torch_state_dict(sd, n_layers)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, b, atol=0),
            jax.device_get(params[name])["params"], back["params"])


def test_export_torch_run_reimports_through_import_torch_run(tmp_path, rng):
    """Full cycle: our run dir -> torch files -> import_torch_run -> params."""
    from smpl_nerf_tpu.training import checkpoints

    n_layers, width, pos_dim, dir_dim = 3, 16, 12, 6
    jnet = RenderRayNet(n_layers=n_layers, width=width, positions_dim=pos_dim,
                        directions_dim=dir_dim, skips=(1,))
    wnet = WarpFieldNet(width=8, positions_dim=6, pose_dim=4)
    x = rng.randn(4, pos_dim + dir_dim).astype(np.float32)
    w = rng.randn(4, 10).astype(np.float32)
    params = {
        "model_coarse": jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)),
        "model_warp_field": wnet.init(jax.random.PRNGKey(1), jnp.asarray(w)),
    }
    run_dir = str(tmp_path / "run")
    checkpoints.save_run(run_dir, params)
    torch_dir = str(tmp_path / "torch")
    checkpoints.export_torch_run(run_dir, torch_dir)
    back = checkpoints.import_torch_run(torch_dir, n_layers=n_layers)
    assert set(back) == {"model_coarse", "model_warp_field"}
    for name in back:
        jax.tree_util.tree_map(
            np.testing.assert_array_equal,
            jax.device_get(params[name])["params"], back[name]["params"])
