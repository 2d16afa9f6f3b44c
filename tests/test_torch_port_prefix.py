"""Kernels B's and C's conditioning-prefix rows, off the card: the port's plain
versions (`reference_forward_raw`, `reference_backward_raw`) on raw rows
[prefix (add) | xyz | dir] against the JAX package's `_fused_mlp_v2` and its
VJP (the Pallas kernels in interpret mode, as tests/test_fused_mlp_v2.py runs
them), and the append_smpl_params pipeline under --use_fused_mlp=2 against
JAX's.

Prefix widths: 18 (append_to_nerf's two encoded joints), 64
(append_vertex_locations_to_nerf's vertex embedding) and 621
(append_smpl_params' 69 encoded joints under configs/config.txt). Sizes: 3
layers, width 32, skip 1, L = 4/2, 300 rows (a whole 256-row tile of the JAX
backward and a ragged one); weights drawn by JAX and carried over with
`params_from_jax`, rows, prefix and cotangent from seeded numpy.

Tolerances. float32: the same math in another summation order, 1e-4 of the
largest value (outputs, dX, every dW and db). bfloat16: both round to bf16 at
the same places but sum in other orders, which can flip one rounding that
later layers carry: outputs 2e-2 of the largest (max) and 2e-3 (mean); dX
0.25 of the largest (max; a flipped ReLU bit moves a row by a whole term) and
5e-3 (mean), on the prefix columns and on the xyz/dir columns apart; every dW
and db 3e-2 by relative norm (JAX rounds dW per 256-row tile, autograd once).
The pipeline: rgb_coarse 1e-5 (float32), rgb_fine 2e-3 (an inverse-CDF bin
can flip where u meets a cdf entry), bf16 2e-2.
"""
import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smpl_nerf_tpu import config as jax_config
from smpl_nerf_tpu import pipelines as jax_pipelines
from smpl_nerf_tpu.models import RenderRayNet as JaxRenderRayNet
from smpl_nerf_tpu.ops import fused_mlp as jax_fused
from smpl_nerf_tpu.ops import fused_mlp_v2 as jax_v2
from smpl_nerf_tpu.training import factory as jax_factory
from smpl_nerf_tpu_torch import config as port_config
from smpl_nerf_tpu_torch import pipelines
from smpl_nerf_tpu_torch.models import RenderRayNet
from smpl_nerf_tpu_torch.ops import fused_mlp, fused_mlp_v2
from smpl_nerf_tpu_torch.training import checkpoints, factory

ROWS = 300
F32_REL = 1e-4
FWD_MAX, FWD_MEAN = 2e-2, 2e-3
BWD_DX_MAX, BWD_DX_MEAN, BWD_DW_REL = 0.25, 5e-3, 3e-2
RGB_COARSE_ATOL, RGB_FINE_ATOL, BF16_ATOL = 1e-5, 2e-3, 2e-2


def _nets(add, dtype, seed=0):
    common = dict(n_layers=3, width=32, positions_dim=24, directions_dim=12,
                  additional_input_dim=add, skips=(1,), use_directional_input=True)
    params = JaxRenderRayNet(**common).init(jax.random.PRNGKey(seed),
                                             jnp.zeros((2, add + 36)))
    rs = np.random.RandomState(seed)     # non-zero biases: a misplaced one shows
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.asarray(rs.randn(*p.shape), jnp.float32) if p.ndim == 1 else p,
        params)
    net = RenderRayNet(**common, compute_dtype=fused_mlp._DTYPES[dtype])
    net.load_state_dict(checkpoints.params_from_jax({"m": params})["m"])
    return (jax_fused.MlpSpec(**common, dtype=dtype), params,
            fused_mlp.MlpSpec(**common, dtype=dtype), net)


def _raw_rows(rng, n, add):
    prefix = rng.uniform(-1, 1, (n, add)).astype(np.float32)   # an encoded pose lies in [-1, 1]
    p3 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d3 = rng.randn(n, 3).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=-1, keepdims=True)
    return np.concatenate([prefix, p3, d3], -1)


def _jax_v2(jspec, params, x, g):
    """JAX's `_fused_mlp_v2` (Pallas interpret) and its VJP: (out, dflat, dx)."""
    flat = jax_fused.flatten_params(jspec, params)
    out, vjp = jax.vjp(lambda f, xx: jax_v2._fused_mlp_v2(jspec, f, xx), flat, jnp.asarray(x))
    dflat, dx = vjp(jnp.asarray(g))
    return np.asarray(out), [np.asarray(t, np.float32) for t in dflat], np.asarray(dx)


def _close_max_mean(got, want, rel_max, rel_mean):
    err = np.abs(got - want)
    assert err.max() <= rel_max * np.abs(want).max()
    assert err.mean() <= rel_mean * np.abs(want).mean()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("add", [18, 64, 621])
def test_plain_prefix_rows_match_jax_fused_v2(rng, add, dtype):
    jspec, params, pspec, net = _nets(add, dtype, seed=add)
    x = _raw_rows(rng, ROWS, add)
    g = rng.randn(ROWS, 4).astype(np.float32)
    want_out, want_flat, want_dx = _jax_v2(jspec, params, x, g)
    flat = fused_mlp.flatten_params(pspec, net)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    with torch.no_grad():
        out = fused_mlp_v2.reference_forward_raw(pspec, flat, xt).numpy()
    dflat, dx = fused_mlp_v2.reference_backward_raw(pspec, flat, xt, gt)
    dflat, dx = [t.detach().numpy() for t in dflat], dx.detach().numpy()
    assert out.shape == (ROWS, 4) and dx.shape == (ROWS, add + 6)
    assert len(dflat) == len(want_flat)
    assert np.abs(dx[:, :add]).max() > 0 and np.abs(dx[:, add:]).max() > 0
    if dtype == "float32":
        for a, b in [(out, want_out), (dx, want_dx)] + list(zip(dflat, want_flat)):
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= F32_REL * np.abs(b).max() + 1e-12
        return
    _close_max_mean(out, want_out, FWD_MAX, FWD_MEAN)
    for cols in (slice(0, add), slice(add, add + 6)):       # prefix, then xyz and dir
        _close_max_mean(dx[:, cols], want_dx[:, cols], BWD_DX_MAX, BWD_DX_MEAN)
    for i, (a, b) in enumerate(zip(dflat, want_flat)):
        assert a.shape == b.shape, i
        assert np.linalg.norm(a - b) <= BWD_DW_REL * np.linalg.norm(b) + 1e-12, i


def test_the_prefix_gradient_carries_no_encoding_factor(rng):
    """dX's prefix columns are the VJP of the prefix's bf16 rounding: the
    first and the skip layer's input cotangents on those rows, added, with no
    cos * 2^k factor (the xyz columns carry it). Held in float32, where the
    rows' cotangent is exactly g @ the net's Jacobian on its input."""
    add = 45                                       # the prefix+pos block straddles a chunk
    jspec, params, pspec, net = _nets(add, "float32", seed=1)
    flat = fused_mlp.flatten_params(pspec, net)
    x = torch.from_numpy(_raw_rows(rng, 64, add))
    g = torch.from_numpy(rng.randn(64, 4).astype(np.float32))
    _, dx = fused_mlp_v2.reference_backward_raw(pspec, flat, x, g)
    # the same net on pre-encoded rows (kernel D's plain version): its input
    # cotangent on the prefix columns is the same sum
    pos_m, pos_p, dir_m, dir_p = (torch.as_tensor(m) for m in (
        *fused_mlp_v2.encoding_matrices(3, 4), *fused_mlp_v2.encoding_matrices(3, 2)))
    enc = torch.cat([x[:, :add], torch.sin(x[:, add:add + 3] @ pos_m + pos_p),
                     torch.sin(x[:, add + 3:] @ dir_m + dir_p)], -1).requires_grad_(True)
    (fused_mlp.reference_forward(pspec, flat, enc) * g).sum().backward()
    np.testing.assert_allclose(dx[:, :add].detach().numpy(), enc.grad[:, :add].numpy(),
                               rtol=1e-5, atol=1e-6 * float(enc.grad[:, :add].abs().max()))


# ------------------------------------------------------------ the pipeline

def _argv(dtype, mode):
    return ["--config=/dev/null", "--model_type=append_smpl_params", "--human_pose_encoding=1",
            "--netdepth=3", "--netwidth=32", "--skips=1", "--netdepth_fine=3",
            "--netwidth_fine=32", "--skips_fine=1", "--run_fine=1",
            "--number_coarse_samples=8", "--number_fine_samples=16",
            "--number_frequencies_postitional=4", "--number_frequencies_directional=2",
            "--number_frequencies_pose=4", "--use_identity_pose=1", "--sigma_noise_std=0",
            "--white_background=1", "--near=1", "--far=4", "--use_pallas=1",
            f"--use_fused_mlp={mode}", f"--compute_dtype={dtype}", "--batchsize_val=48"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_append_smpl_params_family_passes_under_mode_2_match_jax(rng, dtype):
    """`FamilyPasses` of append_smpl_params (a 621-wide encoded pose prefix,
    69 joints x (1 + 2 x 4), as configs/config.txt) with --use_fused_mlp=2 on
    the CPU, where both nets take the prefix rows' plain version, against
    JAX's pipeline on its v2 kernels; then, in float32, the same port
    pipeline's loss gradient against the plain nets' (mode 0: the
    PositionalEncoder's sin and cos in place of sin(x @ M + P), 1e-4)."""
    jargs = jax_config.config_parser().parse_args(_argv(dtype, 2))
    models, params, encoders = jax_factory.build_models_and_params(jargs, jax.random.PRNGKey(2))
    rs = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + (0.05 * rs.randn(*p.shape).astype(np.float32)
                                   if p.ndim == 1 else 0.0), jax.device_get(params))
    jpipe = jax_pipelines.build_pipeline(jax_pipelines.RenderConfig.from_args(jargs), models,
                                         encoders, {})
    R = 12
    origins = np.tile(np.asarray([[0, 0, 2.4]], np.float32), (R, 1))
    dirs = rng.uniform(-0.3, 0.3, (R, 3)).astype(np.float32)
    dirs[:, 2] = -1.0
    batch = {"ray_translation": origins, "ray_direction": dirs,
             "human_pose": rng.uniform(-0.5, 0.5, (R, 69)).astype(np.float32)}
    want = jpipe(params, {k: jnp.asarray(v) for k, v in batch.items()}, None, False)

    ported = {}
    for mode in (2, 0):
        args = port_config.config_parser().parse_args(_argv(dtype, mode))
        pmodels, pencoders = factory.build_models_and_params(args, device="cpu")
        for name, sd in checkpoints.params_from_jax(params).items():
            pmodels[name].load_state_dict(sd)
        ported[mode] = pipelines.build_pipeline(pipelines.RenderConfig.from_args(args), pmodels,
                                                pencoders)
    pipe = ported[2]
    assert isinstance(pipe.passes, pipelines.FamilyPasses)
    assert pipe.models["model_coarse"].additional_input_dim == 69 * 9
    with torch.no_grad():
        got = pipe({k: torch.from_numpy(v) for k, v in batch.items()}, train=False)
    assert set(got) == set(want)
    if dtype == "float32":
        np.testing.assert_allclose(got["rgb_coarse"].numpy(), np.asarray(want["rgb_coarse"]),
                                   atol=RGB_COARSE_ATOL)
        np.testing.assert_allclose(got["rgb_fine"].numpy(), np.asarray(want["rgb_fine"]),
                                   atol=RGB_FINE_ATOL)
    else:
        for key in ("rgb_coarse", "rgb_fine"):
            assert np.abs(got[key].float().numpy() - np.asarray(want[key])).max() < BF16_ATOL

    if dtype != "float32":
        return
    grads = {}
    for mode, p in ported.items():
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        out = p(tb, train=False)
        loss = sum(out[k].float().square().mean() for k in ("rgb_coarse", "rgb_fine"))
        loss.backward()
        grads[mode] = [q.grad.clone() for q in p.models["model_coarse"].parameters()]
    for a, b in zip(grads[2], grads[0]):
        assert float((a - b).norm()) <= F32_REL * float(b.norm()) + 1e-12
