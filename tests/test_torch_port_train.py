"""The port's training slice vs the JAX package, on the CPU.

The v2 backward's plain version against the Pallas backward kernel in
interpret mode, the mode-1 autograd Function against `jax.grad` through the
JAX `fused_apply`, the loss, the optimizer groups against optax, 20 train
steps of nerf and smpl_nerf against the JAX loss + optimizer, EMA, and the
resume state. Weights are drawn by JAX and carried over with
`params_from_jax`; inputs come from seeded numpy; every run uses rng=None
(jitter 0.5, no sigma noise). Sizes: 2-3 layers, width 32, 8+8 samples,
<= 256 rays.

Tolerances: float32 gradients rtol 1e-4 (same math, another summation order);
bf16 gradients by relative norm <= 3e-2 (torch's casts round where jax.vjp
rounds, but a tile's dW is rounded per 256 rows there and once here, and one
flipped bf16 rounding carries through the chain); losses 1e-5; optimizer
1e-6; the 20-step loss trajectory 2e-3 relative, as
tests/test_training_parity.py holds JAX to a torch oracle.
"""
import argparse
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from smpl_nerf_tpu import config as jax_config
from smpl_nerf_tpu import pipelines as jax_pipelines
from smpl_nerf_tpu.models import RenderRayNet as JaxRenderRayNet
from smpl_nerf_tpu.ops import fused_mlp as jax_fused
from smpl_nerf_tpu.ops import fused_mlp_v2 as jax_v2
from smpl_nerf_tpu.training import factory as jax_factory
from smpl_nerf_tpu.training import solver as jax_solver
from smpl_nerf_tpu_torch import config as port_config
from smpl_nerf_tpu_torch import pipelines
from smpl_nerf_tpu_torch.core import sampling
from smpl_nerf_tpu_torch.models import RenderRayNet
from smpl_nerf_tpu_torch.ops import fused_mlp, fused_mlp_v2
from smpl_nerf_tpu_torch.training import checkpoints, factory, solver


def to_np(t):
    return t.detach().float().cpu().numpy()


# -------------------------------------------------- kernel C's plain version

def _nets(add, dtype, width=32, n_layers=3, skips=(1,), use_dir=True, seed=0):
    common = dict(n_layers=n_layers, width=width, positions_dim=24, directions_dim=12,
                  additional_input_dim=add, skips=tuple(skips), use_directional_input=use_dir)
    jnet = JaxRenderRayNet(**common)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((2, 36 + add)))
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.asarray(rs.randn(*p.shape), jnp.float32) if p.ndim == 1 else p,
        params)
    net = RenderRayNet(**common, compute_dtype=getattr(torch, dtype))
    net.load_state_dict(checkpoints.params_from_jax({"m": params})["m"])
    return (jax_fused.MlpSpec(**common, dtype=dtype), params,
            fused_mlp.MlpSpec(**common, dtype=dtype), net)


def _raw_rows(rng, n, add):
    pre = rng.randn(n, add).astype(np.float32)
    p3 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d3 = rng.randn(n, 3).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=-1, keepdims=True)
    return np.concatenate([pre, p3, d3], -1)


@pytest.mark.parametrize("add,kw", [(0, {}), (8, {}), (0, {"skips": (0, 1), "use_dir": False})])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_backward_raw_matches_jax_pallas_backward_interpret(rng, add, kw, dtype):
    jspec, params, pspec, net = _nets(add, dtype, **kw)
    x = _raw_rows(rng, 70, add)          # not a multiple of the Pallas backward tile
    g = rng.randn(70, 4).astype(np.float32)
    jflat = jax_fused.flatten_params(jspec, params)
    want_flat, want_dx = jax_v2._pallas_backward(jspec, jax_v2._enc_mats(jspec), jflat,
                                                 jnp.asarray(x), jnp.asarray(g), True)
    got_flat, got_dx = fused_mlp_v2.reference_backward_raw(
        pspec, fused_mlp.flatten_params(pspec, net), torch.from_numpy(x), torch.from_numpy(g))
    assert len(got_flat) == len(want_flat) == 2 * (pspec.n_layers + 5)
    pairs = [("dx", got_dx, want_dx)] + [(f"flat[{i}]", a, b)
                                         for i, (a, b) in enumerate(zip(got_flat, want_flat))]
    for name, got, want in pairs:
        got, want = to_np(got), np.asarray(want, np.float32)
        assert got.shape == want.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                       err_msg=name)
        else:
            assert np.linalg.norm(got - want) <= 3e-2 * np.linalg.norm(want), name


def test_fused_apply_raw_on_cpu_differentiates_the_plain_version(rng):
    _, _, pspec, net = _nets(0, "float32")
    x = torch.from_numpy(_raw_rows(rng, 40, 0)).requires_grad_(True)
    g = torch.from_numpy(rng.randn(40, 4).astype(np.float32))
    before = (fused_mlp_v2.launches, fused_mlp_v2.launches_bwd)
    (fused_mlp_v2.fused_apply_raw(pspec, net, x) * g).sum().backward()
    assert (fused_mlp_v2.launches, fused_mlp_v2.launches_bwd) == before
    want_flat, want_dx = fused_mlp_v2.reference_backward_raw(
        pspec, fused_mlp.flatten_params(pspec, net), x.detach(), g)
    np.testing.assert_allclose(to_np(x.grad), to_np(want_dx), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(to_np(net.rgb_out_layer.weight.grad.t()), to_np(want_flat[-2]),
                               rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp_v2.fused_backward_cuda(
            fused_mlp.MlpSpec(**{**pspec.__dict__, "dtype": "bfloat16"}), net, x.detach(), g)


# ----------------------------------------------- mode 1: the autograd Function

@pytest.mark.parametrize("add", [0, 18])
@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_mode1_autograd_function_matches_jax_grad_through_fused_apply(rng, monkeypatch, add,
                                                                      dtype, rtol):
    """The Function's backward (recompute + autograd through the plain
    version) against jax.grad through the JAX custom_vjp. Its forward would
    launch kernel D; here the plain forward stands in for the kernel."""
    jspec, params, pspec, net = _nets(add, dtype)
    monkeypatch.setattr(
        fused_mlp, "fused_forward_cuda",
        lambda spec, m, x: fused_mlp.reference_forward(spec, fused_mlp.flatten_params(spec, m),
                                                       x).detach())
    x = rng.uniform(-1, 1, (50, jspec.in_dim)).astype(np.float32)
    g = rng.randn(50, 4).astype(np.float32)

    def jax_loss(p, xx):
        return jnp.sum(jax_fused.fused_apply(jspec, p, xx) * g)

    want_p, want_x = jax.grad(jax_loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fused_mlp.FusedMlpV1.apply(pspec, net, xt, *fused_mlp.flatten_params(pspec, net))
    (out * torch.from_numpy(g)).sum().backward()

    def close(got, want, name):
        got, want = to_np(got), np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max(),
                                       err_msg=name)
        else:
            assert np.linalg.norm(got - want) <= rtol * np.linalg.norm(want), name

    close(xt.grad, want_x, "dx")
    want_sd = checkpoints.params_from_jax({"m": jax.device_get(want_p)})["m"]
    for key, p in net.named_parameters():
        close(p.grad, want_sd[key].numpy(), key)


# ---------------------------------------------------------------- the slice

def _argv(model_type, extra=()):
    return ["--config=/dev/null", f"--model_type={model_type}", "--human_pose_encoding=1",
            "--netdepth=3", "--netwidth=32", "--skips=1", "--netdepth_fine=3",
            "--netwidth_fine=32", "--skips_fine=1", "--run_fine=1", "--netwidth_warp=16",
            "--netdepth_warp=2", "--number_coarse_samples=8", "--number_fine_samples=8",
            "--number_frequencies_postitional=4", "--number_frequencies_directional=2",
            "--number_frequencies_pose=2", "--sigma_noise_std=0", "--white_background=0",
            "--near=1", "--far=4", "--use_pallas=0", "--lrate=1e-3", "--batchsize_val=64",
            *extra]


def _setup(model_type, extra=(), seed=0):
    """(jax loss_fn, jax params, jax args, port pipeline, port args) on shared weights."""
    jargs = jax_config.config_parser().parse_args(_argv(model_type, extra))
    jmodels, params, jenc = jax_factory.build_models_and_params(jargs, jax.random.PRNGKey(seed))
    jpipe = jax_pipelines.build_pipeline(jax_pipelines.RenderConfig.from_args(jargs), jmodels,
                                         jenc, {})
    pargs = port_config.config_parser().parse_args(_argv(model_type, extra))
    models, encoders = factory.build_models_and_params(pargs, device="cpu")
    for name, sd in checkpoints.params_from_jax(jax.device_get(params)).items():
        models[name].load_state_dict(sd)
    pipe = pipelines.build_pipeline(pipelines.RenderConfig.from_args(pargs), models, encoders)
    return jax_solver.make_loss_fn(jpipe), params, jargs, pipe, pargs


def _batch(rng, R, with_pose):
    """Rays of a camera at z = 2.4 looking at a smooth target: a consistent scene."""
    origins = np.tile(np.asarray([[0, 0, 2.4]], np.float32), (R, 1))
    dirs = rng.uniform(-0.4, 0.4, (R, 3)).astype(np.float32)
    dirs[:, 2] = -1.0
    rgb = 0.5 + 0.4 * np.sin(3.0 * dirs[:, :1] + np.asarray([[0.0, 1.0, 2.0]], np.float32))
    batch = {"ray_translation": origins, "ray_direction": dirs, "rgb": rgb.astype(np.float32)}
    if with_pose:
        batch["human_pose"] = rng.uniform(-0.5, 0.5, (R, 69)).astype(np.float32)
    return batch


@pytest.mark.parametrize("model_type", ["nerf", "smpl_nerf", "append_smpl_params"])
@pytest.mark.parametrize("masked", [False, True])
def test_make_loss_fn_matches_jax_on_one_batch(rng, model_type, masked):
    jloss, params, _, pipe, _ = _setup(model_type)
    batch = _batch(rng, 64, model_type != "nerf")
    mask = (np.arange(64) < 40).astype(np.float32) if masked else None
    want, want_aux = jloss(params, {k: jnp.asarray(v) for k, v in batch.items()}, None, False,
                           None if mask is None else jnp.asarray(mask))
    got, got_aux = solver.make_loss_fn(pipe)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, None, False,
        None if mask is None else torch.from_numpy(mask))
    assert set(got_aux) == set(want_aux) == {"loss", "loss_coarse", "loss_fine"}
    for key in got_aux:
        assert float(got_aux[key].detach()) == pytest.approx(float(want_aux[key]), abs=1e-5), key
    assert float(got.detach()) == pytest.approx(float(want), abs=1e-5)
    if masked:      # the padded rays really are left out
        full, _ = solver.make_loss_fn(pipe)({k: torch.from_numpy(v) for k, v in batch.items()},
                                            None, False)
        assert abs(float(full.detach()) - float(got.detach())) > 1e-6


class _Holder(torch.nn.Module):
    def __init__(self, value):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(value))


@pytest.mark.parametrize("flags", [
    {"lrate": 1e-3, "lrate_pose": 2e-3},                                       # Adam, two rates
    {"lrate": 1e-3, "lrate_pose": 2e-3, "weight_decay": 0.1},                  # AdamW, decoupled
    {"lrate": 1e-3, "lrate_pose": 2e-3, "lrate_decay": 1},                     # shared decay
    {"lrate": 1e-3, "lrate_pose": 2e-3, "lrate_decay": 2, "lrate_pose_decay": 1},
    {"lrate": 0.0, "lrate_pose": 2e-3, "weight_decay": 0.1},                   # lr 0: net frozen
    {"lrate": 1e-3, "lrate_pose": 0.0},
])
def test_make_optimizer_matches_optax_on_a_fixed_gradient_sequence(rng, flags):
    args = argparse.Namespace(**{"weight_decay": 0, "lrate_decay": 0, "lrate_pose_decay": 0,
                                 **flags})
    # small values and rates: the float32 rounding of p + update, and optax's
    # float32 bias correction (1 - b^t cancels to ~1e-5 relative in the first
    # steps), stay far below 1e-6, while a misplaced eps, weight decay or
    # schedule moves p by 1e-5 or more per step
    init = {"model_coarse": 0.1 * rng.randn(5, 3).astype(np.float32),
            "model_warp_field": 0.1 * rng.randn(4).astype(np.float32),
            "smpl_estimator": 0.1 * rng.randn(6).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in init.items()}
             for _ in range(40)]
    params = {k: {"w": jnp.asarray(v)} for k, v in init.items()}
    tx = jax_solver.make_optimizer(params, args, "smpl_nerf")
    state = tx.init(params)
    models = {k: _Holder(v) for k, v in init.items()}
    opt = solver.make_optimizer(models, args, "smpl_nerf")
    assert opt.labels == {"model_coarse": "net", "model_warp_field": "net",
                          "smpl_estimator": "pose"}

    @jax.jit
    def jax_step(params, state, g):
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state

    for g in grads:
        params, state = jax_step(params, state, {k: {"w": jnp.asarray(v)} for k, v in g.items()})
        opt.zero_grad()
        for k, m in models.items():
            m.w.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k, m in models.items():
        np.testing.assert_allclose(to_np(m.w), np.asarray(params[k]["w"]), atol=1e-6,
                                   err_msg=k)
    frozen = [k for k in init if (flags["lrate_pose"] if k == "smpl_estimator"
                                  else flags["lrate"]) == 0.0]
    for k in frozen:                    # not even weight decay moves them
        np.testing.assert_array_equal(to_np(models[k].w), init[k])
    assert bool(frozen) == (0.0 in (flags["lrate"], flags["lrate_pose"]))


def test_frozen_nerf_leaves_the_nets_out_of_the_optimizer(rng):
    args = argparse.Namespace(lrate=1e-2, lrate_pose=0.1, weight_decay=0, lrate_decay=0,
                              lrate_pose_decay=0)
    models = {"model_coarse": _Holder([1.0]), "model_fine": _Holder([2.0]),
              "smpl_estimator": _Holder([3.0])}
    opt = solver.make_optimizer(models, args, "image_wise_dynamic", frozen_nerf=True)
    assert opt.labels == {"model_coarse": "frozen", "model_fine": "frozen",
                          "smpl_estimator": "pose"}
    for m in models.values():
        m.w.grad = torch.ones(1)
    opt.step()
    assert models["model_coarse"].w.item() == 1.0 and models["model_fine"].w.item() == 2.0
    assert models["smpl_estimator"].w.item() != 3.0
    none = solver.make_optimizer(models, argparse.Namespace(lrate=0.0, lrate_pose=0.0), "nerf")
    none.step()                          # nothing trains: a no-op, not an error
    assert none.state_dict() == {}


@pytest.mark.parametrize("model_type,fused", [("nerf", 0), ("smpl_nerf", 0), ("smpl_nerf", 2)])
def test_twenty_train_steps_and_ema_match_jax(rng, model_type, fused):
    decay = 0.9
    extra = ("--param_ema=0.9", f"--use_fused_mlp={fused}")
    jloss, params, jargs, pipe, pargs = _setup(model_type, extra, seed=3)
    batch = _batch(rng, 256, model_type != "nerf")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = jax_solver.make_optimizer(params, jargs, model_type)
    state = tx.init(params)
    ema = jax.tree.map(lambda x: x * 1.0, params)

    @jax.jit
    def jax_step(params, state, ema):
        (loss, _), grads = jax.value_and_grad(jloss, has_aux=True)(params, jbatch, None, True)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        ema = jax.tree.map(lambda e, p: decay * e + (1.0 - decay) * p, ema, params)
        return params, state, ema, loss

    sol = solver.Solver(pipe, pargs)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    raw = lambda: {name: {k: to_np(v).copy() for k, v in m.state_dict().items()}
                   for name, m in sol.models.items()}
    shadow = raw()
    ours, theirs = [], []
    for _ in range(20):
        params, state, ema, loss = jax_step(params, state, ema)
        theirs.append(float(loss))
        ours.append(float(sol.train_step(tbatch, None)["loss"]))
        shadow = {name: {k: decay * shadow[name][k] + (1.0 - decay) * v for k, v in sd.items()}
                  for name, sd in raw().items()}
    np.testing.assert_allclose(ours, theirs, rtol=2e-3)
    assert ours[-1] < 0.9 * ours[0]

    # the EMA recursion, exactly, on the port's own weights after each step
    assert sol.eval_params is sol.ema_params
    for name, sd in shadow.items():
        for key, value in sd.items():
            np.testing.assert_allclose(to_np(sol.ema_params[name][key]), value, atol=1e-6,
                                       err_msg=f"ema {name}.{key}")
    # and against JAX by norm: where a gradient is near 0, Adam's normalised
    # update amplifies a rounding difference to ~lr per step, so single
    # weights drift while the trajectory (the losses above) agrees
    want_ema = checkpoints.params_from_jax(jax.device_get(ema))
    want_raw = checkpoints.params_from_jax(jax.device_get(params))
    for name in want_ema:
        for key, value in want_ema[name].items():
            for what, got, want in (("ema", sol.ema_params[name][key], value),
                                    ("raw", sol.models[name].state_dict()[key],
                                     want_raw[name][key])):
                assert (np.linalg.norm(to_np(got) - want.numpy())
                        <= 5e-3 * np.linalg.norm(want.numpy()) + 1e-4), (what, name, key)
    # validation runs on the EMA weights and hands the raw ones back untouched
    raw_before = {k: v.clone() for k, v in sol.models["model_coarse"].state_dict().items()}
    arrays = {k: v for k, v in tbatch.items() if k != "human_pose"}
    arrays["image_indices"] = torch.zeros(256, dtype=torch.int32)
    if "human_pose" in tbatch:
        arrays["human_pose_table"] = tbatch["human_pose"][:1]
    val = sol._validate(arrays, 100)
    assert np.isfinite(val)
    for k, v in sol.models["model_coarse"].state_dict().items():
        assert torch.equal(v, raw_before[k]), k


def test_save_train_state_round_trips_and_resumes_the_same_trajectory(rng, tmp_path):
    _, _, _, pipe, pargs = _setup("smpl_nerf", ("--param_ema=0.9",), seed=5)
    tbatch = {k: torch.from_numpy(v) for k, v in _batch(rng, 64, True).items()}
    sol = solver.Solver(pipe, pargs)
    for _ in range(3):
        sol.train_step(tbatch, None)
    run_dir = str(tmp_path / "run")
    sol.save_train_state(run_dir, epoch=4, best_val=0.125)
    checkpoints.save_run(run_dir, sol.eval_params)
    assert os.path.exists(os.path.join(run_dir, "train_state.pt"))
    state = checkpoints.load_train_state(run_dir)
    assert state["epoch"] == 4 and state["best_val"] == 0.125
    assert set(state["optimizer"]) == {"optimizer", "scheduler"}
    assert checkpoints.load_train_state(str(tmp_path / "nowhere")) is None

    # a fresh solver, started as --load_run starts it: EMA weights from the
    # run dir, then the resume state puts the raw weights and moments back
    _, _, _, pipe2, _ = _setup("smpl_nerf", ("--param_ema=0.9",), seed=6)
    for name, sd in checkpoints.load_run(run_dir).items():
        pipe2.models[name].load_state_dict(sd)
    sol2 = solver.Solver(pipe2, pargs)
    assert sol2.restore_train_state(run_dir)
    assert sol2.epoch_offset == 5 and sol2.best_val == 0.125
    for name, model in sol.models.items():
        for key, value in model.state_dict().items():
            assert torch.equal(sol2.models[name].state_dict()[key], value), (name, key)
            assert torch.equal(sol2.ema_params[name][key], sol.ema_params[name][key])
    a = float(sol.train_step(tbatch, None)["loss"])
    b = float(sol2.train_step(tbatch, None)["loss"])
    assert a == b
    for name, model in sol.models.items():      # same moments: the same next weights
        for key, value in model.state_dict().items():
            np.testing.assert_allclose(to_np(sol2.models[name].state_dict()[key]), to_np(value),
                                       atol=1e-7)
    assert not solver.Solver(pipe2, pargs).restore_train_state(str(tmp_path / "nowhere"))


def test_weight_pack_cache_sees_an_optimizer_step(rng):
    """The pack is keyed on the parameters' `_version`, which torch.optim
    bumps when it updates them in place."""
    _, _, _, pipe, pargs = _setup("nerf", ("--compute_dtype=bfloat16",))
    net = pipe.models["model_coarse"]
    spec = fused_mlp.spec_from_model(net)
    first = fused_mlp.packed(spec, net, torch.device("cpu"))
    assert fused_mlp.packed(spec, net, torch.device("cpu")) is first
    sol = solver.Solver(pipe, pargs)
    sol.train_step({k: torch.from_numpy(v) for k, v in _batch(rng, 32, False).items()}, None)
    second = fused_mlp.packed(spec, net, torch.device("cpu"))
    assert second is not first
    w, _, table = second
    k0 = int(table[0, 2]) * int(table[0, 3])
    want = net.positions_pose_input.weight.detach().t().to(torch.bfloat16)
    assert torch.equal(w[:k0].view(int(table[0, 2]), -1)[:want.shape[0]], want)
    assert not torch.equal(first[0], w)


def test_fine_sampling_under_grad_takes_detached_inputs(rng):
    """Kernel A's wrapper is called inside a differentiated step: its inputs
    are detached and its samples carry no gradient, with either route."""
    z = torch.linspace(1, 4, 8).repeat(5, 1)
    weights = torch.rand(5, 8, requires_grad=True)
    origins, dirs = torch.zeros(5, 3), torch.ones(5, 3, requires_grad=True)
    with torch.enable_grad():
        for use_kernel_route in (False, True):
            z_all, samples = sampling.fine_sampling(origins, dirs, z, weights * 2.0, 8,
                                                    use_kernel_route)
            assert not z_all.requires_grad and samples.requires_grad
            (grad,) = torch.autograd.grad(samples.sum(), dirs)
            np.testing.assert_allclose(to_np(grad), to_np(z_all.sum(-1, keepdim=True)
                                                          .expand(5, 3)), rtol=1e-6)
