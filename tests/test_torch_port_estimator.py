"""The port's CNN pose estimator and AppendVerticesNet against the JAX package, on the CPU.

`models/smpl_estimator.SmplEstimator` (eval forward on carried weights and
BatchNorm statistics, a training step's loss and gradients, the running
statistics after 3 steps), `training/estimator.train_estimator` (2 epochs on
a JAX-generated split), the training CLI's route to it before any render
pipeline is built, the run directory's round trip with the BatchNorm
statistics (`load_estimator`), `params_from_jax` on Conv / BatchNorm trees,
and `models/append_vertices_net.AppendVerticesNet`.

Dropout draws from another generator in each package, so the training
comparisons switch it off on both sides: flax's `nn.Dropout` is patched to the
identity and the port's `dropout` layer replaced by `nn.Identity`. Adam's
first update moves every weight by about lr whatever its gradient's size, so
a gradient that is rounding noise (a conv bias before BatchNorm has zero
gradient in exact arithmetic) moves its weight by +-lr at random in each
package, and that enters the running mean; the multi-step comparisons
therefore run plain SGD on both sides (`optax.sgd`, `torch.optim.SGD`, patched
in for Adam in the trainers); the solver tests hold Adam itself. Sizes:
32x32 and 64x32 images (five 2x2 pools need 32 a side), batches of 3.

Tolerances, each with its reason: the eval forward 1e-5 (five float32
convolutions summed in another order); a training step's loss 1e-5 relative,
its gradients 1e-4 of each tensor's largest entry (batch statistics are
reduced in another order, and their rounding enters every gradient through
the normalisation), the conv biases' (zero in exact arithmetic) 1e-4 of their
conv weight's largest gradient; the running statistics after 3 steps 1e-4
relative; the epoch losses of train_estimator 1e-4 relative plus the 5e-6 of
JAX's printed rounding, on random images. On the generated human views most
pixels are the white background, so a batch's channel variance is tiny next
to its mean square and E[x^2] - E[x]^2 (flax's formula, which the port keeps)
cancels: there the port's train-mode forward is held to 1e-5 of the same
module in float64, where JAX's on the CPU lies ~1e-3 away (held to 5e-3).
"""
import _torch_threads  # noqa: F401

import os
from typing import Optional

import flax.linen as flax_nn
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from smpl_nerf_tpu import config as jax_config
from smpl_nerf_tpu.data import datasets as jax_datasets
from smpl_nerf_tpu.data import generate as jax_generate
from smpl_nerf_tpu.models.append_vertices_net import AppendVerticesNet as JaxAppendVerticesNet
from smpl_nerf_tpu.models.smpl_estimator import SmplEstimator as JaxSmplEstimator
from smpl_nerf_tpu.training import estimator as jax_estimator
from smpl_nerf_tpu.training import factory as jax_factory
from smpl_nerf_tpu_torch import config as port_config
from smpl_nerf_tpu_torch.cli import inference
from smpl_nerf_tpu_torch.cli import train as train_cli
from smpl_nerf_tpu_torch.data import datasets
from smpl_nerf_tpu_torch.models.append_vertices_net import AppendVerticesNet
from smpl_nerf_tpu_torch.models.smpl_estimator import SmplEstimator
from smpl_nerf_tpu_torch.training import checkpoints, estimator, factory

FWD_ATOL, LOSS_REL, GRAD_REL, STATS_REL, EPOCH_REL, PRINT_ATOL = 1e-5, 1e-5, 1e-4, 1e-4, 1e-4, 5e-6
GENERATED_JAX_ATOL = 5e-3


def to_np(t):
    return t.detach().float().cpu().numpy()


class NoDropout(flax_nn.Module):
    """flax Dropout switched off: the identity, whatever the flags."""
    rate: float = 0.0
    deterministic: Optional[bool] = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


def _flax_estimator(rng, size, human_size=2, seed=0):
    """A flax SmplEstimator with random biases and BatchNorm statistics."""
    model = JaxSmplEstimator(human_size=human_size)
    variables = jax.device_get(model.init(jax.random.PRNGKey(seed),
                                          jnp.zeros((1,) + size + (3,))))
    variables = jax.tree_util.tree_map_with_path(
        lambda path, p: (np.asarray(p) + 0.05 * rng.randn(*p.shape).astype(np.float32)
                         if path[-1].key in ("bias", "scale", "mean") else
                         np.asarray(p) * rng.uniform(0.5, 2.0, p.shape).astype(np.float32)
                         if path[-1].key == "var" else np.asarray(p)), variables)
    return model, variables


def _port_estimator(variables, size, human_size=2):
    model = SmplEstimator(human_size, size)
    model.load_state_dict(checkpoints.params_from_jax({"e": variables})["e"])
    return model


@pytest.mark.parametrize("size", [(32, 32), (64, 32)])
def test_eval_forward_matches_flax_with_carried_weights(rng, size):
    model, variables = _flax_estimator(rng, size)
    port = _port_estimator(variables, size).eval()
    sd = port.state_dict()
    assert sd["conv1.weight"].shape == (32, 16, 3, 3)                     # OIHW
    assert sd["fc1.weight"].shape == (500, size[0] // 32 * size[1] // 32 * 128)
    np.testing.assert_array_equal(to_np(sd["bn2.running_var"]),
                                  variables["batch_stats"]["bn2"]["var"])
    x = rng.uniform(0, 1, (3,) + size + (3,)).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = to_np(port(torch.from_numpy(x)))
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)


def test_training_steps_match_flax_with_dropout_off(rng, monkeypatch):
    """Three SGD steps on batch statistics: each step's loss, the first
    step's gradients, and the running statistics after the third."""
    monkeypatch.setattr(flax_nn, "Dropout", NoDropout)
    size = (32, 32)
    model, variables = _flax_estimator(rng, size)
    port = _port_estimator(variables, size)
    port.dropout = torch.nn.Identity()
    port.train()
    tx = optax.sgd(1e-2)
    opt_state = tx.init(variables["params"])
    opt = torch.optim.SGD(port.parameters(), lr=1e-2)
    params, stats = variables["params"], variables["batch_stats"]

    @jax.jit
    def jax_step(params, stats, opt_state, x, y):
        def loss_fn(p):
            out, upd = model.apply({"params": p, "batch_stats": stats}, x, train=True,
                                   mutable=["batch_stats"])
            return jnp.mean((out - y) ** 2), upd["batch_stats"]
        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, opt_state, loss, grads

    for step in range(3):
        x = rng.uniform(0, 1, (3,) + size + (3,)).astype(np.float32)
        y = rng.uniform(-1, 1, (3, 2)).astype(np.float32)
        params, stats, opt_state, want_loss, grads = jax_step(params, stats, opt_state,
                                                              jnp.asarray(x), jnp.asarray(y))
        opt.zero_grad()
        loss = torch.mean((port(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2)
        loss.backward()
        assert float(loss.detach()) == pytest.approx(float(want_loss), rel=LOSS_REL)
        if step == 0:
            want_grads = checkpoints.params_from_jax({"e": {"params": jax.device_get(grads)}})["e"]
            for name, p in port.named_parameters():
                w = to_np(want_grads[name])
                scale = to_np(want_grads[name.replace(".bias", ".weight")] if
                              name.startswith("conv") else want_grads[name])
                np.testing.assert_allclose(to_np(p.grad), w, atol=GRAD_REL * np.abs(scale).max(),
                                           err_msg=name)
        opt.step()
    want_stats = checkpoints.params_from_jax({"e": {"batch_stats": jax.device_get(stats)}})["e"]
    for name, value in want_stats.items():
        w = to_np(value)
        np.testing.assert_allclose(to_np(port.state_dict()[name]), w,
                                   rtol=STATS_REL, atol=STATS_REL * np.abs(w).max(), err_msg=name)
    # flax keeps the BIASED batch variance: torch's BatchNorm2d would not
    assert not np.allclose(to_np(port.state_dict()["bn4.running_var"]),
                           np.asarray(variables["batch_stats"]["bn4"]["var"]))


# -------------------------------------------------------- trainer and CLI

@pytest.fixture(scope="module")
def est_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds_est")
    parser = jax_config.dataset_config_parser()
    jax_generate.create_dataset(parser.parse_args([
        f"--save_dir={root}", "--dataset_type=smpl_nerf", "--resolution=32",
        "--camera_path=circle", "--number_steps=4", "--multi_human_pose=1",
        "--human_number_steps=2", "--human_start_angle=0", "--human_end_angle=60",
        "--train_val_ratio=0.75"]), parser)
    return str(root)


def _argv(directory, extra=()):
    return ["--config=/dev/null", "--model_type=smpl_estimator", f"--dataset_dir={directory}",
            "--num_epochs=2", "--batchsize=3", "--lrate=1e-3", "--render_gif=0", *extra]


def _random_split_dir(rng, root):
    """A split of random 32x32 images with random arm poses (6 train, 2 val)."""
    for split, n in (("train", 6), ("val", 2)):
        poses = np.zeros((n, 69), np.float32)
        poses[:, [38, 41]] = rng.uniform(0, 1, (n, 2))
        datasets.write_dataset(os.path.join(root, split), rng.uniform(0, 1, (n, 32, 32, 3)),
                               np.stack([np.eye(4, dtype=np.float32)] * n), 0.9, poses)
    return str(root)


def test_train_estimator_matches_jax_losses(rng, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(flax_nn, "Dropout", NoDropout)
    monkeypatch.setattr(jax_estimator.optax, "adam", optax.sgd)
    monkeypatch.setattr(estimator.torch.optim, "Adam", torch.optim.SGD)
    directory = _random_split_dir(rng, tmp_path / "d")
    jargs = jax_config.config_parser().parse_args(_argv(directory))
    pargs = port_config.config_parser().parse_args(_argv(directory))
    jtrain, jval = (jax_datasets.load_dataset(os.path.join(directory, s), "smpl_estimator",
                                              jargs) for s in ("train", "val"))
    ptrain, pval = (datasets.load_dataset(os.path.join(directory, s), "smpl_estimator", pargs)
                    for s in ("train", "val"))
    np.testing.assert_array_equal(ptrain.images, jtrain.images)
    assert ptrain.images.shape == (6, 32, 32, 3)
    jmodels, params, _ = jax_factory.build_models_and_params(jargs, jax.random.PRNGKey(0),
                                                             {"image_size": (32, 32)})
    capsys.readouterr()
    jax_estimator.train_estimator(jargs, None, jtrain, jval, jmodels, params)
    printed = [line for line in capsys.readouterr().out.splitlines()
               if line.startswith("[estimator epoch")]
    want = [(float(line.split()[4]), float(line.split()[6])) for line in printed]
    models, _ = factory.build_models_and_params(pargs, device="cpu",
                                                extras=factory.dataset_extras(pargs, ptrain))
    models["smpl_estimator"].load_state_dict(
        checkpoints.params_from_jax({"e": jax.device_get(params["smpl_estimator"])})["e"])
    models["smpl_estimator"].dropout = torch.nn.Identity()
    final, history = estimator.train_estimator(pargs, None, ptrain, pval, models)
    assert len(want) == len(history["train_loss"]) == 2
    for (w_train, w_val), g_train, g_val in zip(want, history["train_loss"],
                                                history["val_loss"]):
        assert g_train == pytest.approx(w_train, rel=EPOCH_REL, abs=PRINT_ATOL)
        assert g_val == pytest.approx(w_val, rel=EPOCH_REL, abs=PRINT_ATOL)
    assert set(final) == {"smpl_estimator"} and "bn0.running_mean" in final["smpl_estimator"]


def test_train_mode_forward_on_generated_views_is_float64_accurate(est_dir, monkeypatch):
    """Mostly-white views: the port's batch statistics stay within float32
    rounding of a float64 evaluation of the same module and weights."""
    monkeypatch.setattr(flax_nn, "Dropout", NoDropout)
    args = port_config.config_parser().parse_args(_argv(est_dir))
    x = datasets.load_dataset(os.path.join(est_dir, "train"), "smpl_estimator", args).images[:3]
    model, variables = _flax_estimator(np.random.RandomState(2), (32, 32))
    port = _port_estimator(variables, (32, 32))
    port.dropout = torch.nn.Identity()
    port.train()
    want_jax, _ = model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = to_np(port(torch.from_numpy(x)))
        ref = port.double()(torch.from_numpy(x).double()).numpy()
    np.testing.assert_allclose(got, ref, atol=FWD_ATOL)
    np.testing.assert_allclose(np.asarray(want_jax), ref, atol=GENERATED_JAX_ATOL)


def test_the_cli_routes_the_estimator_before_any_pipeline_and_its_run_reloads(
        est_dir, tmp_path, monkeypatch, capsys):
    def no_pipeline(*args, **kwargs):
        raise AssertionError("a render pipeline was built for smpl_estimator")

    monkeypatch.setattr(train_cli, "build_pipeline", no_pipeline)
    run_dir = str(tmp_path / "run")
    final, history = train_cli.train(_argv(est_dir), log_dir=run_dir, device="cpu")
    assert "[estimator epoch 1]" in capsys.readouterr().out
    assert np.isfinite(history["train_loss"]).all() and len(history["val_loss"]) == 2
    # train() also logs to a SummaryWriter on the run dir where tensorboard imports
    assert sorted(n for n in os.listdir(run_dir) if not n.startswith("events.out.")) == [
        "config.txt", "create_dataset_config.txt", "model_smpl_estimator.pt"]
    loaded = estimator.load_estimator(run_dir)
    sd = loaded.state_dict()
    assert set(sd) == set(final["smpl_estimator"])
    for name, value in final["smpl_estimator"].items():
        assert torch.equal(sd[name], value), name                 # BatchNorm statistics too
    assert not torch.equal(sd["bn0.running_mean"], torch.zeros_like(sd["bn0.running_mean"]))
    data = datasets.load_dataset(os.path.join(est_dir, "val"), "smpl_estimator")
    x = torch.from_numpy(data.images)
    rebuilt = factory.build_models_and_params(
        train_cli.config_mod.config_parser().parse_args(_argv(est_dir)), device="cpu",
        extras={"image_size": (32, 32)})[0]["smpl_estimator"]
    rebuilt.load_state_dict(final["smpl_estimator"])
    with torch.no_grad():
        np.testing.assert_array_equal(to_np(loaded(x)), to_np(rebuilt.eval()(x)))
    # the run resumes through --load_run, and has nothing to render
    train_cli.train(_argv(est_dir, ("--num_epochs=1", f"--load_run={run_dir}")),
                    log_dir=str(tmp_path / "resumed"), device="cpu")
    args = inference.setup_from_run_dir(run_dir)
    with pytest.raises(ValueError, match="no render pipeline"):
        inference.render_dataset(args, run_dir, data, device="cpu")


# ------------------------------------------------------- AppendVerticesNet

def test_append_vertices_net_matches_flax(rng):
    dims = dict(n_layers=3, width=32, positions_dim=12, directions_dim=6, vertices_dim=30,
                vertex_embedding_dim=8, vertices_net_depth=2, skips=(1,))
    jnet = JaxAppendVerticesNet(**dims)
    x = rng.randn(9, 12 + 30 + 6).astype(np.float32)
    variables = jax.device_get(jnet.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    variables = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + (0.05 * rng.randn(*p.shape).astype(np.float32)
                                   if p.ndim == 1 else 0.0), variables)
    net = AppendVerticesNet(**dims)
    net.load_state_dict(checkpoints.params_from_jax({"n": variables})["n"])
    assert "vertices_net.1.weight" in net.state_dict()
    with torch.no_grad():
        got = to_np(net(torch.from_numpy(x)))
    np.testing.assert_allclose(got, np.asarray(jnet.apply(variables, jnp.asarray(x))), atol=1e-5)
