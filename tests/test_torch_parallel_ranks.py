"""The port's parallel layer across gloo ranks against its world-1 runs and the
JAX package's mesh runs.

Two launches of `python -m smpl_nerf_tpu_torch.parallel.dryrun` (a world of 2,
then one of 4; a file:// rendezvous under tmp_path, so that no two test
workers race for a port; OMP_NUM_THREADS=1) run in a thread while this
process computes the references: the port's world-1 runs (no process group)
and JAX's runs on meshes of its 8 virtual CPU devices. Each rank writes one
.npz per case, and each check below is a case of its own:

  (a) mesh '2', data parallelism: a 2-step coarse+fine nerf (netdepth 3,
      width 16, --use_pallas=1: kernel A's plain version on every rank); its
      loss histories and final weights equal the port's world-1 run and
      JAX's run on a '2' mesh from the same initial weights, with no jitter
      or noise (JAX's rng split patched to None, the port's generator None).
      Through the CLI with --multihost=1, jitter and sigma noise on, it
      equals the port's world-1 run (the draws cover the global batch).
  (b) mesh '2,2', --tensor_parallel=1: equals the replicated '2,2' run, the
      world-1 run and JAX's '2,2' TP run; the trunk weights are shards
      (local out = W/2); save_run writes whole reference-layout weights.
  (c) mesh '1,2', --tensor_parallel=1 --use_fused_mlp=2 (bf16): the gather
      path through kernels B's and C's plain versions equals the world-1
      mode-2 run.
  (d) a resume where only rank 0's run dir holds train_state.pt restores on
      both ranks (rank 0's bytes); with no file anywhere both return False.
  (e) mesh '1,2': sample_parallel_raw2outputs and expert_parallel_apply
      (outputs, overflow, gradients) against JAX's, pipeline_trunk at 2
      stages (n_micro 1 and 4) against trunk_dense with its gradients, and
      the shape guards (and a mesh smaller than the world).

Tolerances: float32 rtol 1e-5 (the collectives sum in another order: atol
1e-6 where values cross 0); training runs rtol 1e-4 (tests/test_parallel.py);
bf16 runs 2e-3.
"""
import _torch_threads  # noqa: F401

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smpl_nerf_tpu import config as jax_config
from smpl_nerf_tpu import pipelines as jax_pipelines
from smpl_nerf_tpu.data import datasets as jax_datasets
from smpl_nerf_tpu.models.render_ray_net import RenderRayNet as JaxRenderRayNet
from smpl_nerf_tpu.parallel import ep as jax_ep
from smpl_nerf_tpu.parallel import mesh as jax_mesh
from smpl_nerf_tpu.parallel import sample_axis as jax_sa
from smpl_nerf_tpu.models.render_ray_net import import_torch_state_dict
from smpl_nerf_tpu.training import checkpoints as jax_checkpoints
from smpl_nerf_tpu.training import factory as jax_factory
from smpl_nerf_tpu.training.solver import Solver as JaxSolver
from smpl_nerf_tpu_torch import config as port_config
from smpl_nerf_tpu_torch.data import datasets
from smpl_nerf_tpu_torch.models import RenderRayNet
from smpl_nerf_tpu_torch.parallel import dryrun, pp
from smpl_nerf_tpu_torch.training import checkpoints
from smpl_nerf_tpu_torch.training import factory as port_factory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHES = {2: ("dp", "cli", "resume", "tp_fused", "axes"), 4: ("tp", "repl")}
E, R, S = 8, 8, 16      # experts; rays and samples of the sample-axis case


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """data/ (2 views of 8x8 per split), init/ (the port's seed-0 weights as
    .pt; JAX reads them with its import_torch_run), inputs.npz (the sample
    axis, the pipeline net and the experts). Made by the port and numpy
    alone, so that the launches start at once."""
    root = str(tmp_path_factory.mktemp("parallel_ranks"))
    rng = np.random.RandomState(0)
    cams = np.stack([np.eye(4, dtype=np.float32)] * 2)
    cams[:, 2, 3] = [3.0, 3.2]
    for split in ("train", "val"):
        datasets.write_dataset(os.path.join(root, "data", split),
                               rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32), cams,
                               np.pi / 3)
    args = port_config.config_parser().parse_args(dryrun.case_argv([], "unused"))
    models, _ = port_factory.build_models_and_params(args, seed=0, device="cpu")
    checkpoints.save_run(os.path.join(root, "init"),
                         {name: m.state_dict() for name, m in models.items()})
    net = RenderRayNet(8, 16, 6, 4, skips=(4,), generator=torch.Generator().manual_seed(1))
    arrays = {
        "sa_raw": rng.randn(R, S, 4).astype(np.float32),
        "sa_z": np.sort(rng.uniform(1, 4, (R, S)).astype(np.float32), -1),
        "sa_dirs": rng.randn(R, 3).astype(np.float32),
        "pp_x": rng.randn(16, 10).astype(np.float32), "pp_tgt": rng.rand(16, 4).astype(np.float32),
        "ep_x": rng.randn(32, 6).astype(np.float32),
        "ep_ids": rng.randint(0, E, 32).astype(np.int64),
        "ep_tgt": rng.rand(32, 4).astype(np.float32),
        "ep_w0": (rng.randn(E, 6, 8) * 0.5).astype(np.float32),
        "ep_b0": (rng.randn(E, 8) * 0.1).astype(np.float32),
        "ep_w1": (rng.randn(E, 8, 4) * 0.5).astype(np.float32),
        "ep_b1": (rng.randn(E, 4) * 0.1).astype(np.float32),
        **{f"pp/{k}": v.detach().numpy() for k, v in net.state_dict().items()},
    }
    np.savez(os.path.join(root, "inputs.npz"), **arrays)
    return root, arrays


@pytest.fixture(scope="module", autouse=True)
def launches(inputs):
    """Start the world-2 then the world-4 launch in a thread (first, so that
    the references are computed meanwhile); yields a join."""
    root = inputs[0]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    logs = {}

    def run():
        for world, cases in LAUNCHES.items():
            out = os.path.join(root, f"world{world}")
            cmd = [sys.executable, "-m", "smpl_nerf_tpu_torch.parallel.dryrun",
                   "--world", str(world), "--init_method",
                   f"file://{os.path.join(root, f'rendezvous{world}')}", "--out", out,
                   "--inputs", root, "--cases", ",".join(cases), "--device", "cpu"]
            procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
                     for r in range(world)]
            logs[world] = [(p.communicate(timeout=300)[0], p.returncode) for p in procs]

    thread = threading.Thread(target=run)
    thread.start()

    def result(world, case):
        thread.join()
        for rank, (log, rc) in enumerate(logs[world]):
            assert rc == 0, f"world {world} rank {rank} failed:\n{log[-4000:]}"
        return [dict(np.load(os.path.join(root, f"world{world}", f"{case}_rank{r}.npz")))
                for r in range(world)]

    yield result
    thread.join()


def _port_world1(root, flags, deterministic):
    solver = dryrun.train_case(dryrun.case_argv(flags, os.path.join(root, "data"),
                                                os.path.join(root, "init")),
                               deterministic=deterministic)
    return dryrun.solver_result(solver)


@pytest.fixture(scope="module")
def references(inputs):
    """The port's world-1 runs, and JAX's '2' and '2,2' TP runs without jitter or noise."""
    root = inputs[0]
    refs = {"world1": _port_world1(root, [], True),
            "world1_noise": _port_world1(root, ["--sigma_noise_std=1"], False),
            "world1_fused": _port_world1(root, ["--use_fused_mlp=2", "--compute_dtype=bfloat16"],
                                         False)}
    parser = jax_config.config_parser()
    data_dir = os.path.join(root, "data")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pipelines, "_split_rng", lambda rng, n: (None,) * n)
        for name, flags in (("jax_dp", ["--mesh_shape=2"]),
                            ("jax_tp", ["--mesh_shape=2,2", "--tensor_parallel=1"])):
            args = parser.parse_args(dryrun.case_argv(flags, data_dir))
            splits = [jax_datasets.load_dataset(os.path.join(data_dir, s), "nerf", args)
                      for s in ("train", "val")]
            models, _, encoders = jax_factory.build_models_and_params(
                args, jax.random.PRNGKey(0), {})
            params = jax_checkpoints.import_torch_run(os.path.join(root, "init"), 3, 3)
            pipeline = jax_pipelines.build_pipeline(
                jax_pipelines.RenderConfig.from_args(args), models, encoders, {})
            solver = JaxSolver(pipeline, params, args)
            solver.train(*splits)
            res = {k: np.asarray(v, np.float64) for k, v in solver.history.items()}
            for model, sd in checkpoints.params_from_jax(jax.device_get(solver.params)).items():
                for key, value in sd.items():
                    res[f"w/{model}/{key}"] = value.numpy()
            refs[name] = res
    return refs


def _same_run(got, want, rtol=1e-4, atol=1e-6):
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    keys = [k for k in want if k.startswith("w/")]
    assert keys and set(keys) == {k for k in got if k.startswith("w/")}
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _ranks_agree(results):
    for r in results[1:]:
        for k in ("train_loss", "val_loss", "step_loss"):
            np.testing.assert_array_equal(r[k], results[0][k], err_msg=k)


@pytest.mark.parametrize("against", ["world1", "jax_dp"])
def test_a_data_parallel_mesh_2_equals_world1_and_jax(references, launches, against):
    got = launches(2, "dp")
    _ranks_agree(got)
    _same_run(got[0], references[against])


def test_a_cli_multihost_draws_jitter_and_noise_for_the_global_batch(references, launches):
    got = launches(2, "cli")
    _ranks_agree(got)
    _same_run(got[0], references["world1_noise"])


@pytest.mark.parametrize("against", ["repl", "world1", "jax_tp"])
def test_b_tensor_parallel_2x2_equals_replicated_world1_and_jax(references, launches,
                                                                 against):
    got = launches(4, "tp")
    _ranks_agree(got)
    want = launches(4, "repl")[0] if against == "repl" else references[against]
    _same_run(got[0], want)


def test_b_tensor_parallel_weights_are_shards_and_the_run_dir_is_whole(references, inputs,
                                                                        launches):
    got = launches(4, "tp")
    for r in got:
        assert tuple(r["local_first_shape"]) == (8, 12)      # W/2 rows of W=16
    assert tuple(launches(4, "repl")[0]["local_first_shape"]) == (16, 12)
    saved = checkpoints.load_run(os.path.join(inputs[0], "world4", "tp_run"))
    want = references["world1"]
    for model, sd in saved.items():
        for key, value in sd.items():
            np.testing.assert_allclose(value.numpy(), want[f"w/{model}/{key}"], rtol=1e-4,
                                       atol=1e-6, err_msg=f"{model}.{key}")
    assert tuple(saved["model_coarse"]["positions_pose_input.weight"].shape) == (16, 12)


def test_c_tensor_parallel_fused_mode2_gathers_whole_nets(references, launches):
    got = launches(2, "tp_fused")
    _ranks_agree(got)
    assert tuple(got[0]["local_first_shape"])[0] == 8
    _same_run(got[0], references["world1_fused"], rtol=1e-6, atol=0)


def test_d_resume_learns_the_state_from_rank0(launches):
    got = launches(2, "resume")
    for r in got:
        assert bool(r["restored"]) and int(r["epoch_offset"]) == 2
        assert not bool(r["restored_none"])
    assert float(got[0]["moments"]) > 0
    assert float(got[1]["moments"]) == float(got[0]["moments"])
    assert float(got[1]["best_val"]) == float(got[0]["best_val"])


def _segments(x, j, n=2):
    return x[:, j * (x.shape[1] // n):(j + 1) * (x.shape[1] // n)]


def test_e_sample_parallel_raw2outputs_equals_jax(inputs, launches):
    _, a = inputs
    mesh = jax_mesh.make_mesh("1,2")
    dists = jax_sa.global_dists(jnp.asarray(a["sa_z"]), jnp.asarray(a["sa_dirs"]))
    want = jax.jit(lambda *t: jax_sa.sample_parallel_raw2outputs(mesh, *t))(
        jnp.asarray(a["sa_raw"]), jnp.asarray(a["sa_z"]), dists)
    for j, r in enumerate(launches(2, "axes")):
        for k in ("rgb", "depth", "acc"):
            np.testing.assert_allclose(r[f"sa_{k}"], np.asarray(getattr(want, k)), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        for k in ("weights", "density"):
            np.testing.assert_allclose(r[f"sa_{k}"], _segments(np.asarray(getattr(want, k)), j),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        # the group form of raw2outputs_segmented (2 local segments a rank)
        np.testing.assert_allclose(r["seg_rgb"], np.asarray(want.rgb) + 1.0 - np.asarray(
            want.acc)[:, None], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["seg_weights"], r["sa_weights"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_micro", [1, 4])
def test_e_pipeline_trunk_two_stages_equals_dense_with_gradients(inputs, launches, n_micro):
    _, a = inputs
    net = RenderRayNet(8, 16, 6, 4, skips=(4,))
    net.load_state_dict({k[3:]: torch.as_tensor(a[k]) for k in a if k.startswith("pp/")})
    x, tgt = torch.as_tensor(a["pp_x"]), torch.as_tensor(a["pp_tgt"])
    k, b, u = pp.stack_trunk(net, 8, (4,), 6, 16, n_stages=2)
    k.retain_grad()
    y = pp.trunk_dense(k, b, u, x[:, :6])
    (y ** 2).mean().backward()
    out = net(x)
    net.zero_grad()
    ((out - tgt) ** 2).mean().backward()
    pp_params = import_torch_state_dict({k[3:]: a[k] for k in a if k.startswith("pp/")}, 8)
    want_flax = np.asarray(JaxRenderRayNet(n_layers=8, width=16, positions_dim=6,
                                           directions_dim=4, skips=(4,)).apply(
        pp_params, jnp.asarray(a["pp_x"])))
    for r in launches(2, "axes"):
        np.testing.assert_allclose(r[f"trunk_out_{n_micro}"], y.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r[f"trunk_dk_{n_micro}"], k.grad.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r[f"pp_out_{n_micro}"], want_flax, rtol=1e-5, atol=1e-6)
        for key, p in net.named_parameters():
            np.testing.assert_allclose(r[f"pp_grad_{n_micro}/{key}"], p.grad.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=key)


def test_e_expert_parallel_apply_equals_jax_with_overflow_and_gradients(inputs, launches):
    _, a = inputs
    mesh = jax_mesh.make_mesh("1,2")
    experts = jax_ep.ExpertMLP(*(jnp.asarray(a[f"ep_{w}"]) for w in ("w0", "b0", "w1", "b1")))
    x, ids, tgt = jnp.asarray(a["ep_x"]), jnp.asarray(a["ep_ids"], jnp.int32), a["ep_tgt"]
    # jitted: shard_map outside jit runs op by op, ~20x slower on the CPU
    apply = jax.jit(lambda ex, i, c: jax_ep.expert_parallel_apply(mesh, ex, x, i, c),
                    static_argnums=2)
    want, want0 = apply(experts, ids, 16), apply(experts, jnp.zeros_like(ids), 2)
    grads = jax.jit(jax.grad(lambda ex: jnp.mean((apply(ex, ids, 16).out - tgt) ** 2)))(experts)
    got = launches(2, "axes")
    np.testing.assert_allclose(np.concatenate([r["ep_out"] for r in got]), np.asarray(want.out),
                               rtol=1e-5, atol=1e-6)
    assert not np.concatenate([r["ep_overflow"] for r in got]).any()
    np.testing.assert_array_equal(np.concatenate([r["ep0_overflow"] for r in got]),
                                  np.asarray(want0.overflow))
    assert np.concatenate([r["ep0_overflow"] for r in got]).sum() == 32 - 2 * 2
    np.testing.assert_allclose(np.concatenate([r["ep0_out"] for r in got]),
                               np.asarray(want0.out), rtol=1e-5, atol=1e-6)
    for r in got:
        for w, g in zip(("w0", "b0", "w1", "b1"), grads):
            np.testing.assert_allclose(r[f"ep_grad_{w}"], np.asarray(g), rtol=1e-5, atol=1e-6,
                                       err_msg=w)


@pytest.mark.parametrize("guard", ["guard_micro", "guard_layers", "guard_dims", "guard_experts",
                                   "guard_mesh"])
def test_e_shape_guards_raise(launches, guard):
    for r in launches(2, "axes"):
        assert bool(r[guard]), guard
