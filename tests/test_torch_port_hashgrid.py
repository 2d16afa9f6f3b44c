"""The port's Instant-NGP hash-grid field (--grid_encoding 2,
models/grid_nerf.HashGridNerf) against the plain float32 reference
(hashgrid_reference_torch.py), its spans and counters, and a train_torch run
whose run directory inference_torch reloads.

Small shapes (`grid_nerf.NGP_SIZES` patched for every test, as the published
sizes are the module's constants): L = 4 levels of F = 2 features, T = 2^9
entries, N_min = 4 and N_max = 32, so that level 0 (N = 4, 125 vertices) is
dense and levels 1-3 (N = 8, 16, 32) are hashed; MLPs 16 wide; R = 32 rays of 8 coarse and 16 fine
samples, on the CPU's plain path, in float32 on both sides. The port's own
`Solver.train_step` runs three steps from the factory's seeded weights; the
reference repeats them from the same weights with a generator seeded as the
solver seeds its own, so the jitter and sigma noise are the same numbers.
Then a planted fault through the seam `grid_nerf.hash_grid_encode` must fail
the tolerances: the benchmark's own (port_bench/traffic/train_hashgrid.py:
the primes pi2 and pi3 swapped, the nearest corner in place of the trilinear
blend, the finest level's features dropped, a hashed level taken mod T/2), and
three that leave the forward as it is and alter only the gradient that reaches
the table (the finest level's dropped, every level's halved, the coarsest
level's moved one entry along).

Tolerances (relative norms): both sides compute in float32, and differ only
in the order of sums (the port sums a point's 8 corners in one reduction and
accumulates the tables' gradient with index_add_ over every level at once;
the reference adds corner by corner, level by level). The raw outputs and
the loss read ~1e-8 and ~1e-7 here (RAW_REL, LOSS_REL 1e-6); each gradient
leaf ~2e-7 (GRAD_REL 1e-5; index_add_'s order on the CPU is fixed, but a
different order of the same sums is what a card gives); the parameters'
change after three Adam steps ~2e-6 (CHANGE_REL 1e-3: Adam divides each
moment by its own root mean square, which lifts the gradients' rounding in
entries hit by few samples). Every fault reads above 1e-5 on the raw outputs
and ~1 on the gradients and the change; a backward fault reads as the sound
step on the raw outputs and 0.5-1.4 on its table's gradient.
"""
import _torch_threads  # noqa: F401

import os

import numpy as np
import pytest
import torch

import hashgrid_reference_torch as ref
from port_bench.traffic import train_hashgrid
from smpl_nerf_tpu_torch import config as port_config
from smpl_nerf_tpu_torch import tracing
from smpl_nerf_tpu_torch.cli import inference
from smpl_nerf_tpu_torch.cli import train as train_cli
from smpl_nerf_tpu_torch.data import datasets
from smpl_nerf_tpu_torch.models import grid_nerf
from smpl_nerf_tpu_torch.models.grid_nerf import GridNerf, HashGridNerf, HashGridSpec
from smpl_nerf_tpu_torch.pipelines import RenderConfig, build_pipeline
from smpl_nerf_tpu_torch.render import batched
from smpl_nerf_tpu_torch.training import factory
from smpl_nerf_tpu_torch.training.solver import Solver

R, NC, NF, WIDTH, STEPS, SEED = 32, 8, 16, 16, 3, 11
CFG = ref.Config(coarse_samples=NC, fine_samples=NF, frequencies_positional=4,
                 frequencies_pose=2, n_levels=4, features=2, log2_hashmap_size=9,
                 base_resolution=4, max_resolution=32)
RAW_REL, LOSS_REL, GRAD_REL, CHANGE_REL = 1e-6, 1e-6, 1e-5, 1e-3
FAULTS = ("primes_swapped", "nearest_corner", "finest_dropped", "table_halved")
GRAD_FAULTS = ("finest_grad_dropped", "table_grad_halved", "coarsest_grad_shifted")
GRID_FLAGS = ["--grid_encoding=2", "--grid_features=2", f"--grid_width={WIDTH}",
              "--grid_bound=1.6"]
PUBLISHED = dict(grid_nerf.NGP_SIZES)
SMALL = {"n_levels": 4, "log2_hashmap_size": 9, "base_resolution": 4, "max_resolution": 32}


@pytest.fixture(autouse=True)
def small_sizes(monkeypatch):
    monkeypatch.setattr(grid_nerf, "NGP_SIZES", SMALL)


def _argv(extra=()):
    return (["--config=", "--model_type=smpl_nerf", "--run_fine=1",
             f"--number_coarse_samples={NC}", f"--number_fine_samples={NF}",
             "--number_frequencies_postitional=4", "--number_frequencies_pose=2",
             "--human_pose_encoding=1", "--netwidth_warp=16", "--sigma_noise_std=1",
             "--use_pallas=0", "--use_fused_mlp=-1", f"--batchsize={R}", "--lrate=1e-2",
             f"--seed={SEED}"] + GRID_FLAGS + list(extra))


def _solver():
    args = port_config.config_parser().parse_args(_argv())
    models, encoders = factory.build_models_and_params(args, seed=args.seed, device="cpu")
    return Solver(build_pipeline(RenderConfig.from_args(args), models, encoders), args)


def _batches():
    g = torch.Generator().manual_seed(5)
    out = []
    for _ in range(STEPS):
        angle = 2 * np.pi * torch.rand((R,), generator=g)
        origins = torch.stack([2.4 * torch.sin(angle), 0.2 * torch.randn((R,), generator=g),
                               2.4 * torch.cos(angle)], -1)
        target = 0.3 * torch.randn((R, 3), generator=g)
        poses = torch.zeros((R, 69))
        poses[:, [38, 41]] = 0.7 * torch.rand((R, 1), generator=g)
        out.append({"ray_translation": origins, "ray_direction": target - origins,
                    "human_pose": poses, "rgb": torch.rand((R, 3), generator=g)})
    return out


def _relative(a, b):
    return float(torch.linalg.norm((a - b).float())) / max(float(torch.linalg.norm(b.float())),
                                                           1e-30)


def _port_steps():
    """The raw outputs of the fine net on seeded rows, then three solver steps:
    (start weights, raws, losses, first gradients, weights after the steps)."""
    sol = _solver()
    start = {m: {k: v.detach().clone() for k, v in mod.named_parameters()}
             for m, mod in sol.models.items()}
    g = torch.Generator().manual_seed(9)
    pos = 3.4 * torch.rand((500, 3), generator=g) - 1.7          # some outside the box
    dirs = torch.nn.functional.normalize(torch.randn((500, 3), generator=g), dim=-1)
    with torch.no_grad():
        raw = sol.models["model_fine"](torch.cat([pos, dirs], -1))
    losses, grads = [], None
    for batch in _batches():
        aux = sol.train_step(batch, sol.generator)
        losses.append(float(aux["loss"]))
        if grads is None:
            grads = {m: {k: p.grad.detach().clone() for k, p in mod.named_parameters()}
                     for m, mod in sol.models.items()}
    after = {m: {k: v.detach().clone() for k, v in mod.named_parameters()}
             for m, mod in sol.models.items()}
    return start, (pos, dirs, raw), losses, grads, after


def _gaps(start, rows, losses, grads, after):
    """{'raw', 'loss', 'grad', 'change'}: the largest relative gap of each against
    the reference from the same start."""
    pos, dirs, raw = rows
    raw_ref = ref.field(start["model_fine"], pos, dirs, CFG)
    batches = [{"origins": b["ray_translation"], "directions": b["ray_direction"],
                "poses": b["human_pose"], "rgb": b["rgb"]} for b in _batches()]
    run = ref.train_steps(CFG, start, batches, torch.Generator().manual_seed(SEED))
    return {"raw": _relative(raw, raw_ref),
            "loss": max(abs(a - b) / b for a, b in zip(losses, run["losses"])),
            "grad": max(_relative(grads[m][k], g) for m, leaves in run["grads"].items()
                        for k, g in leaves.items()),
            "change": max(_relative(after[m][k] - start[m][k], p - start[m][k])
                          for m, leaves in run["params"].items() for k, p in leaves.items())}


def test_the_spec_at_instant_ngps_published_sizes():
    assert PUBLISHED == {"n_levels": 16, "log2_hashmap_size": 19, "base_resolution": 16,
                         "max_resolution": 2048}
    spec = HashGridSpec.published(features=2, **PUBLISHED)
    assert spec.resolutions == (16, 22, 30, 42, 58, 80, 111, 153, 212, 294, 406, 561, 776,
                                1072, 1482, 2048)
    assert spec.dense == (True,) * 5 + (False,) * 11
    assert spec.sizes[:5] == (4913, 12167, 29791, 79507, 205379)
    assert spec.entries == 331757 + 11 * 2 ** 19 == 6098925
    assert spec.offsets[5] == 331757
    small = HashGridSpec.published(features=2, **SMALL)
    assert small == HashGridSpec.published(4, 2, 9, 4, 32)
    assert small.resolutions == (4, 8, 16, 32) and small.dense == (True, False, False, False)
    assert small.entries == ref.table_entries(CFG) == 125 + 3 * 512


@pytest.mark.parametrize("corner", [(3, 7, 5), (31, 2, 30), (32, 32, 32)])
def test_a_hashed_corner_takes_the_pinned_index(corner):
    """At level 3 (N = 32, hashed) a point on a vertex reads that vertex's entry
    alone: (c0 * 1 xor c1 * 2654435761 xor c2 * 805459861) in uint32, mod 2^9.
    The products pass 2^32 here (c1 * 2654435761 >= 2^32 for c1 >= 2), so the
    wrap is what uint32 arithmetic does."""
    spec = HashGridSpec.published(4, 2, 9, 4, 32)
    table = torch.arange(spec.entries * 2, dtype=torch.float32).reshape(-1, 2)
    n = spec.resolutions[3]
    x = torch.tensor([[c / n for c in corner]])
    h = (corner[0] * 1 ^ corner[1] * 2654435761 ^ corner[2] * 805459861) & 0xFFFFFFFF
    entry = spec.offsets[3] + h % 512
    got = grid_nerf.hash_grid_encode(x, table, spec)[0, 6:8]
    assert got.tolist() == [2.0 * entry, 2.0 * entry + 1]
    assert ref.hash_encode(x, table, CFG)[0, 6:8].tolist() == got.tolist()


def test_the_dense_level_maps_its_vertices_one_to_one():
    spec = HashGridSpec.published(4, 2, 9, 4, 32)
    table = torch.arange(spec.entries * 2, dtype=torch.float32).reshape(-1, 2)
    c = torch.stack(torch.meshgrid(*[torch.arange(5)] * 3, indexing="ij"), -1).reshape(-1, 3)
    got = grid_nerf.hash_grid_encode(c / 4.0, table, spec)[:, 0] / 2
    assert sorted(got.long().tolist()) == list(range(125))
    assert got.long().tolist() == (c[:, 0] + 5 * c[:, 1] + 25 * c[:, 2]).tolist()


def test_the_encoding_blends_like_the_reference_and_clamps_outside_the_box():
    spec = HashGridSpec.published(4, 2, 9, 4, 32)
    g = torch.Generator().manual_seed(3)
    table = torch.randn((spec.entries, 2), generator=g)
    x = 1.4 * torch.rand((400, 3), generator=g) - 0.2
    got = grid_nerf.hash_grid_encode(x, table, spec)
    assert _relative(got, ref.hash_encode(x, table, CFG)) < RAW_REL
    torch.testing.assert_close(got, grid_nerf.hash_grid_encode(x.clamp(0, 1), table, spec))
    sh = grid_nerf.spherical_harmonics_4(torch.nn.functional.normalize(x, dim=-1))
    torch.testing.assert_close(sh, ref.spherical_harmonics(torch.nn.functional.normalize(x,
                                                                                        dim=-1)))


def test_the_factory_builds_hash_grid_nets_and_keeps_grid_encoding_1():
    args = port_config.config_parser().parse_args(_argv())
    models, _ = factory.build_models_and_params(args, seed=1, device="cpu")
    assert type(models["model_coarse"]) is HashGridNerf is type(models["model_fine"])
    net = models["model_fine"]
    assert net.spec == HashGridSpec.published(4, 2, 9, 4, 32) and net.takes_raw
    assert net.hash_table.shape == (1661, 2) and float(net.hash_table.detach().abs().max()) <= 1e-4
    assert [k for k, _ in net.named_parameters()] == [
        "hash_table", "density_0.weight", "density_out.weight", "color_0.weight",
        "color_1.weight", "color_out.weight"]
    old = port_config.config_parser().parse_args(
        [a for a in _argv() if not a.startswith("--grid_encoding")] + ["--grid_encoding=1"])
    assert type(factory.build_models_and_params(old, seed=1, device="cpu")[0][
        "model_coarse"]) is GridNerf
    # an append family's prefix (two joints at 2 frequencies) follows the L F
    # features into the density MLP
    append = port_config.config_parser().parse_args(
        [a.replace("smpl_nerf", "append_to_nerf") for a in _argv()])
    models, encoders = factory.build_models_and_params(append, seed=1, device="cpu")
    assert models["model_fine"].density_0.weight.shape == (WIDTH, 8 + 2 * 4)
    pipe = build_pipeline(RenderConfig.from_args(append), models, encoders)
    with torch.no_grad():
        out = pipe({k: v for k, v in _batches()[0].items() if k != "rgb"})
    assert torch.isfinite(out["rgb_fine"]).all()
    assert port_config.config_parser().parse_args(["--config="]).grid_encoding == 0


def test_the_port_step_follows_the_reference():
    gaps = _gaps(*_port_steps())
    assert gaps["raw"] < RAW_REL and gaps["loss"] < LOSS_REL, gaps
    assert gaps["grad"] < GRAD_REL and gaps["change"] < CHANGE_REL, gaps


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_fails_the_tolerances(fault, monkeypatch):
    monkeypatch.setattr(grid_nerf, "hash_grid_encode",
                        train_hashgrid.planted(fault, grid_nerf.hash_grid_encode))
    gaps = _gaps(*_port_steps())
    assert gaps["raw"] > RAW_REL and gaps["grad"] > GRAD_REL, gaps


@pytest.mark.parametrize("fault", GRAD_FAULTS)
def test_a_planted_backward_fault_fails_the_gradient_tolerance(fault, monkeypatch):
    """The forward is the sound one (the raw outputs hold); only the gradient
    into the tables is wrong."""
    monkeypatch.setattr(grid_nerf, "hash_grid_encode",
                        train_hashgrid.planted(fault, grid_nerf.hash_grid_encode))
    gaps = _gaps(*_port_steps())
    assert gaps["raw"] < RAW_REL and gaps["grad"] > 0.3, gaps


def test_the_encoding_span_and_counters():
    sol = _solver()
    calls, lookups = grid_nerf.encode_calls, grid_nerf.lookups
    tracing.enable(1000)
    try:
        sol.train_step(_batches()[0], sol.generator)
    finally:
        tracing.disable()
    assert grid_nerf.encode_calls - calls == 2
    assert grid_nerf.lookups - lookups == R * (NC + NC + NF) * 4 * 8
    snap = tracing.snapshot()
    names = [s.name for s in snap.spans]
    encodes = [s for s in snap.spans if s.name == "pass.encode"]
    assert len(encodes) == 2 and all(names[s.parent] == "pass.net" for s in encodes)
    assert [names[snap.spans[s.parent].parent] for s in encodes] == ["pass.coarse",
                                                                       "pass.fine"]


def test_train_torch_saves_a_run_that_inference_torch_reloads(tmp_path, monkeypatch):
    from smpl_nerf_tpu_torch.cli import render_path

    monkeypatch.setattr(train_cli, "summary_writer", lambda log_dir: None)
    cams = render_path.camera_path_data("circle", 3, 2.4, -90, 90, 32, [41, 38], 0.0)
    poses = np.zeros((3, 69), np.float32)
    poses[:, [38, 41]] = np.deg2rad([[0.0], [20.0], [40.0]])
    images = np.random.RandomState(0).uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    data_dir = tmp_path / "data"
    for split, sl in (("train", slice(0, 2)), ("val", slice(2, 3))):
        datasets.write_dataset(str(data_dir / split), images[sl], cams.camera_transforms[sl],
                               np.pi / 3, poses[sl])
    run_dir = str(tmp_path / "run")
    sol = train_cli.train(_argv([f"--dataset_dir={data_dir}", "--num_epochs=1",
                                 "--steps_per_epoch=2", "--batchsize_val=256", "--render_gif=0",
                                 "--number_validation_images=0"]), log_dir=run_dir,
                          device="cpu")
    assert len(sol.history["step_loss"]) == 2 and np.isfinite(sol.history["step_loss"]).all()
    saved = torch.load(os.path.join(run_dir, "model_fine.pt"))
    assert saved["hash_table"].shape == (1661, 2)
    assert torch.equal(saved["hash_table"], sol.models["model_fine"].hash_table.detach())
    args = inference.setup_from_run_dir(run_dir)
    assert args.grid_encoding == 2
    val = datasets.load_dataset(str(data_dir / "val"), "smpl_nerf", args, device="cpu")
    reloaded = inference.render_dataset(args, run_dir, val, device="cpu")
    with torch.no_grad():
        trained = batched.render_rays_batched(sol.pipeline, val, 256, torch.device("cpu"))
    np.testing.assert_array_equal(reloaded.reshape(-1, 3),
                                  np.asarray(trained).reshape(-1, 3))
    scores = inference.inference([f"--inf_run_dir={run_dir}",
                                  f"--inf_ground_truth_dir={data_dir / 'val'}",
                                  f"--inf_save_dir={tmp_path / 'inf'}", "--inf_batchsize=256",
                                  "--device=cpu"])
    assert np.isfinite(scores["psnr"])
