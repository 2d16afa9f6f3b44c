"""The port's last four tools and its image-wise chain against the JAX package.

`cli/measure_render.py` against scripts/measure_render_256.py,
`cli/pose_landscape.py` against tools/pose_landscape.py,
`cli/rescore_renders.py` against tools/rescore_renders.py (and the three
cases of tests/test_rescore_renders.py on the port's tool),
`cli/aliasing_floor.py` against tools/aliasing_floor.py, each on the same run
directory (JAX `save_run` + `export_torch_run`, the small nets of
tests/test_torch_port_slice.py) or the same files; then a toy run of
image_wise_chain_torch.py on the CPU, every entry point's refusal to run
without CUDA unless asked for the CPU, and their imports.

The JAX tools run in this process as their own `main` reads sys.argv; the
measure tool's renders are taken from its jitted candidates (a recording
`jax.jit`: each candidate is called once to warm up and five times timed).

Tolerances: renders 2e-3 per pixel (the slice's rgb_fine bound: a fine sample
can flip an inverse-CDF bin); a culled candidate ray by ray: a ray whose two
renders differ by more than that must be one the two packages sent to
different passes, at the budget's edge (its coarse opacity within
EDGE_ACC of the K-th), each render being one of that ray's two colours;
landscape losses 1e-5 relative (the same bf16 roundings as flax's Dense;
float32 sums in another order),
with the same argmin; fresh scores 1e-4 relative; aliasing floors
FLOOR_DB, which covers the JAX tool's two printed decimals and a few
silhouette rays that hit a neighbouring face in the other package.
"""
import _torch_threads  # noqa: F401

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from smpl_nerf_tpu import config as jax_config
from smpl_nerf_tpu.training import checkpoints as jax_checkpoints
from smpl_nerf_tpu.training import factory as jax_factory
from smpl_nerf_tpu_torch.cli import aliasing_floor, inference, measure_render
from smpl_nerf_tpu_torch.cli import pose_landscape
from smpl_nerf_tpu_torch.cli import rescore_renders as rr
from smpl_nerf_tpu_torch.cli import dataset as dataset_cli
from smpl_nerf_tpu_torch.core import cameras
from smpl_nerf_tpu_torch.data import datasets, png
from smpl_nerf_tpu_torch.render import batched
from smpl_nerf_tpu_torch.training.factory import dataset_extras
from tests.test_rescore_renders import _write_renders
from tests.test_torch_port_slice import _argv, _jax_params
from tools import rescore_renders as jax_rr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 16
RGB_ATOL = 2e-3
EDGE_ACC = 1e-4
LOSS_REL = 1e-5
SCORE_REL = 1e-4
FLOOR_DB = 0.25
LINE = re.compile(r"^(\d+)x\1 (\w+) render \[(\w+)\]: \d+\.\d ms \(best of 5\)$")


def _load_script(relpath, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_run(root, model_type, extras=None, extra=(), coarse_sigma_bias=0.0):
    parser = jax_config.config_parser()
    args = parser.parse_args(_argv(model_type, white_background=1, extra=extra))
    if extras is None:
        _, params, _ = _jax_params(args, seed=21)
    else:
        _, params, _ = jax_factory.build_models_and_params(args, jax.random.PRNGKey(21), extras)
        params = jax.device_get(params)
    sigma = params["model_coarse"]["params"]["sigma_out_layer"]
    sigma["bias"] = sigma["bias"] + coarse_sigma_bias
    run_dir = os.path.join(root, f"run_{model_type}")
    jax_checkpoints.save_run(run_dir, params, args, parser)
    jax_checkpoints.export_torch_run(run_dir, run_dir)
    return run_dir


@pytest.fixture(scope="module")
def arm_set(tmp_path_factory):
    """A smpl_nerf set the port generates on the CPU: 4 circle views of 32x32
    at arm 25 deg, 2 train and 2 val."""
    root = str(tmp_path_factory.mktemp("arm_set") / "arm25")
    dataset_cli.main([f"--save_dir={root}", "--dataset_type=smpl_nerf", "--resolution=32",
                      "--camera_path=circle", "--number_steps=4", "--train_val_ratio=0.5",
                      "--multi_human_pose=1", "--human_number_steps=1",
                      "--human_start_angle=25", "--human_end_angle=25", "--device=cpu"])
    return root


# ------------------------------------------------------------ measure_render

def _jax_measure(monkeypatch, run_dir):
    """The JAX tool's four candidates' renders, in its order, and its lines."""
    tool = _load_script("scripts/measure_render_256.py", "measure_render_256")
    real_jit, made, calls = jax.jit, [], {}

    def recording_jit(fn, *a, **kw):
        jitted = real_jit(fn, *a, **kw)

        def call(*args, **kwargs):
            out = jitted(*args, **kwargs)
            calls.setdefault(id(call), []).append(np.asarray(out))
            return out
        made.append(call)
        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    monkeypatch.setattr(sys, "argv", ["measure_render_256.py", run_dir, str(RES)])
    tool.main()
    monkeypatch.setattr(jax, "jit", real_jit)
    # the grid bake is called once; each candidate once warm and five times timed
    timed = [calls[id(c)] for c in made if len(calls.get(id(c), [])) == 6]
    assert len(timed) == 4
    return [outs[-1] for outs in timed]


def test_measure_render_matches_the_jax_tool(monkeypatch, capsys, tmp_path):
    run_dir = _jax_run(str(tmp_path), "smpl_nerf")
    want = _jax_measure(monkeypatch, run_dir)
    jax_lines = [line for line in capsys.readouterr().out.splitlines() if LINE.match(line)]
    got = measure_render.main([run_dir, str(RES), "--device=cpu"])
    port_lines = [line for line in capsys.readouterr().out.splitlines() if LINE.match(line)]
    names = list(got["rgb"])
    assert names == ["naive_all_rays", "fg_culled", "occupancy", "occupancy_prebaked"]
    assert [LINE.match(x).group(3) for x in port_lines] == names
    assert [LINE.match(x).groups() for x in port_lines] == [LINE.match(x).groups()
                                                            for x in jax_lines]
    assert set(got["ms"]) == set(names) and all(v > 0 for v in got["ms"].values())
    rgb = {name: got["rgb"][name].reshape(-1, 3) for name in names}
    for name, jax_rgb in zip(names, want):
        assert rgb[name].shape == jax_rgb.shape == (RES * RES, 3)
    # the full render and the prebaked grid's render: pixel by pixel
    np.testing.assert_allclose(rgb["naive_all_rays"], want[0], atol=RGB_ATOL)
    np.testing.assert_allclose(rgb["occupancy_prebaked"], want[3], atol=RGB_ATOL)

    # the culled candidates ray by ray: the port's own coarse colours and opacities
    args = inference.setup_from_run_dir(run_dir)
    data = measure_render.view_data(args.model_type, RES)
    pipe = batched.build_from_run(run_dir, args, torch.device("cpu"),
                                  dataset_extras(args, data))
    batch = measure_render.whole_image_batch(data, args.model_type, "cpu")
    with torch.no_grad():
        coarse = pipe.passes.coarse(batch["ray_translation"], batch["ray_direction"],
                                    pipe.passes.pose(batch))[0]
    acc, coarse_rgb = coarse.acc.numpy(), coarse.rgb.numpy()
    k = int(RES * RES * measure_render.CAP_FRACTION)
    kth = np.sort(acc)[::-1][k - 1]
    fine = rgb["naive_all_rays"]
    for name, jax_rgb in (("fg_culled", want[1]), ("occupancy", want[2])):
        off = np.flatnonzero(np.abs(rgb[name] - jax_rgb).max(-1) > RGB_ATOL)
        assert len(off) <= RES, (name, len(off))
        if name == "occupancy":
            assert len(off) == 0            # the same grid scores: the same rays
            continue
        near = lambda x, y: np.abs(x - y).max(-1) <= RGB_ATOL      # noqa: E731
        port_fine = near(rgb[name][off], fine[off])
        jax_fine = near(jax_rgb[off], fine[off])
        assert np.all(port_fine != jax_fine), name           # one package refined it
        assert np.all(near(rgb[name][off][~port_fine], coarse_rgb[off][~port_fine]))
        assert np.all(near(jax_rgb[off][~jax_fine], coarse_rgb[off][~jax_fine]))
        assert port_fine.sum() == jax_fine.sum()              # the same budget K
        assert np.all(np.abs(acc[off] - kth) <= EDGE_ACC), name


# ------------------------------------------------------------ pose_landscape

def test_pose_landscape_matches_the_jax_tool(monkeypatch, tmp_path, arm_set):
    # a random net's landscape is nearly flat: a denser coarse net and a wider
    # attention radius make its angles tell apart
    run_dir = _jax_run(str(tmp_path), "image_wise_dynamic",
                       extras={"canonical_pose": np.zeros(69, np.float32)},
                       extra=("--warp_radius=0.3",), coarse_sigma_bias=3.0)
    split = os.path.join(arm_set, "train")
    argv = ["--run_dir", run_dir, "--dataset_dir", split, "--angles", "-20", "60", "5",
            "--rays", "512"]
    cache_dir = jax.config.jax_compilation_cache_dir
    tool = _load_script("tools/pose_landscape.py", "pose_landscape")
    jax.config.update("jax_compilation_cache_dir", cache_dir)     # the tool sets its own
    jax_out = str(tmp_path / "jax.json")
    monkeypatch.setattr(sys, "argv", ["pose_landscape.py", *argv, "--out", jax_out])
    tool.main()
    with open(jax_out) as fh:
        want = json.load(fh)
    port_out = str(tmp_path / "port.json")
    got = pose_landscape.main(argv + ["--out", port_out, "--device=cpu"])
    with open(port_out) as fh:
        assert json.load(fh) == got
    assert list(got) == list(want) == ["gt_deg", "landscape"]
    np.testing.assert_allclose(got["gt_deg"], want["gt_deg"], atol=1e-4)
    assert got["gt_deg"] == pytest.approx([25.0, 25.0], abs=1e-4)
    assert [r["angle_deg"] for r in got["landscape"]] == [r["angle_deg"]
                                                         for r in want["landscape"]]
    losses = np.array([r["loss"] for r in got["landscape"]])
    jax_losses = np.array([r["loss"] for r in want["landscape"]])
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_REL)
    second, first = np.sort(jax_losses)[1], np.min(jax_losses)
    assert second - first > 2 * LOSS_REL * first          # an argmin that can be compared
    assert np.argmin(losses) == np.argmin(jax_losses)


def test_mid_bin_z_is_the_jax_tools(rng):
    from smpl_nerf_tpu.core.sampling import coarse_bins
    base = np.asarray(coarse_bins(1.0, 4.0, 64))
    want = np.concatenate([0.5 * (base[1:] + base[:-1]), base[-1:]]).astype(np.float32)
    np.testing.assert_allclose(pose_landscape.mid_bin_z(1.0, 4.0, 64), want, rtol=1e-6)


# ------------------------------------------------------------ rescore_renders

def test_rescore_merges_new_metrics_and_keeps_old(tmp_path, rng, monkeypatch):
    truths = rng.rand(2, 32, 32, 3).astype(np.float32)
    renders_dir = str(tmp_path / "renders")
    _write_renders(renders_dir, np.clip(truths + 0.02, 0, 1))
    stored = {"psnr": 12.345, "ssim": 0.5, "note": "original"}
    with open(os.path.join(renders_dir, "scores.json"), "w") as fh:
        json.dump(stored, fh)
    monkeypatch.setattr(rr, "load_truths", lambda d, m="smpl_nerf", device=None: truths)
    merged = rr.rescore(renders_dir, "unused_gt", "smpl_nerf", device="cpu")
    assert merged["psnr"] == 12.345 and merged["note"] == "original"
    assert "rlpips" in merged and merged["rlpips"] >= 0
    assert merged["ground_truth_dir"] == "unused_gt"
    with open(os.path.join(renders_dir, "scores.json")) as fh:
        assert json.load(fh) == merged
    forced = rr.rescore(renders_dir, "unused_gt", "smpl_nerf", force=True, update=False,
                        device="cpu")
    assert forced["psnr"] != 12.345 and forced["note"] == "original"
    with open(os.path.join(renders_dir, "scores.json")) as fh:
        assert json.load(fh) == merged                  # --dry_run writes nothing


def test_rescore_roundtrip_psnr_accurate(tmp_path, rng, monkeypatch):
    from smpl_nerf_tpu.evaluation import scores as jax_scores
    truths = rng.rand(2, 32, 32, 3).astype(np.float32)
    noisy = np.clip(truths + rng.randn(*truths.shape).astype(np.float32) * 0.05, 0, 1)
    renders_dir = str(tmp_path / "renders")
    _write_renders(renders_dir, noisy)
    monkeypatch.setattr(rr, "load_truths", lambda d, m="smpl_nerf", device=None: truths)
    merged = rr.rescore(renders_dir, "unused", "smpl_nerf", device="cpu")
    assert merged["psnr"] == pytest.approx(float(jax_scores.img2psnr(noisy, truths)), abs=0.1)


def test_rescore_rejects_count_mismatch(tmp_path, rng, monkeypatch):
    truths = rng.rand(3, 32, 32, 3).astype(np.float32)
    renders_dir = str(tmp_path / "renders")
    _write_renders(renders_dir, truths[:2])
    monkeypatch.setattr(rr, "load_truths", lambda d, m="smpl_nerf", device=None: truths)
    with pytest.raises(ValueError, match="renders vs"):
        rr.rescore(renders_dir, "unused", "smpl_nerf", device="cpu")


def _write_pix2pix_split(rng, directory, n, res=32):
    os.makedirs(directory, exist_ok=True)
    for i in range(n):
        pair = rng.randint(0, 256, (res, 2 * res, 3)).astype(np.uint8)
        png.write_png(os.path.join(directory, f"img_{i:03d}.png"), pair)


@pytest.mark.parametrize("model_type", ["smpl_nerf", "pix2pix"])
def test_fresh_scores_and_truths_equal_the_jax_tools(tmp_path, rng, model_type):
    gt_dir = str(tmp_path / "gt")
    if model_type == "pix2pix":
        _write_pix2pix_split(rng, gt_dir, 2)
    else:
        cams, _ = cameras.get_circle_poses(-90, 90, 2, 2.4)
        datasets.write_dataset(gt_dir, rng.rand(2, 32, 32, 3).astype(np.float32), cams,
                               np.pi / 3)
    truths = rr.load_truths(gt_dir, model_type, "cpu")
    np.testing.assert_array_equal(truths, jax_rr.load_truths(gt_dir, model_type))
    renders_dir = str(tmp_path / "renders")
    _write_renders(renders_dir, np.clip(truths + 0.05 * rng.randn(*truths.shape), 0, 1))
    np.testing.assert_array_equal(rr.load_renders(renders_dir),
                                  jax_rr.load_renders(renders_dir))
    want = jax_rr.rescore(renders_dir, gt_dir, model_type, force=True, update=False)
    got = rr.main([f"--renders_dir={renders_dir}", f"--ground_truth_dir={gt_dir}",
                   f"--model_type={model_type}", "--force", "--dry_run", "--device=cpu"])[0]
    assert list(got) == list(want) and "rlpips" in got
    for key, value in want.items():
        assert got[key] == (pytest.approx(value, rel=SCORE_REL) if key != "ground_truth_dir"
                            else value), key


def test_scores_take_a_channel_flipped_view_as_jax_does(rng):
    """print_scores of `x[..., ::-1]` views (what load_truths returns for a
    pix2pix split): JAX's scores; the port's raised on the negative stride."""
    from smpl_nerf_tpu.evaluation import scores as jax_scores
    from smpl_nerf_tpu_torch.evaluation import scores
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    y = np.clip(x + 0.05 * rng.randn(*x.shape), 0, 1).astype(np.float32)
    got = scores.print_scores(x[..., ::-1], y[..., ::-1], device="cpu")
    want = jax_scores.print_scores(x[..., ::-1], y[..., ::-1])
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=SCORE_REL), key


def test_scan_rescores_what_lacks_rlpips_and_skips_the_rest(tmp_path, rng):
    runs = tmp_path / "runs"
    truths = rng.rand(2, 32, 32, 3).astype(np.float32)
    cams, _ = cameras.get_circle_poses(-90, 90, 2, 2.4)
    gt_dir = str(tmp_path / "gt")
    datasets.write_dataset(gt_dir, truths, cams, np.pi / 3)
    for run, stored in (("a", {"psnr": 1.0, "ground_truth_dir": gt_dir}),
                        ("b", {"psnr": 2.0, "rlpips": 0.5, "ground_truth_dir": gt_dir}),
                        ("c", {"psnr": 3.0})):
        renders_dir = str(runs / run / "renders_val")
        _write_renders(renders_dir, truths)
        with open(os.path.join(renders_dir, "scores.json"), "w") as fh:
            json.dump(stored, fh)
    done = rr.main([f"--scan={runs}", "--device=cpu"])
    assert len(done) == 1 and done[0]["psnr"] == 1.0 and "rlpips" in done[0]
    with open(runs / "a" / "renders_val" / "scores.json") as fh:
        assert json.load(fh) == done[0]
    with open(runs / "b" / "renders_val" / "scores.json") as fh:
        assert "ssim" not in json.load(fh)
    assert rr.main([f"--scan={runs}", "--match=c", "--device=cpu"]) == []


# ------------------------------------------------------------ aliasing_floor

def test_aliasing_floor_matches_the_jax_tool(monkeypatch, capsys, arm_set):
    split = os.path.join(arm_set, "val")
    got = aliasing_floor.main([f"--dataset_dir={split}", "--frames=2", "--device=cpu"])
    capsys.readouterr()
    tool = _load_script("tools/aliasing_floor.py", "aliasing_floor")
    monkeypatch.setattr(sys, "argv", ["aliasing_floor.py", f"--dataset_dir={split}",
                                      "--frames=2"])
    tool.main()
    lines = capsys.readouterr().out.splitlines()
    want = [float(m.group(2)) for m in (re.match(r"^(img_\d+\.png): aliasing-floor PSNR "
                                                 r"(-?[\d.]+)$", x) for x in lines) if m]
    names = [m.group(1) for m in (re.match(r"^(img_\d+\.png): ", x) for x in lines) if m]
    assert got["views"] == names and len(names) == 2 and names[0] != names[1]
    np.testing.assert_allclose(got["psnr"], want, atol=FLOOR_DB)
    assert got["mean"] == pytest.approx(np.mean(got["psnr"]))
    assert all(15.0 < v < 60.0 for v in got["psnr"])          # a real floor, not a blank
    mean_line = [x for x in lines if x.startswith("MEAN aliasing-floor PSNR over 2 views:")]
    assert len(mean_line) == 1


def test_aliasing_floor_reads_the_generator_config(tmp_path):
    split = tmp_path / "set" / "val"
    split.mkdir(parents=True)
    (tmp_path / "set" / "create_dataset_config.txt").write_text(
        "resolution = 32\nsmpl_model_path = None\ntexture_path = /nonexistent.png\n")
    cfg = aliasing_floor.generator_config(str(split) + "/")
    assert cfg["resolution"] == "32" and cfg["smpl_model_path"] == "None"
    model, kwargs = aliasing_floor.body_and_colours(cfg)
    assert model.num_vertices == 3120 and list(kwargs) == ["vertex_colors"]
    assert aliasing_floor.generator_config(str(tmp_path / "nowhere" / "val")) == {}


# ------------------------------------------------------------ the chain

TOY_TRAIN = ("--netdepth=2 --netwidth=32 --number_coarse_samples=8 --batchsize=64 "
             "--batchsize_val=128 --val_rays=256 --number_frequencies_postitional=4 "
             "--number_frequencies_directional=2 --lrate=1e-3")
TOY_DISTILL = ("--grid=4 --hidden=8 --l_pos=2 --l_dir=1 --steps=40 --batch=256 --samples=8 "
               "--chunk=64 --tile=8 --images=1 --time_reps=1 --time_tiles=16 --ess_probe=2 "
               "--ess_thresh=0.01 --sigma_thresh=0.05 --probe_res=12 --ray_cull=0")


def test_the_chain_runs_every_step_on_the_cpu_and_records_every_number(tmp_path):
    import image_wise_chain_torch as chain_mod
    out = str(tmp_path / "chain")
    chain = chain_mod.main([f"--out_dir={out}", "--resolution=12", "--views=4",
                            "--canon_epochs=2", "--steps_per_epoch=40", "--iw_epochs=1",
                            f"--train_flags={TOY_TRAIN}", f"--distill_flags={TOY_DISTILL}",
                            "--device=cpu"])
    with open(os.path.join(out, "chain.json")) as fh:
        saved = json.load(fh)
    assert saved == json.loads(json.dumps(chain, default=float))
    assert list(saved["seconds"]) == [
        "dataset_canonical", "dataset_arm25", "teacher", "image_wise", "landscape",
        "measure_render", "inference", "rescore", "aliasing_floor_canonical",
        "aliasing_floor_arm25", "distill"]
    assert saved["card"] is None and saved["device"] == "cpu"
    assert saved["cuts"]["resolution"] == 12 and saved["cuts"]["iw_epochs"] == 1
    assert len(saved["teacher_train"]["val_loss"]) == 2
    assert len(saved["image_wise"]["arm_angles_deg"]) == 2
    assert len(saved["image_wise"]["pose_errors"]) == 1
    land = saved["landscape"]
    assert len(land["landscape"]) == 36 and land["gt_deg"] == pytest.approx([25, 25], abs=1e-4)
    assert land["minimum_loss"] == min(r["loss"] for r in land["landscape"])
    with open(os.path.join(out, "image_wise", "landscape.json")) as fh:
        assert json.load(fh)["landscape"] == land["landscape"]
    assert list(saved["measure_render"]["ms"]) == ["naive_all_rays", "fg_culled", "occupancy",
                                                   "occupancy_prebaked"]
    for key in ("mse", "psnr", "ssim"):
        assert np.isfinite(saved["teacher_scores"][key])
        # scores of the 8-bit files lie close to the float ones
        assert saved["rescored"][key] == pytest.approx(saved["teacher_scores"][key], rel=0.05)
    for name in ("canonical", "arm25"):
        assert np.isfinite(saved["aliasing_floor"][name]["mean"])
    for key in ("teacher", "distilled"):
        assert np.isfinite(saved["distill"][key]["psnr"])
    assert saved["distill"]["latency_ms"]["teacher"] > 0


# ------------------------------------------------------------ devices, imports

def test_the_tools_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    import image_wise_chain_torch as chain_mod
    missing = str(tmp_path / "nothing")
    for call in (lambda: measure_render.main([missing]),
                 lambda: pose_landscape.main(["--run_dir", missing, "--dataset_dir", missing]),
                 lambda: rr.main([f"--renders_dir={missing}"]),
                 lambda: rr.main([f"--scan={missing}"]),
                 lambda: aliasing_floor.main([f"--dataset_dir={missing}"]),
                 lambda: chain_mod.main([f"--out_dir={missing}"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not os.path.exists(missing)


def test_the_tools_import_no_jax_and_no_image_library():
    code = ("import sys\n"
            "from smpl_nerf_tpu_torch.cli import measure_render, pose_landscape\n"
            "from smpl_nerf_tpu_torch.cli import rescore_renders, aliasing_floor\n"
            "import image_wise_chain_torch, measure_render_256_torch, pose_landscape_torch\n"
            "import rescore_renders_torch, aliasing_floor_torch\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'smpl_nerf_tpu', 'tools', 'imageio', 'cv2')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
