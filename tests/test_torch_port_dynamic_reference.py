"""The port's dummy_dynamic pipeline against the plain float32 reference
(dummy_dynamic_reference_torch.py), and --smpl_model_path end to end.

A seeded pkl in the licensed SMPL model's format (300 vertices, 207 pose
blend-shape columns, a csc J_regressor) and seeded nets (W = 64, depth 8,
skip at 4); R = 32 rays of S = 16 samples, on the CPU's plain path, at the
zero pose and at random poses. The draws (one jitter a ray, the sigma noise)
come from one seeded generator on both sides. Then the same comparison with
a planted fault through the seam `pipelines.vertex_attention_warp` must fail
the tolerances: the warp skipped, the attention over half the vertices, and
a per-row max in place of the global one (at a radius and temperature where
the rows' maxima lie far apart, so that the global max underflows rows the
per-row max keeps; the two agree where nothing underflows). Last, a 1-epoch
`train_torch` run on such a pkl, whose run dir reloads the same body.
"""
import _torch_threads  # noqa: F401

import os
import pickle

import numpy as np
import pytest
import torch

import dummy_dynamic_reference_torch as ref_mod
from smpl_nerf_tpu_torch import config as port_config
from smpl_nerf_tpu_torch import pipelines
from smpl_nerf_tpu_torch.cli import inference
from smpl_nerf_tpu_torch.cli import train as train_cli
from smpl_nerf_tpu_torch.data import datasets
from smpl_nerf_tpu_torch.ops import vertex_attention
from smpl_nerf_tpu_torch.pipelines import RenderConfig, build_pipeline
from smpl_nerf_tpu_torch.training import factory
from smpl_nerf_tpu_torch.training.solver import make_loss_fn

V, R, S, W, N_IMG = 300, 32, 16, 64, 3
# float32 on both sides; what differs is the order of the sums (the port's
# attention runs in 512-vertex chunks and takes the -exp(-M) term once at the
# end, its LBS clamps the Rodrigues angle where smplx adds 1e-8), so the
# numbers agree to a few float32 ulps of their own size: 1e-5 relative leaves
# room for that and lies far under what a fault moves (0.1 and more)
WARP_TOL = RGB_TOL = LOSS_TOL = GRAD_TOL = 1e-5


def write_pkl(path, seed: int, n_vertices: int = V) -> dict:
    """A body in SMPL's pkl format: vertices in a box around the origin,
    small blend shapes, a sparse regressor, smooth skinning weights."""
    from scipy.sparse import csc_matrix

    rs = np.random.RandomState(seed)
    v = rs.uniform(-0.4, 0.4, (n_vertices, 3)) * np.array([1.0, 2.0, 0.5])
    reg = np.zeros((24, n_vertices))
    for j in range(24):
        reg[j, rs.choice(n_vertices, 8, replace=False)] = 1.0 / 8.0
    w = rs.uniform(0.0, 1.0, (n_vertices, 24)) ** 4
    parents = np.array([-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12,
                        13, 14, 16, 17, 18, 19, 20, 21])
    body = {"v_template": v, "shapedirs": rs.normal(0, 1e-2, (n_vertices, 3, 10)),
            "posedirs": rs.normal(0, 1e-2, (n_vertices, 3, 207)),
            "J_regressor": csc_matrix(reg), "weights": w / w.sum(1, keepdims=True),
            "f": rs.randint(0, n_vertices, (2 * n_vertices - 4, 3)).astype(np.uint32),
            "kintree_table": np.stack([parents, np.arange(24)]), "bs_style": "lbs"}
    with open(path, "wb") as fh:
        pickle.dump(body, fh, protocol=2)
    return body


def _argv(pkl, radius, temperature):
    return ["--config=", "--model_type=dummy_dynamic", "--netdepth=8", f"--netwidth={W}",
            "--skips=4", f"--number_coarse_samples={S}", "--use_pallas=0",
            "--use_fused_mlp=0", "--sigma_noise_std=1", "--white_background=1",
            f"--warp_radius={radius}", f"--warp_temperature={temperature}",
            f"--smpl_model_path={pkl}", "--seed=5"]


def _case(tmp_path, pose_kind, radius=0.15, temperature=1e4, seed=11, dtype="float32"):
    """(port outputs, reference outputs) of one batch from the same weights and draws."""
    pkl = str(tmp_path / "body.pkl")
    body = write_pkl(pkl, seed)
    args = port_config.config_parser().parse_args(_argv(pkl, radius, temperature)
                                                  + [f"--compute_dtype={dtype}"])
    rs = np.random.RandomState(seed + 1)
    poses = np.zeros((N_IMG, 69), np.float32)
    if pose_kind == "random":
        poses = rs.normal(0.0, 0.4, (N_IMG, 69)).astype(np.float32)
    extras = {"betas": rs.normal(0, 1, 10).astype(np.float32), "goal_poses": poses,
              "smpl_model": factory.smpl_model_for(args)}
    models, encoders = factory.build_models_and_params(args, seed=seed, device="cpu",
                                                       extras=extras)
    pipeline = build_pipeline(RenderConfig.from_args(args), models, encoders, extras)
    origins = np.tile(np.float32([[0.0, 0.0, 2.5]]), (R, 1))
    dirs = np.concatenate([rs.uniform(-0.25, 0.25, (R, 2)), -np.ones((R, 1))], 1)
    batch = {"ray_translation": torch.tensor(origins), "ray_direction": torch.tensor(dirs,
                                                                                  dtype=torch.float32),
             "image_indices": torch.tensor(rs.randint(0, N_IMG, R)),
             "rgb": torch.tensor(rs.uniform(0, 1, (R, 3)), dtype=torch.float32)}
    coarse = models["model_coarse"]
    loss, aux = make_loss_fn(pipeline)(batch, torch.Generator().manual_seed(7), True)
    out = pipeline(batch, torch.Generator().manual_seed(7), True)
    grads = torch.autograd.grad(loss, list(coarse.parameters()))
    port = {"warp": out["warp"].detach(), "rgb": out["rgb_coarse"].detach(),
            "loss": loss.detach(), "grads": dict(zip([k for k, _ in coarse.named_parameters()],
                                                     grads))}
    g = torch.Generator().manual_seed(7)
    jitter = torch.rand((R, 1), generator=g)
    noise = torch.randn((R, S), generator=g)
    params = {k: p.detach().clone().requires_grad_(True) for k, p in coarse.named_parameters()}
    cfg = ref_mod.Config(number_coarse_samples=S, warp_radius=radius,
                         warp_temperature=temperature, frequencies_positional=10,
                         frequencies_directional=4, netdepth=8, skips=(4,),
                         white_background=True)
    rb = {"origins": batch["ray_translation"], "directions": batch["ray_direction"],
          "image": batch["image_indices"], "rgb": batch["rgb"]}
    r = ref_mod.forward(cfg, params, body, torch.as_tensor(extras["betas"]),
                        torch.as_tensor(poses), rb, jitter, noise)
    r["grads"] = dict(zip(params, torch.autograd.grad(r["loss"], list(params.values()))))
    return port, {k: (v.detach() if torch.is_tensor(v) else v) for k, v in r.items()}


def _rel(a, b) -> float:
    return float(torch.linalg.norm(a - b) / torch.clamp(torch.linalg.norm(b), min=1e-30))


def _gaps(port, ref) -> dict:
    return {"warp": _rel(port["warp"], ref["warp"]), "rgb": _rel(port["rgb"], ref["rgb"]),
            "loss": _rel(port["loss"], ref["loss"]),
            "grad": max(_rel(port["grads"][k], ref["grads"][k]) for k in ref["grads"])}


def _within(gaps) -> bool:
    return (gaps["warp"] <= WARP_TOL and gaps["rgb"] <= RGB_TOL and gaps["loss"] <= LOSS_TOL
            and gaps["grad"] <= GRAD_TOL)


@pytest.mark.parametrize("pose_kind", ["zero", "random"])
def test_plain_path_matches_the_reference(tmp_path, pose_kind):
    port, ref = _case(tmp_path, pose_kind)
    # at the zero pose every goal vertex is canonical: the warps are 0
    assert (float(torch.linalg.norm(ref["warp"])) > 0.0) == (pose_kind == "random")
    gaps = _gaps(port, ref)
    assert _within(gaps), gaps


def _row_max_warp(samples, goal, warps, radius, temperature, chunk_size=512):
    """The attention with each sample's own max in place of the global one."""
    att = torch.relu(radius - vertex_attention._dist(samples, goal)) * temperature
    m = att.max(-1, keepdim=True).values
    e = torch.exp(att - m)
    numer = torch.bmm(e, warps) - torch.exp(-m) * warps.sum(1)[:, None, :]
    return numer / torch.clamp(e.sum(-1)[..., None], min=1e-30)


FAULTS = {
    "warp_skipped": lambda f: (lambda s, g, w, r, t, **k: torch.zeros_like(s)),
    "vertices_halved": lambda f: (lambda s, g, w, r, t, **k: f(s, g[:, :g.shape[1] // 2],
                                                               w[:, :w.shape[1] // 2], r, t)),
    "row_max": lambda f: _row_max_warp,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_attention_fault_fails_the_tolerances(tmp_path, monkeypatch, fault):
    # radius 0.6, temperature 1e3: logits up to 600, rows' maxima hundreds apart
    kw = {"radius": 0.6, "temperature": 1e3} if fault == "row_max" else {}
    _, ref = _case(tmp_path, "random", **kw)
    monkeypatch.setattr(pipelines, "vertex_attention_warp",
                        FAULTS[fault](vertex_attention.vertex_attention_warp))
    port, _ = _case(tmp_path, "random", **kw)
    gaps = _gaps(port, ref)
    assert not _within(gaps), gaps
    assert gaps["warp"] > 100 * WARP_TOL, gaps


def test_the_nets_in_bfloat16_fail_the_tolerances(tmp_path):
    # a precision below the float32 the reference states shows in rgb, loss and gradients
    _, ref = _case(tmp_path, "random")
    port, _ = _case(tmp_path, "random", dtype="bfloat16")
    gaps = _gaps(port, ref)
    assert not _within(gaps) and gaps["warp"] <= WARP_TOL, gaps


def test_train_torch_trains_on_the_named_body_and_the_run_dir_reloads_it(tmp_path):
    pkl = str(tmp_path / "body.pkl")
    write_pkl(pkl, 3, n_vertices=120)
    rs = np.random.RandomState(0)
    from smpl_nerf_tpu_torch.cli import render_path
    cams = render_path.camera_path_data("circle", 3, 2.4, -90, 90, 8, [41, 38], 0.0)
    poses = np.zeros((3, 69), np.float32)
    poses[:, 38] = [0.0, 0.3, 0.6]
    images = rs.uniform(0, 1, (3, 8, 8, 3)).astype(np.float32)
    for split, sl in (("train", slice(0, 2)), ("val", slice(2, 3))):
        datasets.write_dataset(str(tmp_path / "data" / split), images[sl],
                               cams.camera_transforms[sl], np.pi / 3, poses[sl])
    run_dir = str(tmp_path / "run")
    argv = ["--config=", "--model_type=dummy_dynamic", f"--dataset_dir={tmp_path / 'data'}",
            "--num_epochs=1", "--steps_per_epoch=2", "--batchsize=32", "--batchsize_val=64",
            "--number_coarse_samples=4", "--netdepth=2", "--netwidth=16",
            "--number_frequencies_postitional=2", "--number_frequencies_directional=1",
            "--warp_radius=0.1", "--use_pallas=0", "--render_gif=0",
            "--number_validation_images=0", f"--smpl_model_path={pkl}"]
    sol = train_cli.train(argv, log_dir=run_dir, device="cpu")
    assert np.isfinite(sol.history["step_loss"]).all()
    assert sol.pipeline.passes.extras["smpl_model"].num_vertices == 120
    with open(os.path.join(run_dir, "config.txt")) as fh:
        assert f"smpl_model_path = {pkl}\n" in fh.read()
    args = inference.setup_from_run_dir(run_dir)
    assert args.smpl_model_path == pkl and args._smpl_model.num_vertices == 120
    assert args._smpl_model.posedirs.shape == (120, 3, 207)
    missing = argv[:-1] + [f"--smpl_model_path={tmp_path / 'none.pkl'}"]
    with pytest.raises(FileNotFoundError, match="names no file"):
        train_cli.train(missing, log_dir=str(tmp_path / "run2"), device="cpu")
