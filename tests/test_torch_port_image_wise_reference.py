"""The port's image_wise_dynamic trainer against the plain float32 reference
(image_wise_reference_torch.py), its spans and counters, and a train_torch
run on a named body and a saved frozen net.

A seeded pkl in the licensed SMPL model's format (300 vertices, 207 pose
blend-shape columns; tests/test_torch_port_dynamic_reference.py's
`write_pkl`), a seeded frozen net (W = 64, depth 8, skip at 4) and R = 32
rays of S = 16 samples a step, on the CPU's plain path. The trainer's own
loop (`train_image_wise`) runs three steps, stopped by its step callback;
its rays, depths and targets are kept at the seam `image_wise.make_pose_loss`
and handed to the reference, which repeats the three steps from the same
start. Two starts: the zero pose, as the benchmark's cell starts (there
goal = canonical, so the first step's warps are 0), and a posed body. Then
the same comparison with a planted fault through the seam
`image_wise.relu_attention_warp` must fail the tolerances: the goal vertices
detached inside the attention, the attention over half the vertices, the
radius halved.
"""
import _torch_threads  # noqa: F401

import os

import numpy as np
import pytest
import torch

import image_wise_reference_torch as ref_mod
from smpl_nerf_tpu_torch import config as port_config
from smpl_nerf_tpu_torch import tracing
from smpl_nerf_tpu_torch.cli import inference
from smpl_nerf_tpu_torch.cli import train as train_cli
from smpl_nerf_tpu_torch.data import datasets
from smpl_nerf_tpu_torch.data.datasets import RayData
from smpl_nerf_tpu_torch.models import smpl as smpl_mod
from smpl_nerf_tpu_torch.ops import vertex_attention
from smpl_nerf_tpu_torch.training import factory, image_wise
from test_torch_port_dynamic_reference import write_pkl

V, R, S, W, SIDE = 300, 32, 16, 64, 8
STEPS = 3
# (loss, gradient, angles) tolerances by start. Float32 on both sides; what
# differs is the order of the sums (the port's attention runs in 512-vertex
# chunks, its LBS clamps the Rodrigues angle where smplx adds 1e-8, torch's
# Adam fuses its update). The loss agrees to a few float32 ulps: 1e-5. From
# the zero pose the warps stay under a millimetre for three steps and the rest
# agrees to ~1e-7: 1e-4 on the gradients, 1e-5 on the angles, under the
# goal_detached fault's 1.7e-3 and 7.9e-5 (the weaker of the faults there).
# From a posed body the warps are ~0.3 m, and w = att / (sum att + 1e-5) rises
# from 0 to 1 within ~1e-5 of a sphere's edge: a float32 rounding of one such
# sample's distance moves the gradient by up to ~1e-3 (6.5e-4 here, 5.2e-5 on
# the angles), so 1e-2 and 1e-3, under every fault's 2.9 and 0.15 and more.
TOLERANCES = {"zero": (1e-5, 1e-4, 1e-5), "posed": (1e-5, 1e-2, 1e-3)}


def _argv(pkl, net, dataset_dir="", extra=()):
    return ["--config=", "--model_type=image_wise_dynamic", "--netdepth=8", f"--netwidth={W}",
            "--skips=4", f"--number_coarse_samples={S}", "--use_pallas=0",
            "--use_fused_mlp=0", "--sigma_noise_std=0", "--white_background=1",
            "--warp_radius=0.15", "--lrate_pose=3e-3", f"--batchsize={R}",
            f"--smpl_model_path={pkl}", f"--load_coarse_model={net}", "--seed=5",
            f"--dataset_dir={dataset_dir}", *extra]


def _frozen_net(path, seed):
    """A seeded coarse net saved as a state dict, as --load_coarse_model takes it."""
    from smpl_nerf_tpu_torch.models.render_ray_net import RenderRayNet

    net = RenderRayNet(n_layers=8, width=W, positions_dim=60, directions_dim=24, skips=(4,),
                       generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():               # nonzero biases, as a trained net has
        for name, p in net.named_parameters():
            if name.endswith(".bias"):
                p.normal_(0.0, 0.1, generator=g)
    state = {k: v.detach().clone() for k, v in net.state_dict().items()}
    torch.save(state, path)
    return state


def _rays(rs):
    """Two 8 x 8 images of rays from (0, 0, 2.5) looking down -z across the body."""
    n = 2 * SIDE * SIDE
    origins = np.tile(np.float32([[0.0, 0.0, 2.5]]), (n, 1))
    dirs = np.concatenate([rs.uniform(-0.25, 0.25, (n, 2)), -np.ones((n, 1))], 1)
    return RayData(origins=origins, directions=dirs.astype(np.float32),
                   image_indices=np.repeat(np.arange(2, dtype=np.int32), SIDE * SIDE),
                   h=SIDE, w=SIDE, focal=10.0, num_images=2,
                   camera_transforms=np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)),
                   human_poses=np.zeros((2, 69), np.float32),
                   rgb=rs.uniform(0, 1, (n, 3)).astype(np.float32))


def _case(tmp_path, start, monkeypatch, fault=None, seed=11):
    """(the port's three steps, the reference's) from the same body, net, rays and depths."""
    pkl, net_path = str(tmp_path / "body.pkl"), str(tmp_path / "net.pt")
    body = write_pkl(pkl, seed)
    net = _frozen_net(net_path, seed)
    args = port_config.config_parser().parse_args(_argv(pkl, net_path))
    rs = np.random.RandomState(seed + 1)
    data = _rays(rs)
    base = (rs.normal(0.0, 0.3, 69).astype(np.float32) if start == "posed"
            else np.zeros(69, np.float32))
    extras = {"betas": np.zeros(10, np.float32), "smpl_model": factory.smpl_model_for(args),
              "canonical_pose": base}
    batches, port = [], {"losses": [], "grads": [], "angles": []}
    make, attention = image_wise.make_pose_loss, image_wise.relu_attention_warp

    def recording_make(*a, **k):
        inner = make(*a, **k)

        def pose_loss(pose, origins, dirs, z_vals, rgb):
            batches.append({"origins": origins, "directions": dirs, "z_vals": z_vals, "rgb": rgb})
            return inner(pose, origins, dirs, z_vals, rgb)

        return pose_loss

    def faulty(samples, goal, warps, radius, **k):
        if fault == "goal_detached":
            goal = goal.detach()
        elif fault == "vertices_halved":
            goal, warps = goal[:V // 2], warps[:V // 2]
        elif fault == "radius_halved":
            radius = radius / 2.0
        return attention(samples, goal, warps, radius, **k)

    def callback(step, loss, models):
        est = models["smpl_estimator"]
        port["losses"].append(loss)
        port["grads"].append(torch.cat([est.arm_angle_l.grad, est.arm_angle_r.grad]).clone())
        port["angles"].append(torch.cat([est.arm_angle_l, est.arm_angle_r]).detach().clone())
        return step == STEPS

    monkeypatch.setattr(image_wise, "make_pose_loss", recording_make)
    monkeypatch.setattr(image_wise, "relu_attention_warp", faulty)
    np.random.seed(5)
    final, _ = image_wise.train_image_wise(args, None, data, None, extras, device="cpu",
                                           step_callback=callback)
    for key, value in net.items():                           # the frozen net, bit for bit
        assert torch.equal(final["model_coarse"][key], value), key
    params = {k: v for k, v in net.items()}
    ref = ref_mod.train_steps(ref_mod.Config(frequencies_positional=10,
                                             frequencies_directional=4, netdepth=8,
                                             skips=(4,)),
                              params, body, torch.zeros(10), torch.zeros(2), batches, 3e-3,
                              torch.as_tensor(base))
    return port, ref


def _rel(a, b) -> float:
    return float(torch.linalg.norm(a - b) / torch.clamp(torch.linalg.norm(b), min=1e-30))


def _gaps(port, ref) -> dict:
    return {"loss": max(abs(a - b) / b for a, b in zip(port["losses"], ref["losses"])),
            "grad": max(_rel(a, b) for a, b in zip(port["grads"], ref["grads"])),
            "angles": _rel(port["angles"][-1], ref["angles"][-1])}


def _within(g, start) -> bool:
    loss, grad, angles = TOLERANCES[start]
    return g["loss"] <= loss and g["grad"] <= grad and g["angles"] <= angles


@pytest.mark.parametrize("start", ["zero", "posed"])
def test_the_trainers_steps_match_the_reference(tmp_path, monkeypatch, start):
    port, ref = _case(tmp_path, start, monkeypatch)
    assert len(port["losses"]) == STEPS and len(ref["losses"]) == STEPS
    # the first step's warps are 0 exactly at the zero pose, and not once it moved
    assert (float(torch.linalg.norm(ref["warps"][0])) > 0.0) == (start == "posed")
    assert float(torch.linalg.norm(ref["warps"][1])) > 0.0
    assert all(float(torch.linalg.norm(g)) > 0.0 for g in ref["grads"])
    gaps = _gaps(port, ref)
    assert _within(gaps, start), gaps


@pytest.mark.parametrize("start", ["zero", "posed"])
@pytest.mark.parametrize("fault", ["goal_detached", "vertices_halved", "radius_halved"])
def test_a_planted_attention_fault_fails_the_tolerances(tmp_path, monkeypatch, start, fault):
    port, ref = _case(tmp_path, start, monkeypatch, fault=fault)
    gaps = _gaps(port, ref)
    assert not _within(gaps, start), gaps


def test_a_traced_step_records_its_spans_nested_and_the_counters(tmp_path, monkeypatch):
    pkl, net_path = str(tmp_path / "body.pkl"), str(tmp_path / "net.pt")
    write_pkl(pkl, 3)
    _frozen_net(net_path, 3)
    args = port_config.config_parser().parse_args(_argv(pkl, net_path))
    data = _rays(np.random.RandomState(0))
    extras = {"betas": np.zeros(10, np.float32), "smpl_model": factory.smpl_model_for(args)}
    before = (vertex_attention.relu_calls, vertex_attention.relu_pairs, smpl_mod.lbs_calls)
    tracing.enable(1024)
    try:
        image_wise.train_image_wise(args, None, data, None, extras, device="cpu",
                                    step_callback=lambda step, loss, models: step == 2)
    finally:
        tracing.disable()
    assert vertex_attention.relu_calls - before[0] == 2
    assert vertex_attention.relu_pairs - before[1] == 2 * R * S * V
    assert smpl_mod.lbs_calls - before[2] == 2 * 2                # canonical and goal a step
    snap = tracing.snapshot()
    assert snap.dropped == 0
    names = [s.name for s in snap.spans]

    def parent(i):
        p = snap.spans[i].parent
        return None if p is None else names[p]

    assert names.count("solver.step") == 2 and names.count("solver.loss_read") == 2
    assert names.count("solver.epoch") == 1 and parent(names.index("solver.epoch")) is None
    expected = {"solver.step": "solver.epoch", "solver.loss_read": "solver.epoch",
                "solver.forward": "solver.step", "solver.backward": "solver.step",
                "solver.optimizer": "solver.step", "pass.lbs": "solver.forward",
                "pass.warp": "solver.forward", "pass.net": "solver.forward",
                "pass.integrate": "solver.forward"}
    assert set(names) == set(expected) | {"solver.epoch"}
    for i, name in enumerate(names):
        if name in expected:
            assert parent(i) == expected[name], (name, parent(i))
    steps = [s for s in snap.spans if s.name == "solver.step"]
    assert [s.request for s in steps] == [1, 2]
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in snap.spans)


def test_train_torch_runs_on_the_named_body_and_keeps_the_frozen_net(tmp_path):
    pkl, net_path = str(tmp_path / "body.pkl"), str(tmp_path / "net.pt")
    write_pkl(pkl, 3, n_vertices=120)
    net = _frozen_net(net_path, 4)
    from smpl_nerf_tpu_torch.cli import render_path
    cams = render_path.camera_path_data("circle", 3, 2.4, -90, 90, 8, [41, 38], 0.0)
    poses = np.zeros((3, 69), np.float32)
    poses[:, [38, 41]] = np.deg2rad(25.0)
    images = np.random.RandomState(0).uniform(0, 1, (3, 8, 8, 3)).astype(np.float32)
    for split, sl in (("train", slice(0, 2)), ("val", slice(2, 3))):
        datasets.write_dataset(str(tmp_path / "data" / split), images[sl],
                               cams.camera_transforms[sl], np.pi / 3, poses[sl])
    run_dir = str(tmp_path / "run")
    argv = _argv(pkl, net_path, str(tmp_path / "data"),
                 ("--num_epochs=1", "--render_gif=0", "--number_validation_images=0"))
    final, errors = train_cli.train(argv, log_dir=run_dir, device="cpu")
    assert len(errors) == 1 and np.isfinite(errors).all()
    for key, value in net.items():
        assert torch.equal(final["model_coarse"][key], value), key
    saved = torch.load(os.path.join(run_dir, "model_coarse.pt"))
    assert all(torch.equal(saved[k], v) for k, v in net.items())
    assert float(final["smpl_estimator"]["arm_angle_l"].abs()) > 0      # the pose moved
    with open(os.path.join(run_dir, "config.txt")) as fh:
        assert f"smpl_model_path = {pkl}\n" in fh.read()
    args = inference.setup_from_run_dir(run_dir)
    assert args.smpl_model_path == pkl and args._smpl_model.num_vertices == 120
    assert args._smpl_model.posedirs.shape == (120, 3, 207)
