"""The span recorder (`smpl_nerf_tpu_torch/tracing.py`) on the CPU.

Off, `span` is one shared no-op and nothing is recorded. On, a two-step
`Solver.train` of a tiny smpl_nerf run and two `render_rays_batched` calls
record every span the program names, each under the span it was opened in
and with its step, epoch or call as the request; the losses and images are
the same bits with the recorder on and off; each span's ends lie within 1 ms
of its `record_function` event's in a CPU profile; a full buffer drops spans
and counts them. Sizes: 4x4 views, 2x16 nets, 4 + 4 samples.
"""
import _torch_threads  # noqa: F401

import collections

import numpy as np
import pytest
import torch

from smpl_nerf_tpu_torch import config as port_config
from smpl_nerf_tpu_torch import tracing
from smpl_nerf_tpu_torch.data.datasets import RayData
from smpl_nerf_tpu_torch.pipelines import RenderConfig, build_pipeline
from smpl_nerf_tpu_torch.render.batched import render_rays_batched
from smpl_nerf_tpu_torch.training import factory
from smpl_nerf_tpu_torch.training.solver import Solver

RES = 4
ARGV = ["--config=", "--model_type=smpl_nerf", "--num_epochs=1", "--steps_per_epoch=2",
        "--batchsize=16", "--batchsize_val=8", "--number_coarse_samples=4",
        "--number_fine_samples=4", "--run_fine=1", "--netdepth=2", "--netwidth=16",
        "--netdepth_fine=2", "--netwidth_fine=16", "--netwidth_warp=8",
        "--number_frequencies_postitional=2", "--number_frequencies_directional=1",
        "--number_frequencies_pose=1", "--use_pallas=0", "--sigma_noise_std=1",
        "--render_gif=0", "--number_validation_images=0", "--seed=3"]
PASS_PARTS = {"pass.sample", "pass.warp", "pass.net", "pass.integrate"}
TRAIN_SPANS = {"solver.epoch", "solver.draw", "solver.gather", "solver.step", "solver.forward",
               "solver.backward", "solver.optimizer", "solver.loss_read", "solver.validate",
               "solver.save", "pass.coarse", "pass.fine"} | PASS_PARTS
RENDER_SPANS = {"render.view", "render.upload", "render.batch", "render.readback",
                "pass.coarse", "pass.fine"} | PASS_PARTS


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    yield
    tracing.disable()


def _rays(seed: int, n_img: int) -> RayData:
    rs = np.random.RandomState(seed)
    n = n_img * RES * RES
    dirs = np.concatenate([rs.uniform(-0.3, 0.3, (n, 2)), -np.ones((n, 1))], 1)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    cams = np.stack([np.eye(4)] * n_img).astype(np.float32)
    return RayData(origins=np.tile(np.float32([[0.0, 0.0, 2.5]]), (n, 1)),
                   directions=dirs.astype(np.float32),
                   image_indices=np.repeat(np.arange(n_img, dtype=np.int32), RES * RES),
                   h=RES, w=RES, focal=4.0, num_images=n_img, camera_transforms=cams,
                   human_poses=rs.uniform(-0.3, 0.3, (n_img, 69)).astype(np.float32),
                   rgb=rs.uniform(0, 1, (n, 3)).astype(np.float32))


def _pipeline(args, data):
    extras = factory.dataset_extras(args, data)
    models, encoders = factory.build_models_and_params(args, seed=3, device="cpu",
                                                       extras=extras)
    return build_pipeline(RenderConfig.from_args(args), models, encoders, extras)


def _train(tmp_path):
    """Losses of a two-step epoch with its validation and run-dir save."""
    args = port_config.config_parser().parse_args(ARGV)
    train, val = _rays(0, 2), _rays(1, 1)
    solver = Solver(_pipeline(args, train), args, log_dir=str(tmp_path / "run"))
    solver.train(train, val)
    return solver.history["step_loss"] + solver.history["val_loss"]


def _render(tmp_path):
    """Two views of 16 rays in batches of 8."""
    args = port_config.config_parser().parse_args(ARGV)
    pipeline = _pipeline(args, _rays(2, 1))
    return [render_rays_batched(pipeline, _rays(s, 1), 8, torch.device("cpu")) for s in (2, 3)]


WORK = {"train": _train, "render": _render}


def _by_parent(spans):
    return [spans[s.parent].name if s.parent is not None else None for s in spans]


def test_off_records_nothing_and_shares_one_noop(tmp_path):
    assert tracing.span("a") is tracing.span("b", request=3)
    assert not tracing.enabled()
    tracing.enable(16)
    tracing.disable()
    _render(tmp_path)
    assert tracing.snapshot() == ([], 0)


def test_training_records_every_span_under_its_parent(tmp_path):
    tracing.enable(1 << 12)
    _train(tmp_path)
    spans, dropped = tracing.snapshot()
    assert dropped == 0 and all(s.end_ns >= s.start_ns for s in spans)
    assert {s.name for s in spans} == TRAIN_SPANS
    parents = _by_parent(spans)
    by_name = collections.defaultdict(list)
    for s, parent in zip(spans, parents):
        by_name[s.name].append((parent, s.request))
    assert by_name["solver.epoch"] == [(None, 0)]
    for name in ("solver.draw", "solver.gather", "solver.step", "solver.loss_read"):
        assert by_name[name] == [("solver.epoch", 0), ("solver.epoch", 1)], name
    for name in ("solver.forward", "solver.backward", "solver.optimizer"):
        assert by_name[name] == [("solver.step", 0), ("solver.step", 1)], name
    assert by_name["solver.validate"] == by_name["solver.save"] == [("solver.epoch", 0)]
    # one coarse and fine pass a step, and one each for the validation's two batches
    for name in ("pass.coarse", "pass.fine"):
        assert by_name[name] == [("solver.forward", 0), ("solver.forward", 1),
                                 ("solver.validate", 0), ("solver.validate", 0)], name
    for s, parent in zip(spans, parents):
        if s.name in PASS_PARTS:
            assert parent in ("pass.coarse", "pass.fine")
            assert s.request == spans[s.parent].request
    for s in spans:
        if s.parent is not None:
            outer = spans[s.parent]
            assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns


def test_rendering_records_every_span_under_its_parent(tmp_path):
    tracing.enable(1 << 12)
    _render(tmp_path)
    spans, dropped = tracing.snapshot()
    assert dropped == 0
    assert {s.name for s in spans} == RENDER_SPANS
    parents = _by_parent(spans)
    views = [s.request for s in spans if s.name == "render.view"]
    assert len(views) == 2 and views[1] == views[0] + 1
    count = collections.Counter((s.name, p, s.request) for s, p in zip(spans, parents))
    for view in views:
        assert count["render.view", None, view] == 1
        assert count["render.upload", "render.view", view] == 1
        assert count["render.batch", "render.view", view] == 2
        assert count["render.readback", "render.view", view] == 1
        assert count["pass.coarse", "render.batch", view] == 2
        assert count["pass.fine", "render.batch", view] == 2
    assert sum(1 for s in spans if s.name == "pass.warp") == 8


@pytest.mark.parametrize("work", sorted(WORK))
def test_results_are_bit_equal_with_the_recorder_on_and_off(tmp_path, work):
    off = WORK[work](tmp_path / "off")
    tracing.enable(1 << 12)
    on = WORK[work](tmp_path / "on")
    tracing.disable()
    assert len(tracing.snapshot().spans) > 0
    for a, b in zip(off, on, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("work", sorted(WORK))
def test_span_ends_match_the_profilers_events(tmp_path, work):
    from torch.profiler import ProfilerActivity, profile

    tracing.enable(1 << 12)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        WORK[work](tmp_path)
    tracing.disable()
    spans = tracing.snapshot().spans
    names = {s.name for s in spans}
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            events[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    worst = 0
    for name in names:
        ours = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        theirs = sorted(events[name])
        assert len(ours) == len(theirs), name
        for (a, b), (c, d) in zip(ours, theirs):
            worst = max(worst, abs(a - c), abs(b - d))
    assert worst <= 1_000_000, worst


def test_a_span_may_hold_a_profilers_start_or_stop():
    from torch.profiler import ProfilerActivity, profile

    tracing.enable(16)
    prof = profile(activities=[ProfilerActivity.CPU])
    with tracing.span("solver.epoch", request=0):
        prof.start()
        with tracing.span("solver.step", request=0):
            torch.ones(3).sum()
    with tracing.span("solver.epoch", request=1):
        with tracing.span("solver.step", request=1):
            prof.stop()
    assert "solver.step" in {e.name() for e in prof.profiler.kineto_results.events()}
    assert [s.name for s in tracing.snapshot().spans] == ["solver.epoch", "solver.step"] * 2


def test_end_ranges_ends_the_open_spans_ranges_before_a_profiler_stops():
    """The ranges end inside the profile (its events hold them); the spans
    stay open until their own exit."""
    from torch.profiler import ProfilerActivity, profile

    tracing.enable(16)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with tracing.span("solver.epoch", request=0):
        with tracing.span("solver.step", request=0):
            torch.ones(3).sum()
            assert tracing.end_ranges() == 2
            prof.stop()
            assert tracing.snapshot().spans[1].end_ns is None
    assert tracing.end_ranges() == 0
    spans = tracing.snapshot().spans
    assert [s.name for s in spans] == ["solver.epoch", "solver.step"]
    assert all(s.end_ns is not None for s in spans)
    assert {"solver.epoch", "solver.step"} <= {e.name() for e in
                                               prof.profiler.kineto_results.events()}


def test_a_kernel_build_is_an_ops_load_span_and_counted(tmp_path, monkeypatch):
    from smpl_nerf_tpu_torch.ops import _build

    nvcc = tmp_path / "nvcc"      # writes the library it is asked for, as nvcc would, and counts
    runs = tmp_path / "runs"
    nvcc.write_text(f'#!/bin/sh\necho run >> "{runs}"\n'
                    'while [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    tracing.enable(16)
    _build.build_all(("sample_pdf", "relu_matmul"))
    _build.build_all(("sample_pdf",))          # built already: no nvcc run
    assert runs.read_text().split() == ["run", "run"]
    assert [s.name for s in tracing.snapshot().spans] == ["ops.load", "ops.load"]
    assert _build.library_path("relu_matmul").exists()


@pytest.mark.parametrize("capacity", [0, 5])
def test_a_full_buffer_drops_spans_and_counts_them(tmp_path, capacity):
    tracing.enable(1 << 12)
    _render(tmp_path)
    total = len(tracing.snapshot().spans)
    tracing.enable(capacity)
    _render(tmp_path)
    spans, dropped = tracing.snapshot()
    assert len(spans) == capacity and dropped == total - capacity
    assert [s.name for s in spans] == ["render.view", "render.upload", "render.batch",
                                       "pass.coarse", "pass.sample"][:capacity]
    assert all(s.end_ns is not None for s in spans)
    assert all(s.parent is None or s.parent < i for i, s in enumerate(spans))
