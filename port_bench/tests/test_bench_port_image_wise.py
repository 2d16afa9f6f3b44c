"""The image_wise_dynamic cell's own pieces on the CPU: the cell resolves,
the benchmark's reference against the repository's plain one, a tiny
rehearsal of the train_image_wise traffic (the plain path against the
reference, each planted fault and the float8 control against the committed
limits), the attention's float64 gradient against autograd of the
repository's attention, the readers on hand-made records, and the committed
calibration."""
import json
import time
import types

import numpy as np
import pytest
import torch

import image_wise_reference_torch as repo_ref
from port_bench import body as body_mod
from port_bench import checks, harness, reference, scene
from port_bench import reference_dummy_dynamic as ref_dyn
from port_bench import reference_image_wise as bench_ref

CELL = "image_wise_dynamic.train"
SEED = 2 ** 33 + 7
TINY_FLAGS = {"netdepth": 3, "netwidth": 32, "netdepth_fine": 3, "netwidth_fine": 32,
              "skips": [1], "skips_fine": [1], "batchsize": 256, "number_coarse_samples": 8}
TINY_TRAFFIC = {"train_views": 3, "resolution": 32, "warmup_steps": 4, "trace_steps": 4,
                "labelled_steps": 2}
FAULTS = ("goal_detached", "vertices_halved", "radius_halved")
METRICS = {"train.launches_per_step", "train.device_idle_pct", "train.idle_in_lbs_pct",
           "train.vertex_attention_ms_per_step", "train.backward_ms_per_step",
           "train.lbs_calls_per_step"}


def test_the_cell_resolves_with_every_file_it_names():
    w = harness.resolve(CELL)
    assert w.chips == 1 and w.traffic["kind"] == "train_image_wise"
    assert w.flags["model_type"] == "image_wise_dynamic" and w.config["reduced"] == []
    assert (w.flags["netwidth"], w.flags["netdepth"], w.flags["batchsize"]) == (256, 8, 2048)
    assert w.traffic["resolution"] == 256 and w.traffic["train_views"] == 40
    assert w.traffic["arm_deg"] == [25.0, 25.0]
    assert {m["name"] for m in w.end_to_end} == {"train_rays_per_s", "setup_s"}
    assert {m["name"] for m in w.per_layer} == METRICS
    assert set(w.cell["limits"]) == {"loss1_gap", "pose_grad_gap", "warp_gap", "angles_gap",
                                     "goal_vjp_gap"}
    assert hasattr(w.generator(), "run")


def test_the_benchmark_reference_follows_the_repositorys():
    flags = dict(harness.resolve(CELL).flags, **TINY_FLAGS, compute_dtype="float32")
    net = scene.lecun_weights(reference.Widths(flags).shapes(), SEED, "cpu")["model_coarse"]
    body = body_mod.make_body(SEED)
    views = scene.make_views(SEED, 11, 1, 9.0, {"resolution": 32, "radius": 2.4,
                                                "fov_deg": 60.0, "arm_deg": [25.0, 25.0]},
                             flags["human_joints"], True, "cpu", with_rgb=True)
    g = torch.Generator().manual_seed(1)
    z = reference.coarse_z(1.0, 4.0, 8, 1, g, "cpu").expand(24, 8)
    on_body = torch.nonzero((views["rgb"][0] < 1.0).any(-1))[:, 0]      # not the background
    batches = []
    for _ in range(3):
        i = on_body[torch.randperm(on_body.shape[0], generator=g)[:24]]
        batches.append({"origins": views["origins"][0][i], "directions": views["directions"][0][i],
                        "z_vals": z, "rgb": views["rgb"][0][i]})
    ours = bench_ref.train_steps(flags, net, ref_dyn.body_tensors(body_mod.arrays(body), "cpu"),
                                 batches, "float32", block=5)
    cfg = repo_ref.Config(netdepth=3, skips=(1,))
    theirs = repo_ref.train_steps(cfg, net, body, torch.zeros(10), torch.zeros(2), batches, 3e-3)
    assert float(torch.linalg.norm(theirs["warps"][1])) > 0
    assert all(float(torch.linalg.norm(g)) > 0 for g in theirs["grads"])
    readings = bench_ref.readings(ours, theirs, bench_ref.replay_adam(flags, theirs["grads"]))
    assert readings["loss1_gap"] < 1e-6 and readings["pose_grad_gap"] < 1e-4, readings
    assert readings["warp_gap"] < 1e-5 and readings["angles_gap"] < 1e-5, readings
    torch.testing.assert_close(ours["angles"], theirs["angles"], rtol=1e-5, atol=1e-8)


def test_the_float64_attention_gradient_follows_autograd_of_the_repositorys_attention():
    g = torch.Generator().manual_seed(3)
    seam = {"samples": 3.0 * torch.rand((6, 5, 3), generator=g) - 1.0,
            "goal": torch.rand((40, 3), generator=g),
            "warps": 0.05 * torch.randn((40, 3), generator=g)}
    seam["samples"][0, 0] = seam["goal"][0] + torch.tensor([0.4, 0.0, 0.0])     # on an edge
    cot = bench_ref.cotangent(seam, 0.4, SEED)
    kept = (cot != 0).any(-1)
    assert 0 < int(kept.sum()) < kept.numel()      # the floor drops some samples
    d = torch.cdist(seam["samples"].double().reshape(-1, 3), seam["goal"].double())
    edge = ((d - 0.4).abs() < bench_ref.EDGE).any(-1)
    assert edge[0] and not kept[0, 0]
    assert torch.equal(kept.reshape(-1), (torch.relu(0.4 - d).sum(-1) >= bench_ref.SUM_FLOOR)
                       & ~edge)
    leaf = seam["goal"].double().requires_grad_(True)
    out = repo_ref.relu_attention_warp(seam["samples"].double(), leaf, seam["warps"].double(),
                                       0.4)
    (out * cot.double()).sum().backward()
    ours = bench_ref.attention_vjp(seam, cot, 0.4, block=4)
    assert float(leaf.grad.norm()) > 0
    torch.testing.assert_close(ours, leaf.grad, rtol=1e-12, atol=1e-14)
    control = bench_ref.attention_vjp(seam, cot, 0.4, "fp8", block=4)
    assert float((control - leaf.grad).norm() / leaf.grad.norm()) > 1e-3


def rehearse(dtype="float32", trace=False, fault=None, control=False, steps_only=True):
    w = harness.resolve(CELL)
    overrides = {"flags": dict(TINY_FLAGS, compute_dtype=dtype), "traffic": TINY_TRAFFIC}
    run = harness.Run(w, SEED, 0.0, trace, torch.device("cpu"), time.perf_counter(),
                      fault=fault, control=control, overrides=overrides, steps_only=steps_only)
    return w, *harness.run_cell(run)


def test_the_plain_path_follows_the_reference_on_the_checked_steps():
    _, outcome, verdict = rehearse()
    r = outcome.readings
    assert max(r.values()) < 1e-5, r
    assert all(c["ok"] for c in verdict.values()), verdict
    assert outcome.notes["posed step"]["largest warp"] > 0
    assert "V=6890, posedirs columns 207, faces 13776" in outcome.notes["body"]
    assert outcome.notes["frozen net unchanged"] and outcome.failed == 0


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_fails_the_committed_limits(fault):
    _, outcome, verdict = rehearse(fault=fault)
    assert not all(c["ok"] for c in verdict.values()), outcome.readings


def test_the_detached_goal_shows_only_at_the_posed_step():
    # from the zero pose every warp of step 1 is 0, so the attention's own
    # gradient into its goal vertices, which the fault removes, is 0 there:
    # goal_vjp_gap, at the last warm-up step, is what holds it
    _, sound, _ = rehearse()
    _, detached, verdict = rehearse(fault="goal_detached")
    for name in ("loss1_gap", "pose_grad_gap"):
        assert detached.readings[name] == sound.readings[name], name
    assert detached.notes["details"]["grads"][0] == sound.notes["details"]["grads"][0]
    assert detached.readings["goal_vjp_gap"] == pytest.approx(1.0)
    assert not verdict["goal_vjp_gap"]["ok"]


def test_the_float8_control_fails_the_committed_limits():
    w, outcome, _ = rehearse(dtype="bfloat16", control=True)
    verdict = checks.judge(outcome.control_readings, w.cell["limits"])
    assert not all(c["ok"] for c in verdict.values()), outcome.control_readings


def test_a_traced_cpu_run_reports_no_device_metric():
    w, outcome, _ = rehearse(dtype="bfloat16", trace=True, steps_only=False)
    assert outcome.attempted == TINY_TRAFFIC["trace_steps"] and outcome.failed == 0
    assert outcome.record is None and harness.per_layer_values(w, outcome) == {}
    assert {"train_rays_per_s", "setup_s"} <= set(outcome.end_to_end)


def reader(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py", f"test_{name}")


def image_wise_record(kernels=True, counters=True):
    s = [("solver.epoch", 0, 1000, None, 0), ("solver.step", 100, 500, 0, 1),
         ("solver.forward", 110, 300, 1, 1), ("pass.lbs", 120, 160, 2, 1),
         ("pass.warp", 170, 250, 2, 1), ("solver.backward", 300, 450, 1, 1),
         ("solver.loss_read", 500, 560, 0, 1)]
    busy = [(60, 130), (150, 260), (310, 390), (420, 700), (800, 900)]
    rec = {"kind": "train", "spans": s, "spans_dropped": 0, "stretch_ns": (50, 950),
           "summary": types.SimpleNamespace(busy_intervals=busy, busy_s=6.0e-7, launches=700),
           "window_s": 9.0e-7, "steps": 2, "flags": {"batchsize": 2048}, "vertices": 6890,
           "launches": {}}
    if kernels:
        rec["kernels"] = {"by_span": {
            "solver.epoch/solver.step/solver.forward/pass.warp": [0.160, 40],
            "solver.epoch/solver.step/solver.backward": [0.300, 900],
            "solver.epoch/solver.step/solver.forward/pass.lbs": [0.01, 300]},
            "unattributed": [0.0, 0]}
    if counters:
        rec["counters"] = {"smpl.lbs_calls": 4, "vertex_attention.relu_calls": 2}
    return rec


def test_the_readers_on_a_hand_made_record():
    rec = image_wise_record()
    assert reader("train.backward_ms_per_step").read(rec) == pytest.approx(150.0)
    assert reader("train.lbs_calls_per_step").read(rec) == pytest.approx(2.0)
    assert reader("train.vertex_attention_ms_per_step").read(rec) == pytest.approx(80.0)
    assert reader("train.launches_per_step").read(rec) == pytest.approx(350.0)
    assert reader("train.device_idle_pct").read(rec) == pytest.approx(100.0 / 3.0)
    # idle under pass.lbs: the gap 130-150, innermost pass.lbs, of a 900 ns stretch
    assert reader("train.idle_in_lbs_pct").read(rec) == pytest.approx(100.0 * 20 / 900)


@pytest.mark.parametrize("name", ["train.backward_ms_per_step", "train.lbs_calls_per_step"])
def test_the_new_readers_find_nothing_where_nothing_was_traced(name):
    r = reader(name)
    assert r.read(None) is None
    assert r.read(image_wise_record(kernels=False, counters=False)) is None
    assert r.read({**image_wise_record(), "kind": "views"}) is None
    assert r.read({**image_wise_record(), "steps": 0}) is None


def test_the_relu_attention_counters_count_from_the_shapes():
    from port_bench.traffic import train_image_wise
    from smpl_nerf_tpu_torch.ops import vertex_attention

    before = train_image_wise.relu_counters()
    vertex_attention.relu_attention_warp(torch.zeros((4, 5, 3)), torch.ones((7, 3)),
                                         torch.zeros((7, 3)), 0.1, chunk_size=3)
    after = train_image_wise.relu_counters()
    assert after["vertex_attention.relu_calls"] - before["vertex_attention.relu_calls"] == 1
    assert after["vertex_attention.relu_pairs"] - before["vertex_attention.relu_pairs"] == 140


# the committed calibration (calibrate.py --out) against the cell's limits
SOUND_MARGIN, MIN_SEEDS, MIN_UPPER = 1.5, 24, 6


def calibration():
    return json.loads((harness.BENCH_DIR / "calibration" / f"{CELL}.json").read_text())["rows"]


def test_every_limit_lies_above_every_sound_reading():
    rows = [r for r in calibration() if r["fault"] is None]
    assert len({r["seed"] for r in rows}) >= MIN_SEEDS
    for name, limit in harness.resolve(CELL).cell["limits"].items():
        assert limit >= SOUND_MARGIN * max(r["readings"][name] for r in rows), name


@pytest.mark.parametrize("fault", FAULTS)
def test_each_planted_fault_fails_a_limit_on_every_seed(fault):
    limits = harness.resolve(CELL).cell["limits"]
    rows = [r["readings"] for r in calibration() if r["fault"] == fault]
    assert len(rows) >= MIN_UPPER
    for readings in rows:
        assert any(readings[n] > limit for n, limit in limits.items()), readings


def test_the_float8_control_fails_the_step_one_limits_on_every_seed():
    limits = harness.resolve(CELL).cell["limits"]
    controls = [r["control"] for r in calibration() if r["control"]]
    assert len(controls) >= MIN_UPPER
    for control in controls:
        assert control["loss1_gap"] > limits["loss1_gap"], control
        assert control["pose_grad_gap"] > limits["pose_grad_gap"], control


def test_the_detached_goal_fails_the_posed_steps_limit_on_every_seed():
    limit = harness.resolve(CELL).cell["limits"]["goal_vjp_gap"]
    detached = [r["readings"] for r in calibration() if r["fault"] == "goal_detached"]
    assert len(detached) >= MIN_UPPER
    assert min(r["goal_vjp_gap"] for r in detached) > limit


def test_every_calibration_reading_is_finite():
    for row in calibration():
        assert np.isfinite(list(row["readings"].values())).all(), row
