"""The dummy_dynamic cell's own pieces on the CPU: the seeded body in SMPL's
pkl format, the benchmark's reference against the repository's plain one,
a tiny rehearsal of the train_dynamic traffic (the plain path against the
reference, each planted fault against the committed limits), the three new
readers on hand-made records, and the attention's bound count."""
import time
import types

import numpy as np
import pytest
import torch

import dummy_dynamic_reference_torch as repo_ref
from port_bench import body as body_mod
from port_bench import checks, counts_dynamic, harness
from port_bench import reference_dummy_dynamic as bench_ref

CELL = "dummy_dynamic.train"
SEED = 2 ** 33 + 5
TINY_FLAGS = {"netdepth": 3, "netwidth": 32, "netdepth_fine": 3, "netwidth_fine": 32,
              "skips": [1], "skips_fine": [1], "batchsize": 256, "batchsize_val": 128,
              "number_coarse_samples": 8, "images_per_batch": 2}
TINY_TRAFFIC = {"train_views": 3, "val_views": 1, "resolution": 32}


@pytest.fixture(scope="module")
def body():
    return body_mod.make_body(SEED)


def test_the_body_has_smpls_sizes_and_loads_through_the_program(body, tmp_path):
    from smpl_nerf_tpu_torch.models import smpl

    assert body["v_template"].shape == (6890, 3) and body["f"].shape == (13776, 3)
    assert body["shapedirs"].shape == (6890, 3, 10) and body["posedirs"].shape == (6890, 3, 207)
    assert body["J_regressor"].shape == (24, 6890) and body["weights"].shape == (6890, 24)
    assert body["f"].max() == 6889 and np.allclose(body["weights"].sum(1), 1.0)
    path, again = body_mod.write_body(SEED, tmp_path)
    assert np.array_equal(again["posedirs"], body["posedirs"])        # seeded
    model = smpl.load_smpl_pkl(str(path))
    arrays = body_mod.arrays(body)
    assert np.array_equal(model.v_template, arrays["v_template"])
    assert np.array_equal(model.posedirs, arrays["posedirs"])
    assert np.array_equal(model.joint_regressor, arrays["J_regressor"])
    assert np.array_equal(model.lbs_weights, arrays["weights"])
    assert np.array_equal(model.faces, body["f"].astype(np.int32))
    other = body_mod.make_body(SEED + 1)
    assert not np.array_equal(other["v_template"], body["v_template"])


def test_the_benchmark_reference_follows_the_repositorys(body):
    g = torch.Generator().manual_seed(3)
    poses = torch.zeros((3, 69))
    poses[:, 38] = poses[:, 41] = torch.tensor([0.0, 0.4, 0.8])
    arrays = bench_ref.body_tensors(body_mod.arrays(body), "cpu")
    betas = torch.zeros(10)
    ours = bench_ref.lbs(arrays, betas, poses)
    theirs = repo_ref.lbs(body, betas, poses)
    assert float((ours - theirs).abs().max()) < 1e-6
    R, S = 16, 8
    samples = 0.3 * torch.randn((R, S, 3), generator=g) + torch.tensor([0.3, 0.2, 0.0])
    image = torch.randint(0, 3, (R,), generator=g)
    goal = ours[image]
    warps = ours[:1] - goal
    a = bench_ref.attention_warp(samples, goal, warps, 0.15, 1e4, block=5)
    b = repo_ref.attention_warp(samples, goal, warps, 0.15, 1e4)
    assert float(torch.linalg.norm(b)) > 0
    assert bench_ref.warp_gap(a, b) < 1e-5


def rehearse(dtype="float32", trace=False, fault=None, control=False):
    w = harness.resolve(CELL)
    overrides = {"flags": dict(TINY_FLAGS, compute_dtype=dtype), "traffic": TINY_TRAFFIC}
    run = harness.Run(w, SEED, 0.0, trace, torch.device("cpu"), time.perf_counter(),
                      fault=fault, control=control, overrides=overrides, steps_only=True)
    return w, *harness.run_cell(run)


def test_the_plain_path_follows_the_reference_on_the_checked_steps():
    _, outcome, verdict = rehearse()
    r = outcome.readings
    assert r["loss_gap"] < 1e-5 and r["grad_gap"] < 1e-4 and r["warp_gap"] < 1e-5, r
    assert all(c["ok"] for c in verdict.values()), verdict
    assert "V=6890, posedirs columns 207, faces 13776" in outcome.notes["body"]


@pytest.mark.parametrize("fault", ["warp_skipped", "vertices_halved", "row_max"])
def test_a_planted_fault_fails_the_committed_limits(fault):
    _, outcome, verdict = rehearse(fault=fault)
    assert not verdict["warp_gap"]["ok"], outcome.readings


def test_the_float8_control_fails_the_committed_limits():
    w, outcome, _ = rehearse(control=True)
    verdict = checks.judge(outcome.control_readings, w.cell["limits"])
    assert not all(c["ok"] for c in verdict.values()), outcome.control_readings


def test_a_traced_cpu_run_reports_no_device_metric():
    w = harness.resolve(CELL)
    overrides = {"flags": dict(TINY_FLAGS, compute_dtype="bfloat16"), "traffic": TINY_TRAFFIC}
    run = harness.Run(w, SEED, 0.0, True, torch.device("cpu"), time.perf_counter(),
                      overrides=overrides)
    outcome, _ = harness.run_cell(run)
    assert outcome.attempted > 0 and outcome.failed == 0 and outcome.record is None
    assert harness.per_layer_values(w, outcome) == {}
    assert {"train_rays_per_s", "setup_s"} <= set(outcome.end_to_end)


def reader(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py", f"test_{name}")


def dynamic_record(kernels=True):
    s = [("solver.epoch", 0, 1000, None, 0), ("solver.step", 100, 500, 0, 0),
         ("solver.forward", 110, 300, 1, 0), ("pass.lbs", 120, 160, 2, 0),
         ("pass.coarse", 160, 290, 2, 0), ("pass.warp", 170, 250, 4, 0),
         ("solver.validate", 600, 900, 0, 0), ("pass.warp", 620, 700, 6, 0)]
    busy = [(60, 130), (150, 260), (310, 390), (420, 700), (800, 900)]
    flags = {"batchsize": 2048, "number_coarse_samples": 64}
    rec = {"kind": "train", "spans": s, "spans_dropped": 0, "stretch_ns": (50, 950),
           "summary": types.SimpleNamespace(busy_intervals=busy), "steps": 2, "flags": flags,
           "vertices": 6890, "launches": {}}
    if kernels:
        rec["kernels"] = {"by_span": {
            "solver.epoch/solver.step/solver.forward/pass.coarse/pass.warp": [0.160, 40],
            "solver.epoch/solver.validate/pass.warp": [0.3, 10],
            "solver.epoch/solver.step/solver.forward/pass.lbs": [0.01, 300]},
            "unattributed": [0.0, 0]}
    return rec


def test_the_new_readers_on_a_hand_made_record():
    rec = dynamic_record()
    assert reader("train.vertex_attention_ms_per_step").read(rec) == pytest.approx(80.0)
    bound = counts_dynamic.attention_bound_s(2048 * 64 * 6890)
    assert reader("train.vertex_attention.roofline_pct").read(rec) == pytest.approx(
        100.0 * bound / 0.080)
    # idle under pass.lbs: the gap 130-150, innermost pass.lbs, of a 900 ns stretch
    assert reader("train.idle_in_lbs_pct").read(rec) == pytest.approx(100.0 * 20 / 900)


@pytest.mark.parametrize("name", ["train.vertex_attention_ms_per_step",
                                  "train.vertex_attention.roofline_pct",
                                  "train.idle_in_lbs_pct"])
def test_the_new_readers_find_nothing_where_nothing_was_traced(name):
    r = reader(name)
    assert r.read(None) is None
    rec = dynamic_record(kernels=False)
    del rec["spans"]
    assert r.read(rec) is None
    assert r.read({**dynamic_record(), "kind": "views"}) is None


def test_the_attention_bound_count():
    pairs = counts_dynamic.pairs_per_step({"batchsize": 2048, "number_coarse_samples": 64}, 6890)
    assert pairs == 903_086_080
    sfu = pairs * 2 / (132 * 16 * 1.98e9)
    fp32 = pairs * 15 / (132 * 128 * 1.98e9)
    assert counts_dynamic.attention_bound_s(pairs) == pytest.approx(max(sfu, fp32))
    assert 0.4e-3 < counts_dynamic.attention_bound_s(pairs) < 0.5e-3


def test_the_attribution_of_device_operations_to_spans():
    from port_bench.traffic import train_dynamic

    s = [("solver.step", 0, 100, None, 0), ("pass.warp", 10, 50, 0, 0)]
    ops = [(200, 260, (7, 0)), (300, 310, (8, 0)), (400, 405, (9, 0))]
    out = train_dynamic.attribute(ops, {7: 20, 8: 70}, s)
    assert out["by_span"]["solver.step/pass.warp"] == [pytest.approx(60e-9), 1]
    assert out["by_span"]["solver.step"] == [pytest.approx(10e-9), 1]
    assert out["unattributed"] == [pytest.approx(5e-9), 1]
    assert train_dynamic.merged(ops + [(250, 280, (0, 0))]) == [(200, 280), (300, 310),
                                                                (400, 405)]


# the committed calibration (calibrate.py --out) against the cell's limits
SOUND_MARGIN, UPPER_MARGIN, MIN_SEEDS, MIN_UPPER = 1.5, 2.0, 24, 6


def calibration(cell):
    import json

    return json.loads((harness.BENCH_DIR / "calibration" / f"{cell}.json").read_text())["rows"]


def test_every_limit_lies_above_every_sound_reading():
    rows = [r for r in calibration(CELL) if r["fault"] is None]
    assert len({r["seed"] for r in rows}) >= MIN_SEEDS
    for name, limit in harness.resolve(CELL).cell["limits"].items():
        assert limit >= SOUND_MARGIN * max(r["readings"][name] for r in rows), name


def test_the_attention_faults_read_above_the_warp_limit():
    limit = harness.resolve(CELL).cell["limits"]["warp_gap"]
    for fault in ("warp_skipped", "vertices_halved", "row_max"):
        upper = [r["readings"]["warp_gap"] for r in calibration(CELL) if r["fault"] == fault]
        assert len(upper) >= MIN_UPPER and min(upper) >= UPPER_MARGIN * limit, fault


def test_the_float8_control_fails_a_limit_on_every_seed_but_not_each():
    limits = harness.resolve(CELL).cell["limits"]
    controls = [r["control"] for r in calibration(CELL) if r["control"]]
    assert len(controls) >= MIN_UPPER
    for control in controls:
        failed = {n for n, limit in limits.items() if control[n] > UPPER_MARGIN * limit}
        assert failed and failed != set(limits), control


def test_counts_take_the_family_as_coarse_only():
    from port_bench import counts

    flags = harness.resolve(CELL).flags
    assert counts.samples_per_ray(flags) == {"coarse": 64, "fine": 0}
    assert counts.macs_per_sample(flags)["warp"] == 0
    assert counts.train_flops(flags, 2048) == pytest.approx(
        6.0 * 2048 * 64 * counts.macs_per_sample(flags)["coarse"])
