"""The smpl_nerf_hashgrid.train cell's own pieces on the CPU: the cell
resolves, the benchmark's reference against the repository's plain one
(hashgrid_reference_torch.py), a tiny rehearsal of the train_hashgrid
traffic (the plain path against the reference, each planted fault and the
controls against the committed limits), the counts and the readers on
hand-made records, and the committed calibration. The rehearsals run at tiny
sizes: the program's `grid_nerf.NGP_SIZES` and the run's `hash_grid` both
patched to TINY_SIZES."""
import json
import time
import types

import numpy as np
import pytest
import torch

import hashgrid_reference_torch as repo_ref
from port_bench import checks, counts_hashgrid, harness, reference, scene
from port_bench import reference_hashgrid as bench_ref

CELL = "smpl_nerf_hashgrid.train"
SEED = 2 ** 33 + 7
TINY_SIZES = {"n_levels": 4, "log2_hashmap_size": 9, "base_resolution": 4, "max_resolution": 32}
TINY_FLAGS = {"grid_width": 16, "netwidth_warp": 16, "batchsize": 128, "batchsize_val": 256,
              "number_coarse_samples": 8, "number_fine_samples": 16, "use_pallas": 0}
TINY_TRAFFIC = {"train_views": 3, "val_views": 1, "resolution": 16}
FAULTS = ("primes_swapped", "nearest_corner", "finest_dropped", "table_halved")
GRAD_FAULTS = ("finest_grad_dropped", "table_grad_halved", "coarsest_grad_shifted")
LIMITED = {"grad_gap_median", "grad_gap_net", "change_gap_median", "change_gap_net",
           "encode_gap", "coarse_table_grad_gap", "fine_table_grad_gap"}
METRICS = {"train.launches_per_step", "train.device_idle_pct", "train.backward_ms_per_step",
           "train.hash_encoding_ms_per_step", "train.hash_lookups_per_step",
           "train.hashgrid.mfu_pct"}


@pytest.fixture(autouse=True)
def tiny_program(monkeypatch):
    from smpl_nerf_tpu_torch.models import grid_nerf

    monkeypatch.setattr(grid_nerf, "NGP_SIZES", TINY_SIZES)


def tiny_flags(dtype="float32"):
    return dict(harness.resolve(CELL).flags, **TINY_FLAGS, compute_dtype=dtype,
                hash_grid=TINY_SIZES)


def published_flags():
    w = harness.resolve(CELL)
    return dict(w.flags, hash_grid=w.config["hash_grid"])


def test_the_cell_resolves_with_every_file_it_names():
    w = harness.resolve(CELL)
    assert w.chips == 1 and w.traffic["kind"] == "train_hashgrid"
    assert w.config["reduced"] == [] and w.flags["model_type"] == "smpl_nerf"
    f = w.flags
    assert (f["grid_encoding"], f["grid_features"], f["grid_width"], f["lrate"]) == (
        2, 2, 64, 0.01)
    assert w.config["hash_grid"] == {"n_levels": 16, "log2_hashmap_size": 19,
                                     "base_resolution": 16, "max_resolution": 2048}
    # the program's flags parse: the sizes are the program's constants, not flags
    harness.Run(w, SEED, 0.0, False, torch.device("cpu"), 0.0).program_args()
    arm = harness.load_json(harness.BENCH_DIR / "configs" / "smpl_nerf_arm_angles.json")["flags"]
    assert {k: v for k, v in f.items() if k in arm and k != "lrate"} == {
        k: v for k, v in arm.items() if k != "lrate"}
    train = harness.load_json(harness.BENCH_DIR / "traffic" / "train.json")
    assert {k: v for k, v in w.traffic.items() if k not in ("kind", "why")} == {
        k: v for k, v in train.items() if k not in ("kind", "why")}
    assert {m["name"] for m in w.end_to_end} == {"train_rays_per_s", "setup_s"}
    assert {m["name"] for m in w.per_layer} == METRICS
    assert set(w.cell["limits"]) == LIMITED
    assert hasattr(w.generator(), "run")


def test_the_published_sizes():
    from smpl_nerf_tpu_torch.models.grid_nerf import HashGridSpec

    flags = published_flags()
    spec = HashGridSpec.published(features=2, **flags["hash_grid"])
    assert (spec.resolutions, spec.sizes) == (tuple(bench_ref.resolutions(flags)),
                                              tuple(bench_ref.level_sizes(flags)))
    assert bench_ref.resolutions(flags)[-1] == 2048 and sum(bench_ref.level_sizes(flags)) == 6098925
    assert counts_hashgrid.mlp_macs(flags) == 9408 and counts_hashgrid.blend_macs(flags) == 256
    # warp field: 100 inputs (60 of the position, 2 x 20 of the pose) -> 256 -> 3
    assert counts_hashgrid.macs_per_row(flags) == 9408 + 256 + 100 * 256 + 256 * 3
    rows = 2048 * 256
    assert counts_hashgrid.forward_flops(flags, 2048) == 2.0 * rows * (9408 + 256 + 26368)
    assert counts_hashgrid.train_flops(flags, 2048) == 3 * counts_hashgrid.forward_flops(flags,
                                                                                         2048)


def test_the_benchmark_reference_follows_the_repositorys():
    flags = tiny_flags()
    weights = bench_ref.make_weights(flags, SEED, "cpu")
    cfg = repo_ref.Config(coarse_samples=8, fine_samples=16, frequencies_positional=10,
                          frequencies_pose=10, sigma_noise_std=1.0, n_levels=4,
                          log2_hashmap_size=9, base_resolution=4, max_resolution=32)
    views = scene.make_views(SEED, 11, 1, 9.0, {"resolution": 16, "radius": 2.4, "fov_deg": 60.0,
                                                "arm_deg": [0.0, 45.0]},
                             flags["human_joints"], False, "cpu", with_rgb=True)
    g = torch.Generator().manual_seed(1)
    batches = []
    for _ in range(3):
        i = torch.randperm(256, generator=g)[:24]
        batches.append({"origins": views["origins"][0][i], "directions": views["directions"][0][i],
                        "rgb": views["rgb"][0][i], "poses": views["poses"][0].expand(24, 69)})
    ours = bench_ref.train_steps(flags, weights, batches, 5, "float32")
    theirs = repo_ref.train_steps(cfg, weights, batches, torch.Generator().manual_seed(5))
    assert ours["losses"] == pytest.approx(theirs["losses"], rel=1e-6)
    assert ours["points1"].shape == (24 * 8, 3)          # 24 rays of 8 coarse samples
    for name in ("model_coarse", "model_fine"):
        assert bench_ref.table_grad_gap(ours["grad1"], theirs["grads"], flags, name) < 1e-5
    for m, leaves in theirs["grads"].items():
        for k, want in leaves.items():
            assert float(want.norm()) > 0, (m, k)
            torch.testing.assert_close(ours["grad1"][m][k], want, rtol=1e-5, atol=1e-9)
            torch.testing.assert_close(ours["params"][m][k], theirs["params"][m][k])
    x = torch.rand((300, 3), generator=g) * 1.2 - 0.1
    table = weights["model_fine"]["hash_table"]
    torch.testing.assert_close(bench_ref.hash_encode(x, table, flags),
                               repo_ref.hash_encode(x, table, cfg))
    assert bench_ref.encode_gap(x, repo_ref.hash_encode(x, table, cfg), table, flags,
                                block=128) < 1e-7
    control = bench_ref.encode_gap(x, bench_ref.control_encoding(x, table, flags, block=128),
                                   table, flags)
    assert control > 1e-3


def rehearse(dtype="float32", fault=None, control=False, steps_only=True, trace=False,
             sizes=TINY_SIZES):
    w = harness.resolve(CELL)
    run = harness.Run(w, SEED, 0.0, trace, torch.device("cpu"), time.perf_counter(),
                      fault=fault, control=control, steps_only=steps_only,
                      overrides={"flags": dict(TINY_FLAGS, compute_dtype=dtype),
                                 "traffic": TINY_TRAFFIC, "hash_grid": sizes})
    return (w, *harness.run_cell(run))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_plain_path_follows_the_reference_on_the_checked_steps(dtype):
    _, outcome, verdict = rehearse(dtype)
    r = outcome.readings
    assert r["loss1_gap"] < 1e-6 and r["grad_gap_net"] < 1e-6 and r["encode_gap"] < 1e-6, r
    assert r["coarse_table_grad_gap"] < 1e-5 and r["fine_table_grad_gap"] < 1e-5, r
    assert all(c["ok"] for c in verdict.values()), verdict
    assert outcome.failed == 0


def test_a_program_at_other_sizes_is_refused_before_any_work():
    with pytest.raises(RuntimeError, match="hash-grid sizes"):
        rehearse(sizes=dict(TINY_SIZES, n_levels=5))


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_fails_the_committed_limits(fault):
    _, outcome, verdict = rehearse("bfloat16", fault=fault)
    assert not verdict["encode_gap"]["ok"], outcome.readings


@pytest.mark.parametrize("fault", GRAD_FAULTS)
def test_a_planted_backward_fault_fails_the_table_gradient_limit(fault):
    """The forward is the sound one: only the tables' own gradients see it."""
    _, outcome, verdict = rehearse("bfloat16", fault=fault)
    assert verdict["encode_gap"]["ok"], outcome.readings
    assert not verdict["coarse_table_grad_gap"]["ok"], outcome.readings
    assert not verdict["fine_table_grad_gap"]["ok"], outcome.readings


def test_the_controls_fail_the_committed_limits():
    w, outcome, _ = rehearse("bfloat16", control=True)
    verdict = checks.judge(outcome.control_readings, w.cell["limits"])
    assert not all(c["ok"] for c in verdict.values()), outcome.control_readings
    assert not verdict["encode_gap"]["ok"], outcome.control_readings


def test_a_traced_cpu_run_reports_no_device_metric():
    w, outcome, _ = rehearse("bfloat16", trace=True, steps_only=False)
    assert outcome.attempted > 0 and outcome.failed == 0
    assert outcome.record is None and harness.per_layer_values(w, outcome) == {}
    assert {"train_rays_per_s", "setup_s"} <= set(outcome.end_to_end)


def test_the_encoding_counters_count_from_the_shapes():
    from port_bench.traffic import train_hashgrid
    from smpl_nerf_tpu_torch.models.grid_nerf import HashGridNerf, HashGridSpec

    before = train_hashgrid.counters()
    net = HashGridNerf(HashGridSpec.published(4, 2, 9, 4, 32), width=16)
    net(torch.zeros((10, 6)))
    after = train_hashgrid.counters()
    assert after["grid.encode_calls"] - before["grid.encode_calls"] == 1
    assert after["grid.lookups"] - before["grid.lookups"] == 10 * 4 * 8


def reader(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py", f"test_{name}")


def hashgrid_record(kernels=True, counters=True):
    flags = published_flags()
    rec = {"kind": "train", "flags": flags, "steps": 192, "batch": 2048, "window_s": 4.0,
           "eval_rays": 16384, "eval_batches": 32, "eval_padded_rays": 16384, "launches": {},
           "summary": types.SimpleNamespace(busy_s=3.0, launches=192 * 400)}
    if kernels:
        rec["kernels"] = {"by_span": {
            "solver.epoch/solver.step/solver.forward/pass.coarse/pass.net/pass.encode": [0.5, 40],
            "solver.epoch/solver.step/solver.forward/pass.fine/pass.net/pass.encode": [1.42, 40],
            "solver.epoch/solver.validate/pass.fine/pass.net/pass.encode": [0.2, 40],
            "solver.epoch/solver.step/solver.backward": [1.0, 900]},
            "unattributed": [0.0, 0]}
    if counters:
        rec["counters"] = {"grid.encode_calls": 448, "grid.lookups": 192 * 67108864 + 536870912}
    return rec


def test_the_readers_on_a_hand_made_record():
    rec = hashgrid_record()
    assert reader("train.hash_encoding_ms_per_step").read(rec) == pytest.approx(10.0)
    assert reader("train.hash_lookups_per_step").read(rec) == pytest.approx(
        67108864 + 536870912 / 192)
    flops = (counts_hashgrid.train_flops(rec["flags"], 192 * 2048)
             + counts_hashgrid.forward_flops(rec["flags"], 16384))
    assert reader("train.hashgrid.mfu_pct").read(rec) == pytest.approx(
        100 * flops / 4.0 / 989e12)
    assert reader("train.backward_ms_per_step").read(rec) == pytest.approx(1000.0 / 192)
    assert reader("train.launches_per_step").read(rec) == pytest.approx(400.0)
    assert reader("train.device_idle_pct").read(rec) == pytest.approx(25.0)


@pytest.mark.parametrize("name", ["train.hash_encoding_ms_per_step",
                                  "train.hash_lookups_per_step", "train.hashgrid.mfu_pct"])
def test_the_new_readers_find_nothing_where_nothing_was_traced(name):
    r = reader(name)
    assert r.read(None) is None
    assert r.read({**hashgrid_record(), "kind": "views"}) is None
    if name != "train.hashgrid.mfu_pct":
        assert r.read(hashgrid_record(kernels=False, counters=False)) is None
        assert r.read({**hashgrid_record(), "steps": 0}) is None
    else:       # a configuration without hash-grid fields, or a record without its sizes
        rec = hashgrid_record()
        assert r.read({**rec, "flags": {**rec["flags"], "grid_encoding": 0}}) is None
        assert r.read({**rec, "flags": harness.resolve(CELL).flags}) is None


# the committed calibration (calibrate.py --out) against the cell's limits
SOUND_MARGIN, MIN_SEEDS, MIN_UPPER = 1.5, 24, 6


def calibration():
    return json.loads((harness.BENCH_DIR / "calibration" / f"{CELL}.json").read_text())["rows"]


def test_every_limit_lies_above_every_sound_reading():
    rows = [r for r in calibration() if r["fault"] is None]
    assert len({r["seed"] for r in rows}) >= MIN_SEEDS
    assert len(rows) > len({r["seed"] for r in rows})          # reruns of a seed too
    for name, limit in harness.resolve(CELL).cell["limits"].items():
        assert limit >= SOUND_MARGIN * max(r["readings"][name] for r in rows), name


@pytest.mark.parametrize("fault", FAULTS + GRAD_FAULTS)
def test_each_planted_fault_fails_a_limit_on_every_seed(fault):
    limits = harness.resolve(CELL).cell["limits"]
    rows = [r["readings"] for r in calibration() if r["fault"] == fault]
    assert len(rows) >= MIN_UPPER
    for readings in rows:
        assert any(readings[n] > limit for n, limit in limits.items()), readings


def test_the_float8_control_fails_a_limit_on_every_seed():
    limits = harness.resolve(CELL).cell["limits"]
    controls = [r["control"] for r in calibration() if r["control"]]
    assert len(controls) >= MIN_UPPER
    for control in controls:
        assert any(control[n] > limit for n, limit in limits.items() if n != "encode_gap"), \
            control


def test_every_calibration_reading_is_finite():
    for row in calibration():
        assert np.isfinite(list(row["readings"].values())).all(), row


def test_the_reference_copy_imports_nothing_of_the_program():
    import ast

    for path in (harness.BENCH_DIR / "reference_hashgrid.py", harness.CHECKOUT / "hashgrid_reference_torch.py"):
        tree = ast.parse(path.read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert not names & {"smpl_nerf_tpu_torch", "smpl_nerf_tpu", "jax", "flax"}, path
    assert reference.stated_precision(harness.resolve(CELL).flags) == "bfloat16"


def test_a_backward_fault_leaves_the_forward_and_alters_the_table_gradient_alone():
    from port_bench.traffic import train_hashgrid
    from smpl_nerf_tpu_torch.models import grid_nerf
    from smpl_nerf_tpu_torch.models.grid_nerf import HashGridSpec

    spec = HashGridSpec.published(features=2, **TINY_SIZES)
    g = torch.Generator().manual_seed(4)
    x = torch.rand((200, 3), generator=g)
    cot = torch.randn((200, 8), generator=g)
    table = torch.randn((spec.entries, 2), generator=g)
    grads = {}
    for fault in (None,) + GRAD_FAULTS:
        t = table.clone().requires_grad_(True)
        fn = train_hashgrid.planted(fault, grid_nerf.hash_grid_encode) if fault else \
            grid_nerf.hash_grid_encode
        out = fn(x, t, spec)
        (out * cot).sum().backward()
        assert torch.equal(out, grid_nerf.hash_grid_encode(x, table, spec)), fault
        grads[fault] = t.grad
    lo, hi = spec.offsets[-1], spec.entries
    sound = grads[None]
    assert torch.equal(grads["finest_grad_dropped"][:lo], sound[:lo])
    assert not grads["finest_grad_dropped"][lo:hi].any() and sound[lo:hi].any()
    torch.testing.assert_close(grads["table_grad_halved"], 0.5 * sound)
    n0 = spec.sizes[0]
    assert torch.equal(grads["coarsest_grad_shifted"][:n0], torch.roll(sound[:n0], 1, 0))
    assert torch.equal(grads["coarsest_grad_shifted"][n0:], sound[n0:])
