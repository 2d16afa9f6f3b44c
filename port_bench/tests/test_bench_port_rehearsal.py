"""CPU rehearsals of each traffic kind at a tiny size: the whole run as the
card runs it, with the plain PyTorch versions of the kernels.

* in float32 the program's plain path and the reference agree on the
  checked steps and views (the same weights, rows and draws);
* a run on the CPU reports no device metric;
* each planted fault (a step that leaves the state unchanged, half of each
  batch left out, an answer altered where it is produced; in smpl_nerf the
  warp field left out of the optimizer, and the nets' gradient to their
  input rows zeroed, as kernel C with its dX zeroed) and the float8 control
  fail the cell's limits.
"""
import time

import pytest
import torch

from port_bench import checks, harness

TINY_FLAGS = {"netdepth": 3, "netwidth": 32, "netdepth_fine": 3, "netwidth_fine": 32,
              "netwidth_warp": 16, "skips": [1], "skips_fine": [1], "batchsize": 256,
              "batchsize_val": 128, "number_coarse_samples": 8, "number_fine_samples": 8}
TINY_TRAFFIC = {"train_views": 2, "val_views": 1, "resolution": 32, "pool_views": 4,
                "warmup_views": 1, "trace_views": 3, "label_views": 1, "sample_views": 3, "batch_rays": 64}
TRAIN = ["smpl_nerf.train", "append_smpl_params.train"]
VIEWS = ["smpl_nerf.views128", "append_smpl_params.views128"]


def rehearse(cell, dtype="float32", trace=False, fault=None, control=False, seed=2 ** 33 + 5):
    w = harness.resolve(cell)
    overrides = {"flags": dict(TINY_FLAGS, compute_dtype=dtype), "traffic": TINY_TRAFFIC}
    run = harness.Run(w, seed, 0.0, trace, torch.device("cpu"), time.perf_counter(),
                      fault=fault, control=control, overrides=overrides)
    outcome, verdict = harness.run_cell(run)
    return w, outcome, verdict


@pytest.mark.parametrize("cell", TRAIN)
def test_reference_follows_the_plain_path_on_the_checked_steps(cell):
    _, outcome, verdict = rehearse(cell)
    assert outcome.readings["loss_gap"] < 1e-4
    assert outcome.readings["grad_gap"] < 1e-5
    assert outcome.readings["change_gap"] < 1e-3
    assert all(c["ok"] for c in verdict.values())


@pytest.mark.parametrize("cell", VIEWS)
def test_reference_renders_the_plain_path_views(cell):
    _, outcome, verdict = rehearse(cell)
    assert outcome.readings["view_gap"] < 1e-5
    assert all(c["ok"] for c in verdict.values())


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", TRAIN + VIEWS)
def test_cpu_rehearsal_runs_and_reports_no_device_metric(cell, trace):
    w, outcome, _ = rehearse(cell, "bfloat16", trace=trace)
    assert outcome.attempted > 0 and outcome.failed == 0
    assert outcome.record is None and outcome.summary is None
    assert outcome.memory_peak_bytes == 0
    assert harness.per_layer_values(w, outcome) == {}
    assert "setup_s" in outcome.end_to_end


@pytest.mark.parametrize("cell,fault", [(c, f) for c in TRAIN
                                        for f in ("unchanged", "half_batch", "altered")]
                         + [("smpl_nerf.train", f) for f in ("warp_unstepped", "dx_zeroed")]
                         + [(c, f) for c in VIEWS for f in ("half_batch", "altered")])
def test_a_planted_fault_fails_the_limits(cell, fault):
    _, outcome, verdict = rehearse(cell, fault=fault)
    assert not all(c["ok"] for c in verdict.values()), outcome.readings


@pytest.mark.parametrize("cell", TRAIN + VIEWS)
def test_the_float8_control_fails_the_limits(cell):
    w, outcome, _ = rehearse(cell, control=True)
    verdict = checks.judge(outcome.control_readings, w.cell["limits"])
    assert not all(c["ok"] for c in verdict.values()), outcome.control_readings
