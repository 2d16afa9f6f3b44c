"""The span readers (port_bench/spans.py and the metrics that read it) on
hand-made records: spans and busy intervals with known idle splits, the
other kind of record, a record without spans (a program without the
recorder) and one whose recorder dropped spans."""
import types

import pytest

from port_bench import harness, spans

SPAN_READERS = ("train.host_step_ms", "train.idle_in_forward_pct",
                "train.idle_in_backward_optimizer_pct", "train.idle_unnamed_pct",
                "views.host_batch_ms", "views.idle_in_batch_pct", "views.idle_unnamed_pct")


def reader(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py", f"test_{name}")


def train_record():
    # name, start, end, parent, request (ns)
    s = [("solver.epoch", 0, 1000, None, 0), ("solver.step", 100, 500, 0, 0),
         ("solver.forward", 110, 300, 1, 0), ("pass.coarse", 120, 250, 2, 0),
         ("solver.backward", 300, 400, 1, 0), ("solver.optimizer", 400, 490, 1, 0),
         ("solver.loss_read", 500, 600, 0, 0)]
    busy = [(60, 130), (140, 260), (310, 390), (420, 700), (800, 900)]
    return {"kind": "train", "spans": s, "spans_dropped": 0, "stretch_ns": (50, 950),
            "summary": types.SimpleNamespace(busy_intervals=busy), "rows": None,
            "launches": {}}


def views_record():
    s = [("render.view", 0, 1000, None, 7), ("render.upload", 10, 50, 0, 7),
         ("render.batch", 60, 400, 0, 7), ("pass.coarse", 70, 200, 2, 7),
         ("render.batch", 400, 800, 0, 7), ("render.readback", 900, 990, 0, 7)]
    busy = [(20, 40), (100, 150), (300, 700)]
    return {"kind": "views", "spans": s, "spans_dropped": 0, "stretch_ns": (0, 1000),
            "summary": types.SimpleNamespace(busy_intervals=busy),
            "rows": {"fused_mlp_v2_fwd": 4096}, "launches": {"fused_mlp_v2_fwd": 2}}


def test_idle_gaps_split_by_the_innermost_open_span():
    rec = train_record()
    gaps = spans.idle_gaps(rec["summary"].busy_intervals, rec["spans"], 50, 950)
    named = [(ns, rec["spans"][i][0]) for ns, i in gaps]
    assert named == [(10, "solver.epoch"), (10, "pass.coarse"), (50, "solver.forward"),
                     (30, "solver.optimizer"), (100, "solver.epoch"), (50, "solver.epoch")]
    assert spans.names_from(rec["spans"], 3) == ["pass.coarse", "solver.forward",
                                                 "solver.step", "solver.epoch"]
    assert spans.innermost(rec["spans"], [s[1] for s in rec["spans"]], -5) is None


def test_an_open_span_and_a_gap_outside_every_span():
    s = [("a", 15, None, None, None)]
    assert spans.idle_gaps([(20, 30)], s, 0, 40) == [(20, None), (10, 0)]


@pytest.mark.parametrize("name,value", [
    ("train.host_step_ms", 400e-6),
    ("train.idle_in_forward_pct", 100.0 * 60 / 900),
    ("train.idle_in_backward_optimizer_pct", 100.0 * 30 / 900),
    ("train.idle_unnamed_pct", 100.0 * 160 / 250),
    ("views.host_batch_ms", 370e-6),
    ("views.idle_in_batch_pct", 100.0 * 210 / 1000),
    ("views.idle_unnamed_pct", 100.0 * 300 / 530),
    ("views.fused_mlp_v2_fwd.rows_per_launch", 2048.0),
])
def test_each_reader_on_its_record(name, value):
    rec = train_record() if name.startswith("train") else views_record()
    assert reader(name).read(rec) == pytest.approx(value)
    other = views_record() if name.startswith("train") else train_record()
    assert reader(name).read(other) is None


@pytest.mark.parametrize("name,fault", [(n, f) for n in SPAN_READERS
                                        for f in ("no_spans", "dropped", "no_busy", "none")]
                         + [("setup.kernel_load_s", f) for f in ("no_spans", "dropped", "none")])
def test_a_reader_finds_nothing_to_read(name, fault):
    rec = train_record() if name.startswith(("train", "setup")) else views_record()
    if fault == "no_spans":        # a program without the recorder
        for key in ("spans", "spans_dropped", "stretch_ns", "rows"):
            del rec[key]
    elif fault == "dropped":
        rec["spans_dropped"] = 3
    elif fault == "no_busy":       # a trace.reduce without the busy intervals
        rec["summary"] = types.SimpleNamespace()
    else:
        rec = None
    assert reader(name).read(rec) is None


@pytest.mark.parametrize("launches,rows", [(0, {"fused_mlp_v2_fwd": 4096}), (2, None), (2, {})])
def test_rows_per_launch_needs_launches_and_rows(launches, rows):
    rec = views_record()
    rec["launches"] = {"fused_mlp_v2_fwd": launches}
    rec["rows"] = rows            # {}: a program without the rows counter
    assert reader("views.fused_mlp_v2_fwd.rows_per_launch").read(rec) is None


def test_kernel_load_is_the_union_of_the_loads_before_the_stretch():
    rec = train_record()
    rec["spans"] = [("ops.load", 0, 100, None, None), ("ops.load", 50, 150, None, None),
                    ("solver.epoch", 200, 1000, None, 0), ("ops.load", 300, 400, 2, 0)]
    rec["stretch_ns"] = (350, 950)
    assert reader("setup.kernel_load_s").read(rec) == pytest.approx(150e-9)
    assert spans.union_s([(0, 10), (20, 30), (25, 40), (5, 8)]) == pytest.approx(30e-9)


@pytest.mark.parametrize("enabled", [True, False])
def test_capture_records_the_program_spans_of_the_stretch(enabled):
    from smpl_nerf_tpu_torch import tracing

    capture = spans.Capture(enabled, 16)
    try:
        capture.start()
        with tracing.span("solver.step", 4):
            pass
        capture.stop()
        rec = capture.record()
    finally:
        tracing.disable()
    if not enabled:
        assert rec == {}
        return
    (name, start, end, parent, request), = rec["spans"]
    lo, hi = rec["stretch_ns"]
    assert (name, parent, request) == ("solver.step", None, 4)
    assert lo <= start <= end <= hi and rec["spans_dropped"] == 0
    assert rec["rows"] == {k: 0 for k in spans.row_counts()}
    assert not tracing.enabled()
