"""The committed calibration readings against the limit they set.

port_bench/calibration/ holds calibrate.py's --out files of
append_smpl_params.views128, one per path the program has for the
configuration's precision (bf16 operands, float32 accumulation):
`use_fused_mlp_0` the plain layers, `_1` kernel D, `_2` kernel B on prefix
rows; the plain path's file also holds the float8 control and the planted
faults. The cell's `view_gap` limit must lie 1.5x above every sound reading
of every path and 2x below every control and fault reading.
"""
import json

import pytest

from port_bench import harness

CELL = "append_smpl_params.views128"
MODES = (0, 1, 2)
SOUND_MARGIN = 1.5
UPPER_MARGIN = 2.0
MIN_SEEDS, MIN_UPPER = 24, 6


def rows(mode: int) -> list:
    path = harness.BENCH_DIR / "calibration" / f"{CELL}.use_fused_mlp_{mode}.json"
    return json.loads(path.read_text())["rows"]


def limit() -> float:
    return harness.resolve(CELL).cell["limits"]["view_gap"]


def sound_seeds(mode: int) -> set:
    return {r["seed"] for r in rows(mode) if r["fault"] is None}


@pytest.mark.parametrize("mode", MODES)
def test_the_limit_lies_above_every_sound_reading(mode):
    sound = [r["readings"]["view_gap"] for r in rows(mode) if r["fault"] is None]
    assert len(sound) >= MIN_SEEDS and sound_seeds(mode) == sound_seeds(0)
    assert limit() >= SOUND_MARGIN * max(sound), max(sound)


@pytest.mark.parametrize("kind", ["control", "altered", "half_batch"])
def test_the_limit_lies_below_every_control_and_fault_reading(kind):
    if kind == "control":
        upper = [r["control"]["view_gap"] for r in rows(0) if r["control"]]
    else:
        upper = [r["readings"]["view_gap"] for r in rows(0) if r["fault"] == kind]
    assert len(upper) >= MIN_UPPER
    assert UPPER_MARGIN * limit() <= min(upper), min(upper)
