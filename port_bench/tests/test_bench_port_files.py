"""BENCHMARK.json and the files it names: the file's shape, each name's
file, and that a new cell is found with no edit to the harness."""
import json
import re
import shutil

import pytest

from port_bench import harness

ROOT = harness.CHECKOUT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH_KEYS = re.compile(r"(hidden|intermediate|latent|state|projection|width|_dim$|_rank$|head)")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_text_fields():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry and group != "end_to_end" and group != "per_layer":
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
            if "unit" in entry:
                assert UNIT.match(entry["unit"])
                assert entry["better"] in ("lower", "higher")
    assert len(set(n for _, n in names)) == len(names)
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])


def test_every_name_has_its_file():
    bench_dir = ROOT / "port_bench"
    files = set()
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/") and (ROOT / c["file"]).is_file()
        files.add(c["file"])
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH_KEYS.search(key)
    assert len(files) == len(BENCH["configs"])
    for w in BENCH["workloads"]:
        assert (bench_dir / "cells" / f"{w['name']}.json").is_file()
        traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
        assert (bench_dir / "traffic" / f"{traffic['kind']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert (bench_dir / "metrics" / f"{m['name']}.py").is_file()


def test_every_cell_reports_what_it_must():
    pairs = set()
    for w in BENCH["workloads"]:
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        wl = harness.resolve(w["name"])
        e2e = {m["name"] for m in wl.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert wl.per_layer
        for m in wl.per_layer:
            assert m["moves"] in e2e
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("config", [c["file"] for c in BENCH["configs"]])
def test_configuration_flags_parse(config):
    from smpl_nerf_tpu_torch import config as config_mod

    flags = json.loads((ROOT / config).read_text())["flags"]
    args = config_mod.config_parser().parse_args(harness.flag_argv(flags))
    for key, value in flags.items():
        assert getattr(args, key) == value, key


def test_a_new_cell_needs_no_edit_to_the_harness(tmp_path):
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(
        {"name": "smpl_nerf.views64", "config": "smpl_nerf_arm_angles", "traffic": "views64",
         "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "smpl_nerf.views128" in m.get("workloads", []):
            m["workloads"].append("smpl_nerf.views64")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    views = json.loads((ROOT / "port_bench" / "traffic" / "views128.json").read_text())
    views["resolution"] = 64
    (tmp_path / "port_bench" / "traffic" / "views64.json").write_text(json.dumps(views))
    (tmp_path / "port_bench" / "cells" / "smpl_nerf.views64.json").write_text(
        json.dumps({"centre_density": True, "limits": {"view_gap": 0.01}}))
    w = harness.resolve("smpl_nerf.views64", root=tmp_path)
    assert w.traffic["resolution"] == 64 and w.traffic["kind"] == "views"
    assert w.flags["model_type"] == "smpl_nerf"
    assert {m["name"] for m in w.end_to_end} == {"view_ms", "view_ms_p95", "setup_s"}
    assert {m["name"] for m in w.per_layer} == {
        m["name"] for m in BENCH["per_layer"] if "smpl_nerf.views128" in m["workloads"]}
    assert w.cell["limits"] == {"view_gap": 0.01}
    assert w.generator().run is not None
