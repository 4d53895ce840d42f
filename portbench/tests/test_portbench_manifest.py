"""BENCHMARK.json against the benchmark's contract, and the files the
harness finds by name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert MAN["paths"] == ["portbench"] and 1 <= MAN["run_seconds"] <= 51
    assert len(MAN["command"]) <= 32 and all(not w.startswith("/") and ".." not in w
                                             for w in MAN["command"])


def test_check_budget_fits_the_full_twenty_four_cells():
    cells = 24
    total = (2 + 14 * cells) * (MAN["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_names_are_unique():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_every_config_has_a_cell_and_its_files():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["reduced"] == cfg["reduced"]
        assert (BENCH / "work_counts" / f"{cfg['work']}.py").is_file()
        assert (BENCH / "reference" / f"{cfg['reference']}.py").is_file()
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4)
        assert (BENCH / "mixes" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()


def test_bounds():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_its_reader(m):
    assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_an_end_to_end_metric_of_each_of_its_cells(m):
    e2e = {e["name"]: e for e in MAN["end_to_end"]}
    assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                 "program_counter", "host_clock")
    for w in m["workloads"]:
        moved = e2e[m["moves"]]
        assert "workloads" not in moved or w in moved["workloads"]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in MAN["workloads"]:
        e2e = [e["name"] for e in MAN["end_to_end"]
               if "workloads" not in e or w["name"] in e["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in MAN["per_layer"])
