"""BENCHMARK.json against the shape its format requires, and every file a cell is
made of found by name."""
from __future__ import annotations

import json
import re

import pytest

from port_bench import mix, run

from .conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|projection|head|"
                   r"expansion|per_tok)", re.I)


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"][:3] == ["python3", "-m", "port_bench"]
    # a full check of 24 cells (2 + 14 runs each, run_seconds + 60 s a run,
    # 2 × 90 s to compile a cell, 1200 s spare) fits in 43200 s
    r = BENCH["run_seconds"]
    assert isinstance(r, int) and r >= 1
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file_found(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    path = REPO / entry["file"]
    assert entry["file"].startswith("port_bench/configs/") and path.is_file()
    config = json.loads(path.read_text())
    assert config["name"] == entry["name"]
    assert (REPO / config["reference"]).is_file()
    assert set(entry["reduced"]) <= set(config) and len(entry["reduced"]) <= 16
    assert not [k for k in entry["reduced"] if WIDTH.search(k)]
    assert 1 <= len(entry["source"]) <= 200 and "\n" not in entry["source"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    _, got, config, traffic = run.load_cell(REPO, cell["name"])
    assert got == cell and config and {"operand", "call"} <= set(traffic)
    inputs = mix.load_module(REPO, f"port_bench/inputs/{traffic['operand']}.py")
    call = mix.load_module(REPO, f"port_bench/calls/{traffic['call']}.py")
    reference = mix.load_module(REPO, config["reference"])
    assert callable(inputs.operand) and callable(reference.judge)
    assert all(callable(getattr(call, f)) for f in ("serve", "reached_target", "answer"))
    e2e = {m["name"] for m in run.cell_metrics(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.cell_metrics(BENCH, cell, True)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    assert callable(run.load_reader(REPO, metric["name"]).read)


def test_end_to_end_bounds():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


ANSWER_TIME = {"setup_s", "answer_s", "answer_p95_s", "peak_gib"}


def test_end_to_end_metrics_reach_every_cell():
    """An end-to-end metric names no cells, so a cell of a new configuration
    is timed without an edit to any entry; a per-layer metric names the cells
    whose code it reads."""
    assert not [m["name"] for m in BENCH["end_to_end"] if "workloads" in m]
    assert not [m["name"] for m in BENCH["per_layer"] if "workloads" not in m]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_the_answer_time(cell):
    assert {m["name"] for m in run.cell_metrics(BENCH, cell, False)} == ANSWER_TIME


def test_per_layer_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
        layers.setdefault(m["layer"], set()).add(m["name"])
    perf = (REPO / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in perf, layer


def test_names_unique():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_four_chip_cells_within_the_share():
    cells = BENCH["workloads"]
    four = [w for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)
