"""BENCHMARK.json and the files it names: every configuration, traffic,
limit, driver, reference, count and metric is there and loads, and every
name, unit and text keeps to the contract's characters and lengths."""

from __future__ import annotations

import importlib
import inspect
import json
import re

import pytest

from portbench.run import BENCH_DIR, ROOT, cell_module, load_cell, reader

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _text(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_run_length():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= len(BENCH["command"]) <= 32 and all(_text(w) for w in BENCH["command"])
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells: 2 + 14 * 24 runs, 2 x 90 s of compile a
    # cell and 1200 s spare must fit into 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_texts():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    for kind in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({e["name"] for e in kind}) == len(kind)
    for name in names:
        assert NAME.match(name), name
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and _text(w["why"]) and w["chips"] in (1, 4)
    # at most a quarter of the cells, rounded down, on four chips; one always may
    four = sum(1 for w in BENCH["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(CELLS) // 4)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text(c["source"]) and _text(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)


def test_metrics_keys_and_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in names and _text(m["layer"])
    for m in METRICS:
        assert reader(m["name"]).read({}) is None  # nothing to read: no number


BASE_PER_LAYER = {"device_idle_pct", "library_share_pct", "peak_mem_gib", "roofline_pct"}


def test_each_cell_reports_one_per_layer_set_and_its_metrics_have_a_reader():
    """Every cell reports setup_s, one solve time, and one per-layer set
    that moves it: the four base metrics and any metric added since, each
    once and each with a reader; a dotted name is read by its stem's."""
    for cell in CELLS:
        c = load_cell(cell)
        e2e = [m["name"] for m in c["end_to_end"]]
        solve = [name for name in e2e if name != "setup_s"]
        assert "setup_s" in e2e and len(solve) == 1
        stems = [m["name"].split(".")[0] for m in c["per_layer"]]
        assert len(stems) == len(set(stems)) and BASE_PER_LAYER <= set(stems)
        assert {m["moves"] for m in c["per_layer"]} == set(solve)
        for m in c["per_layer"]:
            assert callable(reader(m["name"]).read)
    assert reader("solve_ms.eigsh") is importlib.import_module("portbench.metrics.solve_ms")


@pytest.mark.parametrize("cell", CELLS)
def test_a_multi_chip_cells_driver_and_reference_take_a_group(cell):
    """A cell on four chips runs as four ranks: its driver is built with
    the group and its reference judges over it; a one-chip cell's are
    called as they always were."""
    c = load_cell(cell)
    driver = inspect.signature(cell_module(c, "drivers").Driver).parameters
    judge = inspect.signature(cell_module(c, "reference").judge).parameters
    if c["chips"] > 1:
        assert "group" in driver and "group" in judge
    else:
        assert list(driver) == ["cfg", "tr", "seed", "device", "phases"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c = load_cell(cell)
    tr = c["traffic"]
    for part in ("drivers", "reference", "counts"):
        assert (BENCH_DIR / part / f"{tr['driver']}.py").is_file()
    assert c["limits"] and all(v > 0 for v in c["limits"].values())
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and c["per_layer"]
    for key in ("pool", "warmup_requests", "trace_warmup", "trace_requests"):
        assert int(tr[key]) >= 1


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file_and_reduced(entry):
    path = ROOT / entry["file"]
    assert path.is_file() and path.parent == BENCH_DIR / "configs"
    cfg = json.loads(path.read_text())
    assert cfg["reduced"] == entry["reduced"] and cfg["source"] == entry["source"]
    # `published` holds the source's value of every key that was cut
    # (`reduced`) or departs from it (`departures`), each with its reason
    published = cfg.get("published", {})
    departures = cfg.get("departures", {})
    assert set(published) == set(entry["reduced"]) | set(departures)
    assert set(cfg.get("why_reduced", {})) == set(entry["reduced"])
    for key in published:
        assert cfg[key] != published[key]
    assert sum(1 for w in BENCH["workloads"] if w["config"] == entry["name"]) >= 1


def test_eigsh_residual_limit_is_the_configurations():
    """The residual limit lies between the program's and the control's
    readings, so inside the configuration's stated tolerance."""
    c = load_cell("banded10m-block-eigsh")
    assert c["limits"]["residual_max"] < c["config"]["residual_tol"]
