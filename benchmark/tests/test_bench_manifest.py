"""BENCHMARK.json against the benchmark's contract, and every file it names
present: names and units, metrics and the cells that report them, each
configuration used by a cell, bounds, the run length's budget."""
import json
import math
import os
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def test_top_level_keys_and_size(manifest):
    assert set(manifest) == TOP_KEYS
    assert os.path.getsize(harness.MANIFEST) <= 64 * 1024
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_are_unique_and_well_formed(manifest, group):
    names = [e["name"] for e in manifest[group]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name


def test_units_and_directions(manifest):
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= ({"bound"} if m in manifest["end_to_end"]
                    else {"layer", "moves"})
        assert set(m) <= allowed, set(m) - allowed


def test_end_to_end_sources_bounds_and_setup(manifest):
    names = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in names
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(manifest):
    for cell in manifest["workloads"]:
        e2e = {m["name"] for m in
               harness.cell_metrics(manifest, cell["name"], "end_to_end")}
        layers = harness.cell_metrics(manifest, cell["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2, cell["name"]
        assert layers, cell["name"]


def test_moves_names_a_metric_that_every_reporting_cell_reports(manifest):
    cells = [c["name"] for c in manifest["workloads"]]
    for m in manifest["per_layer"]:
        for cell in m.get("workloads", cells):
            assert cell in cells, (m["name"], cell)
            e2e = {x["name"] for x in
                   harness.cell_metrics(manifest, cell, "end_to_end")}
            assert m["moves"] in e2e, (m["name"], cell)


def test_every_metric_listing_cells_lists_known_cells(manifest):
    cells = {c["name"] for c in manifest["workloads"]}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]


def test_configurations_each_have_a_cell_and_their_file(manifest):
    used = {c["config"] for c in manifest["workloads"]}
    files = set()
    for conf in manifest["configs"]:
        assert conf["name"] in used, conf["name"]
        assert conf["file"].startswith("benchmark/")
        assert os.path.exists(harness.repo_path(conf["file"]))
        assert conf["file"] not in files
        files.add(conf["file"])
        assert len(conf["reduced"]) <= 16
        data = harness.read_json(harness.repo_path(conf["file"]))
        assert data["source"] == conf["source"]
        assert data["reduced"] == conf["reduced"]


def test_cells_have_files_entries_and_one_chip(manifest):
    pairs = set()
    for cell in manifest["workloads"]:
        assert cell["chips"] in (1, 4)
        assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
        pair = (cell["config"], cell["traffic"])
        assert pair not in pairs
        pairs.add(pair)
        wl = harness.load_workload(cell["name"])
        assert wl["config"] == cell["config"]
        assert os.path.exists(os.path.join(
            harness.HERE, "entries", wl["entry"] + ".py"))
    fours = sum(c["chips"] == 4 for c in manifest["workloads"])
    assert fours <= max(1, len(manifest["workloads"]) // 4)


def test_every_per_layer_metric_has_its_reader(manifest):
    for m in manifest["per_layer"]:
        module = harness.load_module("metrics", m["name"])
        assert callable(module.read)
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_run_seconds_fits_a_full_check_of_24_cells(manifest):
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_cell_limits_are_set(manifest):
    for cell in manifest["workloads"]:
        check = harness.load_workload(cell["name"])["check"]
        for key, value in check.items():
            assert value is not None and not (
                isinstance(value, float) and math.isnan(value)), key


def test_the_manifest_is_plain_json():
    with open(harness.MANIFEST, encoding="utf-8") as f:
        json.load(f)
