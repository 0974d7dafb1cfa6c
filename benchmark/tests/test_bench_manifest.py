"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(man["command"]) <= 32
    assert all(TEXT.match(w) for w in man["command"])
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert not p.startswith("/") and not p.endswith("_torch")
    rs = man["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # 24 cells: 2 + 14 x 24 runs of (rs + 60) s, 2 x 90 s a cell, 1200 spare
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(man):
    names = []
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        names.append(w["name"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])


def _reports(man, cell):
    return {m["name"] for m in man["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


def test_every_cell_reports_enough(man):
    for w in man["workloads"]:
        e2e = _reports(man, w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        pl = [m for m in man["per_layer"] if w["name"] in m.get(
            "workloads", [w["name"]])]
        assert pl, w["name"]


def test_moves_reported_where_listed(man):
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in man["workloads"]}
            assert m["moves"] in _reports(man, cell), (m["name"], cell)


def test_layers_spelt_alike(man):
    by_layer = {}
    for m in man["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_every_config_has_a_cell_and_its_files(man):
    used = {w["config"] for w in man["workloads"]}
    for c in man["configs"]:
        assert c["name"] in used
        path = os.path.join(ROOT, c["file"])
        assert c["file"].startswith(tuple(p + "/" for p in man["paths"]))
        with open(path) as f:
            json.load(f)
    files = [c["file"] for c in man["configs"]]
    assert len(files) == len(set(files))
    for w in man["workloads"]:
        for sub, name in (("workloads", w["traffic"]), ("limits", w["name"])):
            assert os.path.exists(os.path.join(
                ROOT, "benchmark", sub, f"{name}.json")), (sub, w)
        with open(os.path.join(ROOT, "benchmark", "workloads",
                               f"{w['traffic']}.json")) as f:
            kind = json.load(f)["kind"]
        assert os.path.exists(os.path.join(ROOT, "benchmark", "cells",
                                           f"{kind}.py")), (kind, w)
    for m in man["per_layer"]:
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "metrics", f"{m['name']}.py")), m["name"]


def test_four_chip_cells_within_share(man):
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)


def test_reduced_names_no_width(man):
    widths = re.compile(r"(_dim|_rank)$|hidden|intermediate|channels|width")
    for c in man["configs"]:
        assert not any(widths.search(k) for k in c["reduced"])
