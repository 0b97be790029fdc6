"""BENCHMARK.json and the files the harness finds by name: every cell,
configuration and metric resolves, the contract's shapes hold, and a cell
added as files alone runs."""

from __future__ import annotations

import importlib
import json
import os
import re
import shutil

import pytest

from perfbench import cfg as cfgmod
from perfbench import traffic
from perfbench.tests.helpers import ROOT, bench, tiny_run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HERE = os.path.join(ROOT, "perfbench")


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in b["command"])


def test_every_configuration_resolves():
    for c in bench()["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        raw = cfgmod.read_json(os.path.join(ROOT, c["file"]))
        assert raw["name"] == c["name"] and raw["source"] == c["source"]
        assert sorted(raw["changed"]) == sorted(c["reduced"])
        cfg, keys = cfgmod.load_config(c["name"], HERE)
        assert cfg.nx * cfg.ny == cfg.num_cells and "source" not in keys


def test_every_cell_resolves():
    b = bench()
    configs = {c["name"] for c in b["configs"]}
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        cell = cfgmod.load_cell(w["name"], HERE)
        assert cell["driver"] in traffic.DRIVERS
        assert set(cell["limits"]) and all(
            v >= 0 for v in cell["limits"].values())
        used.add(w["config"])
    assert used == configs
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == \
        len(b["workloads"])


def _reader(name: str):
    with open(os.path.join(HERE, "metrics", name + ".json")) as f:
        spec = json.load(f)
    module, fn = spec["reader"].rsplit(".", 1)
    return getattr(importlib.import_module("perfbench.readers." + module), fn)


def test_every_metric_resolves():
    b = bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert callable(_reader(m["name"]))
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get(
            "workloads", [w["name"] for w in b["workloads"]]))


def test_every_cell_reports_setup_another_and_a_layer():
    b = bench()
    for w in b["workloads"]:
        e2e = [m["name"] for m in b["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])


def test_cell_added_as_files_only(tmp_path):
    """A new cell is an entry in BENCHMARK.json and a traffic file: no
    file of the harness changes."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    b["workloads"].append({"name": "camera.serve_depth1", "config": "camera",
                           "traffic": "serve_depth1", "chips": 1,
                           "why": "one scan in flight"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "camera.serve_closed" in m.get("workloads", []):
            m["workloads"].append("camera.serve_depth1")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = cfgmod.load_cell("camera.serve_closed", HERE)
    cell["depth"] = 1
    (root / "perfbench" / "cells" / "camera.serve_depth1.json").write_text(
        json.dumps(cell))
    line, err = tiny_run("camera.serve_depth1", root=str(root))
    assert line is not None, err[-3000:]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"scans_per_s", "setup_s"}


@pytest.mark.parametrize("name", ["kitti_sem", "camera"])
def test_configuration_changes_only_what_it_lists(name):
    """The configuration file holds the shipped yaml's keys as run: only
    the keys under `changed` differ from the port's copy of the yaml."""
    yaml = pytest.importorskip("yaml")
    with open(os.path.join(ROOT, "configs", name + ".yaml")) as f:
        shipped = yaml.safe_load(f)
    raw = cfgmod.read_json(os.path.join(HERE, "configs", name + ".json"))
    keys = cfgmod.model_keys(raw)
    differ = {k for k, v in keys.items() if k in shipped and shipped[k] != v}
    assert differ == set(raw["changed"])
    assert all(shipped[k] == raw["changed"][k][0] for k in differ)
