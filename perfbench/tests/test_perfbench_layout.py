"""BENCHMARK.json and the files the harness finds by name: every cell,
configuration and metric resolves, the contract's shapes hold, and a cell
or a configuration added as files alone runs."""

from __future__ import annotations

import importlib
import json
import os
import re

import pytest

from perfbench import cfg as cfgmod
from perfbench import traffic
from perfbench.tests.helpers import (PROBE, PROBE_CELL, PROBE_YAML, ROOT,
                                     add_probe, bench, copy_checkout,
                                     probe_checkout, tiny_run)

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


def _configurations_resolve(root: str) -> None:
    here = os.path.join(root, "perfbench")
    for c in bench(root)["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        raw = cfgmod.read_json(os.path.join(root, c["file"]))
        assert raw["name"] == c["name"] and raw["source"] == c["source"]
        assert sorted(raw["changed"]) == sorted(c["reduced"])
        cfg, keys = cfgmod.load_config(c["name"], here)
        assert cfg.nx * cfg.ny == cfg.num_cells and "source" not in keys


def test_every_configuration_resolves():
    _configurations_resolve(ROOT)


def _cells_resolve(root: str) -> None:
    b = bench(root)
    configs = {c["name"] for c in b["configs"]}
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        cell = cfgmod.load_cell(w["name"], os.path.join(root, "perfbench"))
        assert cell["driver"] in traffic.DRIVERS
        assert set(cell["limits"]) and all(
            v >= 0 for v in cell["limits"].values())
        used.add(w["config"])
    assert used == configs
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == \
        len(b["workloads"])


def test_every_cell_resolves():
    _cells_resolve(ROOT)


def _reader(root: str, name: str):
    with open(os.path.join(root, "perfbench", "metrics",
                           name + ".json")) as f:
        spec = json.load(f)
    module, fn = spec["reader"].rsplit(".", 1)
    return getattr(importlib.import_module("perfbench.readers." + module), fn)


def _metrics_resolve(root: str) -> None:
    b = bench(root)
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert callable(_reader(root, m["name"]))
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get(
            "workloads", [w["name"] for w in b["workloads"]]))


def test_every_metric_resolves():
    _metrics_resolve(ROOT)


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
    root = copy_checkout(tmp_path)
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


def test_cpu_cut_by_rule():
    """The CPU cut: a configuration's TINY_CONFIG entry where it has one;
    else a grid wider than 50 cells a side cut to 40 of its own cells
    about its pc_range's centre, grid_range moved with it; a smaller grid
    as it is."""
    from perfbench.tests import cpu_run

    kitti = cfgmod.read_json(os.path.join(HERE, "configs", "kitti_sem.json"))
    camera = cfgmod.read_json(os.path.join(HERE, "configs", "camera.json"))
    assert cpu_run.tiny_config("kitti_sem", kitti) == \
        cpu_run.TINY_CONFIG["kitti_sem"]
    assert cpu_run.tiny_config("camera", camera) == \
        cpu_run.TINY_CONFIG["camera"]
    assert cpu_run.tiny_config("other", camera) == {}
    assert cpu_run.tiny_config("other", kitti) == {
        "pc_range": [-17.0, -20.0, -4.0, 23.0, 20.0, 4.0],
        "grid_range": [-20.0, -20.0, 20.0, 20.0], "num_points": 3000}
    fine = dict(kitti, pc_range=[-50.0, -50.0, -4.0, 50.0, 50.0, 4.0],
                grid_range=[-50.0, -50.0, 50.0, 50.0],
                voxel_size=[0.4, 0.4, 8.0])
    cut = cpu_run.tiny_config(PROBE["name"], fine)
    assert cut == {"pc_range": [-8.0, -8.0, -4.0, 8.0, 8.0, 4.0],
                   "grid_range": [-8.0, -8.0, 8.0, 8.0], "num_points": 3000}
    cfg, _ = cfgmod.load_config("kitti_sem", HERE, dict(fine, **cut))
    assert (cfg.nx, cfg.ny) == (40, 40)


def _changes_only_what_it_lists(root: str, name: str,
                                yaml_name: str | None = None) -> None:
    yaml = pytest.importorskip("yaml")
    with open(os.path.join(ROOT, "configs",
                           (yaml_name or name) + ".yaml")) as f:
        shipped = yaml.safe_load(f)
    raw = cfgmod.read_json(os.path.join(root, "perfbench", "configs",
                                        name + ".json"))
    keys = cfgmod.model_keys(raw)
    differ = {k for k, v in keys.items() if k in shipped and shipped[k] != v}
    assert differ == set(raw["changed"])
    assert all(shipped[k] == raw["changed"][k][0] for k in differ)


@pytest.mark.parametrize("name", [c["name"] for c in bench()["configs"]])
def test_configuration_changes_only_what_it_lists(name):
    """The configuration file holds the shipped yaml's keys as run: only
    the keys under `changed` differ from the port's copy of the yaml
    (`configs/<name>.yaml`)."""
    _changes_only_what_it_lists(ROOT, name)


def test_configuration_added_as_files_only(tmp_path):
    """A new configuration is a configuration file, a traffic file and
    their entries in BENCHMARK.json: no file of the harness or of its
    tests changes.  Its CPU run takes the rule's cut (`cpu_run.tiny_config`)
    and is correct; its control is not.  Written twice, its entries are
    there once."""
    pytest.importorskip("yaml")
    root = probe_checkout(tmp_path)
    add_probe(root)
    b = bench(root)
    assert [c["name"] for c in b["configs"]].count(PROBE["name"]) == 1
    for m in b["end_to_end"] + b["per_layer"]:
        assert m.get("workloads", []).count(PROBE_CELL["name"]) <= 1
    _configurations_resolve(root)
    _cells_resolve(root)
    _metrics_resolve(root)
    _changes_only_what_it_lists(root, PROBE["name"], PROBE_YAML)
    line, err = tiny_run(PROBE_CELL["name"], root=root)
    assert line is not None, err[-3000:]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"scans_per_s", "setup_s"}
    line, err = tiny_run(PROBE_CELL["name"], "control", root=root)
    assert line is not None, err[-3000:]
    assert line["correct"] is False, line["checks"]
