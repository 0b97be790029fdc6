"""The benchmark's own reading of a configuration file (`configs/<name>.json`)
and of a cell's traffic file (`cells/<cell>.json`), found by name under
the benchmark's root.  The reference and the yardstick take this object,
never the program's configuration class."""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Config(SimpleNamespace):
    """A configuration's keys as attributes, with the grid it derives."""

    def _extent(self, k: int) -> int:
        return int(round((self.pc_range[3 + k] - self.pc_range[k])
                         / self.voxel_size[k]))

    @property
    def nx(self) -> int:
        return self._extent(0)

    @property
    def ny(self) -> int:
        return self._extent(1)

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny


def model_keys(raw: dict) -> dict:
    """The keys of a configuration file that configure the system: every
    key but the file's own notes."""
    notes = ("name", "source", "changed", "scene", "why", "deployment")
    return {k: v for k, v in raw.items() if k not in notes}


def load_config(name: str, root: str = HERE, overrides=None) -> tuple:
    """(Config, the system's keys as a dict) of `configs/<name>.json`,
    with `overrides` (a dict, tests only) applied to both."""
    raw = read_json(os.path.join(root, "configs", name + ".json"))
    raw.update(overrides or {})
    return Config(**raw), model_keys(raw)


def load_cell(name: str, root: str = HERE, overrides=None) -> dict:
    """The parameters of `cells/<name>.json`, with `overrides` applied."""
    cell = read_json(os.path.join(root, "cells", name + ".json"))
    cell.update(overrides or {})
    return cell
