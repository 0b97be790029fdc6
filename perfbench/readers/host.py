"""Readers of the host clock: the drivers' own records and the window."""

from __future__ import annotations

import numpy as np


def mean(run, field: str):
    """The mean of a driver record (ms)."""
    values = run.records.get(field)
    return float(np.mean(values)) if values else None


def percentile(run, field: str, q: float):
    """The q-th percentile of a driver record (ms), over every unit it
    holds."""
    values = run.records.get(field)
    return float(np.percentile(values, q)) if values else None


def rate(run):
    """Units completed a second of the measured window."""
    return run.units / run.window_s if run.units else None


def setup(run):
    """Seconds from the start of the process to the start of the
    window."""
    return run.setup_s
