"""On the card (marked `cuda`; skips without one): the lightest cell at its
own size, sound and as its control, through the harness's command.

    python3 -m pytest perfbench/tests -m cuda
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench.tests.helpers import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_camera_cell_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "camera.serve_closed", "--seed", "2147483659", "--seconds", "2",
         "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]


@pytest.mark.cuda
def test_camera_control_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.control", "--workload",
         "camera.serve_closed", "--seeds", "11,12,13", "--fault", "control",
         "--seconds", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    assert len(lines) == 3 and not any(x["correct"] for x in lines)
