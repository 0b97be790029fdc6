"""The readers of the program's host spans (`readers/spans.py`) on a trace
made by hand, and, on the card (marked `cuda`), the spans of a served
camera extract in the benchmark's own `Trace`:

    python3 -m pytest perfbench/tests -m cuda
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest

from perfbench import tracing
from perfbench.readers import spans
from perfbench.tests.helpers import ROOT
from perfbench.traffic import Run

MS = 1_000_000


def _run(host) -> Run:
    """A 10 ms traced window, busy over [0, 3], [5, 6] and [9, 10] ms, two
    units done inside it, bursts of 2."""
    t = tracing.Trace(enabled=False)
    t.t_start, t.t_stop = 10.0, 10.01
    t.device = [(0, 2 * MS, "conv"), (1 * MS, 3 * MS, "conv"),
                (5 * MS, 6 * MS, "hist_cluster"), (9 * MS, 10 * MS, "conv")]
    t.host = [(int(s * MS), int(e * MS), n) for s, e, n in host]
    run = Run()
    run.platform, run.trace = "gpu", t
    run.done = [10.004, 10.008, 10.5]
    run.shape = {"batch": 2}
    return run


HOST = [(0, 4, "gndnet.engine.submit"), (1, 3, "gndnet.engine.upload"),
        (1, 2, "gndnet.engine.slot_wait"), (2, 2.5, "aten::copy_"),
        (4, 8, "gndnet.engine.submit"), (6.5, 7, "gndnet.engine.slot_wait"),
        (8, 9, "gndnet.engine.fetch"),
        (2.5, 3, "gndnet.graph.replay"), (7, 7.5, "gndnet.graph.replay"),
        (9, 9.5, "gndnet.graph.replay"), (5, 6, "gndnet.graph.capture"),
        (3, 3.5, "gndnet.graph.eager")]
LESS = ["gndnet.engine.slot_wait"]


def test_self_time_per_unit():
    run = _run(HOST)
    # submits of 4 ms less 1 and 0.5 ms of slot waits, over 2 units
    assert spans.host_ms(run, "gndnet.engine.submit", LESS) == \
        pytest.approx(3.25)
    assert spans.host_ms(run, "gndnet.engine.submit") == pytest.approx(4.0)
    assert spans.host_ms(run, "gndnet.engine.submit", LESS, per="call") == \
        pytest.approx(6.5)


def test_percentile_of_self_times():
    run = _run(HOST)
    assert spans.host_percentile_ms(run, "gndnet.engine.submit", 99,
                                    LESS) == pytest.approx(3.0 + 0.99 * 0.5)
    assert spans.host_percentile_ms(run, "gndnet.engine.fetch", 50) == \
        pytest.approx(1.0)


def test_idle_inside_a_span():
    run = _run(HOST)
    # [0, 8] inside submit, 4 ms of it busy: 4 ms idle of a 10 ms window
    assert spans.idle_in_pct(run, "gndnet.engine.submit") == \
        pytest.approx(40.0)
    # the fetch [8, 9] falls in the gap [6, 9]
    assert spans.idle_in_pct(run, "gndnet.engine.fetch") == \
        pytest.approx(10.0)


def test_graph_hit_share():
    # 3 replays and 1 eager run are 4 calls; 1 capture and 1 eager miss
    assert spans.graph_hit_pct(_run(HOST)) == pytest.approx(50.0)
    only = [h for h in HOST if h[2] == "gndnet.graph.replay"]
    assert spans.graph_hit_pct(_run(only)) == pytest.approx(100.0)


def test_none_without_spans_or_window():
    bare = _run([(0, 4, "aten::copy_")])
    assert spans.host_ms(bare, "gndnet.engine.submit") is None
    assert spans.host_percentile_ms(bare, "gndnet.engine.submit", 99) is None
    assert spans.idle_in_pct(bare, "gndnet.train.batch") is None
    assert spans.graph_hit_pct(bare) is None
    run = _run(HOST)
    run.trace.t_stop = None
    assert spans.host_ms(run, "gndnet.engine.submit") is None
    assert spans.graph_hit_pct(run) is None
    run = _run(HOST)
    run.platform = "cpu"
    assert spans.idle_in_pct(run, "gndnet.engine.submit") is None
    run = _run(HOST)
    run.done = [11.0]
    assert spans.host_ms(run, "gndnet.engine.submit") is None


def test_overlap_against_a_mask():
    """Covered ns of random intervals against a union of random ones,
    against boolean masks over a 1 000 ns line."""
    rng = np.random.default_rng(0)
    for _ in range(50):
        def draw(k):
            a = rng.integers(0, 1000, (k, 2))
            a.sort(axis=1)
            return a[np.argsort(a[:, 0], kind="stable")]

        outer, inner = draw(int(rng.integers(1, 8))), draw(
            int(rng.integers(0, 8)))
        merged = spans._merge(inner)
        mask = np.zeros(1000, bool)
        for s, e in inner:
            mask[s:e] = True
        assert int(sum(e - s for s, e in merged)) == int(mask.sum())
        want = [int(mask[s:e].sum()) for s, e in outer]
        assert spans._overlap(outer, merged).tolist() == want


# --- on the card ----------------------------------------------------------


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_spans_in_the_benchmark_trace(card, tmp_path):
    """A graph engine serving camera extracts under the benchmark's Trace:
    the program's spans are among its host events and none among its
    device operations, and the span readers read them."""
    import torch

    from gndnet_tpu_torch.config import GndNetConfig
    from gndnet_tpu_torch.infer import GroundInferenceEngine
    from perfbench import cfg as cfgmod, scenes, weights

    cfg, keys = cfgmod.load_config("camera", os.path.join(ROOT, "perfbench"))
    rng = np.random.default_rng(7)
    pool = [scenes.scene(cfg.scene, cfg, rng, 10_000) for _ in range(8)]
    engine = GroundInferenceEngine(
        GndNetConfig.from_dict(keys),
        weights.make(cfg, 7, torch.device("cuda")), device="cuda")
    artifact = str(tmp_path / "aot.json")
    engine.aot_save(artifact, n=10_000)
    engine.aot_load(artifact)
    for _ in engine.infer_pipelined(pool, 3):
        pass
    trace = tracing.Trace(True)
    trace.warm(lambda: torch.ones(1, device="cuda").sum().item())
    run = Run()
    trace.start()
    for _ in engine.infer_pipelined(pool * 4, 3):
        run.done.append(time.perf_counter())
    trace.stop()
    run.platform, run.trace, run.shape = "gpu", trace, {"batch": 1}
    assert not [n for _, _, n in trace.device if n.startswith("gndnet.")]
    names = {n for _, _, n in trace.host}
    assert {"gndnet.engine.submit", "gndnet.engine.slot_wait",
            "gndnet.engine.stage_copy", "gndnet.graph.replay",
            "gndnet.engine.fetch"} <= names
    assert spans.host_ms(run, "gndnet.engine.submit", LESS) > 0
    assert 0 <= spans.idle_in_pct(run, "gndnet.engine.submit") <= 100
    assert spans.graph_hit_pct(run) == 100.0
