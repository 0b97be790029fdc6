"""The program's host spans (`utils.profiling.span`): free without a
profiler, recorded once a scan, burst or step under one, nested as the
engine and the train step nest their stages, and in `utils.profiling.trace`'s
Chrome trace.  The tests marked `cuda` hold the spans of a CUDA graph's
replay and capture to the device trace; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py

This file imports no JAX, so it runs there as it is.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gndnet_tpu_torch import train
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.infer import GroundInferenceEngine
from gndnet_tpu_torch.synthetic import synthetic_labelled_batch, synthetic_scan
from gndnet_tpu_torch.utils import profiling
from gndnet_tpu_torch.weights import init_state_dict

SMALL = dict(pc_range=(0.0, -8.0, -4.0, 16.0, 8.0, 4.0),
             grid_range=(0.0, -8.0, 16.0, 8.0), voxel_size=(1.0, 1.0, 8.0),
             max_points_voxel=20, max_voxels=256, num_points=600,
             fused_impl="affine")
POINTS = 600
PIPELINED = 5       # scans through infer_pipelined at depth 3

SUBMIT, FETCH = "gndnet.engine.submit", "gndnet.engine.fetch"
DISPATCH = "gndnet.engine.dispatch"
STEP = "gndnet.train.step"
# (entry, span, its parent or None, how many the entry records)
ENGINE = [(SUBMIT, None), ("gndnet.engine.prepare", SUBMIT),
          ("gndnet.engine.upload", SUBMIT), (DISPATCH, SUBMIT),
          ("gndnet.graph.eager", DISPATCH), (FETCH, None)]
CASES = ([("infer", s, p, 1) for s, p in ENGINE]
         + [("infer_pipelined", s, p, PIPELINED) for s, p in ENGINE]
         + [("infer", "gndnet.engine.readback", SUBMIT, 1),
            ("infer_pipelined", "gndnet.engine.readback", SUBMIT, PIPELINED)]
         + [("infer_many", s, p, 1) for s, p in ENGINE]
         + [("infer_many", "gndnet.engine.stack", SUBMIT, 1)]
         + [("train_step", STEP, None, 1),
            ("train_step", "gndnet.train.batch", STEP, 1),
            ("train_step", "gndnet.graph.eager", STEP, 1)])


def _cfg() -> GndNetConfig:
    return GndNetConfig(**SMALL)


def _spans(prof) -> list:
    """[(start_ns, end_ns, name)] of the program's host spans."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type().name == "CPU"
                  and e.name().startswith("gndnet."))


def _parent(spans: list, i: int):
    """The name of the innermost other span holding span i, or None."""
    s, e, _ = spans[i]
    holders = [(he - hs, name) for j, (hs, he, name) in enumerate(spans)
               if j != i and hs <= s and e <= he]
    return min(holders)[1] if holders else None


@pytest.fixture(scope="module")
def recorded():
    """{entry: [(span, parent)]} of each entry point run once under a CPU
    profiler, after an unprofiled warm call."""
    cfg = _cfg()
    rng = np.random.default_rng(0)
    scans = [synthetic_scan(cfg, rng, POINTS) for _ in range(PIPELINED)]
    engine = GroundInferenceEngine(cfg, init_state_dict(cfg, seed=0),
                                   device="cpu")
    state = train.create_train_state(cfg, 10, device="cpu")
    step = train.make_train_step(cfg)
    pts, labels = synthetic_labelled_batch(cfg, rng, 2, POINTS)
    entries = {
        "infer": lambda: engine.infer(scans[0]),
        "infer_pipelined": lambda: list(engine.infer_pipelined(scans, 3)),
        "infer_many": lambda: engine.infer_many(scans[:2]),
        "train_step": lambda: step(state, pts, labels),
    }
    out = {}
    for name, fn in entries.items():
        fn()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        spans = _spans(prof)
        out[name] = [(n, _parent(spans, i))
                     for i, (_, _, n) in enumerate(spans)]
    return out


def test_span_without_a_profiler_is_free(monkeypatch):
    """No profiler: the one shared null context, and no record_function
    built."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("gndnet.a"), profiling.span("gndnet.b")
    assert a is b is profiling._OFF
    with a:
        pass
    cfg = _cfg()
    engine = GroundInferenceEngine(cfg, init_state_dict(cfg, seed=0),
                                   device="cpu")
    engine.infer(synthetic_scan(cfg, np.random.default_rng(1), POINTS))


@pytest.mark.parametrize("entry,span,parent,count", CASES)
def test_span_recorded_and_nested(recorded, entry, span, parent, count):
    got = [p for n, p in recorded[entry] if n == span]
    assert len(got) == count, recorded[entry]
    assert set(got) == {parent}


def test_engine_counts():
    """What the engine served, counted where the work happens: a CPU
    engine has no graph, so every scan runs eagerly; each burst's fill is
    shared by several threads where the process may run on four cores or
    more."""
    cfg = _cfg()
    rng = np.random.default_rng(2)
    scans = [synthetic_scan(cfg, rng, POINTS) for _ in range(4)]
    engine = GroundInferenceEngine(cfg, init_state_dict(cfg, seed=0),
                                   device="cpu")
    engine.infer(scans[0])
    list(engine.infer_pipelined(scans[:3], 2))
    engine.infer_many(scans, eager=True)
    engine.infer_many(scans[:2])
    cores = len(os.sched_getaffinity(0))
    assert engine.counts() == {"scans": 10, "replays": 0, "captures": 0,
                               "eager_scans": 10, "slot_allocs": 0,
                               "pair_sorted": 0,
                               "readbacks": 4, "readback_allocs": 0,
                               "parallel_fills": 2 if cores >= 4 else 0}


def test_trace_file_holds_the_spans(tmp_path):
    cfg = _cfg()
    engine = GroundInferenceEngine(cfg, init_state_dict(cfg, seed=0),
                                   device="cpu")
    scan = synthetic_scan(cfg, np.random.default_rng(3), POINTS)
    with profiling.trace(str(tmp_path)):
        engine.infer(scan)
    path, = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert {SUBMIT, "gndnet.engine.prepare", "gndnet.engine.upload",
            DISPATCH, "gndnet.graph.eager", FETCH} <= names


# --- on the card ----------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_profile():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@pytest.mark.cuda
def test_replay_spans_hold_their_graph_launch(dev, tmp_path):
    """Each `gndnet.graph.replay` span holds one cudaGraphLaunch, and
    every kernel linked to that launch starts after the span starts: the
    spans and the device trace share one clock."""
    cfg = _cfg()
    rng = np.random.default_rng(4)
    scans = [synthetic_scan(cfg, rng, POINTS) for _ in range(4)]
    engine = GroundInferenceEngine(cfg, init_state_dict(cfg, seed=0),
                                   device=dev)
    artifact = str(tmp_path / "aot.json")
    engine.aot_save(artifact, n=POINTS)
    engine.aot_load(artifact)
    list(engine.infer_pipelined(scans, 3))
    torch.cuda.synchronize()
    with _card_profile() as prof:
        list(engine.infer_pipelined(scans, 3))
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if e.device_type().name == "CPU"]
    device = [e for e in events if e.device_type().name != "CPU"]
    replays = [e for e in host if e.name() == "gndnet.graph.replay"]
    launches = [e for e in host if e.name() == "cudaGraphLaunch"]
    assert len(replays) == len(scans)
    for r in replays:
        inside = [e for e in launches
                  if r.start_ns() <= e.start_ns() and e.end_ns() <= r.end_ns()]
        assert len(inside) == 1, [e.name() for e in inside]
        cid = inside[0].correlation_id()
        # a device record carries its launch's correlation id (the
        # profiler's `linked_correlation_id` in some builds)
        kernels = [e for e in device
                   if cid in (e.correlation_id(), e.linked_correlation_id())]
        assert kernels, ("no device work linked to the graph launch", cid,
                         [(e.name()[:40], e.correlation_id(),
                           e.linked_correlation_id()) for e in device[:8]])
        assert all(k.start_ns() >= r.start_ns() for k in kernels)
    # the ring's stages: every slot held a copy, so each scan waits on one
    spans = _spans(prof)
    parents = {}
    for i, (_, _, n) in enumerate(spans):
        parents.setdefault(n, []).append(_parent(spans, i))
    assert parents["gndnet.graph.replay"] == [DISPATCH] * len(scans)
    for stage in ("gndnet.engine.slot_wait", "gndnet.engine.stage_copy"):
        assert parents[stage] == ["gndnet.engine.upload"] * len(scans)


@pytest.mark.cuda
def test_capture_inside_a_profiler(dev):
    """A train step's first call captures its graph inside an active
    profiler: the capture succeeds, records its span inside the step's,
    and the next call replays."""
    cfg = _cfg()
    pts, labels = synthetic_labelled_batch(cfg, np.random.default_rng(5), 2,
                                           POINTS)
    pts, labels = torch.from_numpy(pts).to(dev), torch.from_numpy(
        labels).to(dev)
    state = train.create_train_state(cfg, 10, device=dev)
    step = train.make_train_step(cfg)
    with _card_profile() as prof:
        step(state, pts, labels)
        _, loss = step(state, pts, labels)
        torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    assert step.replays == 2
    spans = _spans(prof)
    names = [n for _, _, n in spans]
    assert names.count("gndnet.graph.capture") == 1
    assert names.count("gndnet.graph.replay") == 2
    i = names.index("gndnet.graph.capture")
    assert _parent(spans, i) == STEP


@pytest.mark.cuda
def test_burst_fills_its_pinned_slot(dev):
    """A burst is padded straight into one pinned slot: two back-to-back
    bursts of one shape allocate it once and serve what `run_many` gives
    on the stack of `_prepare`'s padded scans; a burst waits on its slot's
    last copy and records no `stage_copy`, while a single scan through
    `infer_pipelined` records its slot's wait and its fill of the slot
    (`stage_copy`) under `upload`."""
    cfg = _cfg()
    rng = np.random.default_rng(6)
    bursts = [[synthetic_scan(cfg, rng, n) for n in (POINTS, 500, 300)]
              for _ in range(3)]
    engine = GroundInferenceEngine(cfg, init_state_dict(cfg, seed=0),
                                   device=dev)
    served = [engine.infer_many(b) for b in bursts[:2]]
    counts = engine.counts()
    assert counts["slot_allocs"] == 1 and counts["scans"] == 6
    for burst, answers in zip(bursts, served):
        stack = torch.from_numpy(np.stack(
            [engine._prepare(s)[0] for s in burst])).to(dev)
        elev, labels = engine.run_many(stack)
        for i, (scan, (e, lab)) in enumerate(zip(burst, answers)):
            assert np.array_equal(e, elev[i].cpu().numpy())
            assert np.array_equal(lab, labels[i, :len(scan)].cpu().numpy())
            e1, l1 = engine.infer(scan)
            np.testing.assert_allclose(e, e1, rtol=0, atol=1e-2)
            assert lab.shape == l1.shape
    list(engine.infer_pipelined(bursts[2], 3))
    torch.cuda.synchronize()
    with _card_profile() as prof:
        engine.infer_many(bursts[2])
        list(engine.infer_pipelined(bursts[2], 3))
        torch.cuda.synchronize()
    spans = _spans(prof)
    burst_end = next(e for s, e, n in spans if n == FETCH)
    parents = {}
    for i, (s, _, n) in enumerate(spans):
        side = "burst" if s < burst_end else "single"
        parents.setdefault((side, n), []).append(_parent(spans, i))
    assert parents[("burst", "gndnet.engine.slot_wait")] == [SUBMIT]
    assert parents[("burst", "gndnet.engine.stack")] == [SUBMIT]
    assert parents[("burst", "gndnet.engine.upload")] == [SUBMIT]
    assert ("burst", "gndnet.engine.stage_copy") not in parents
    for stage in ("gndnet.engine.slot_wait", "gndnet.engine.stage_copy"):
        assert parents[("single", stage)] == ["gndnet.engine.upload"] * 3
    assert engine.counts()["slot_allocs"] == 1 + 3
