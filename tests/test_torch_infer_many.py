"""Batched serving: the port's `GroundInferenceEngine.infer_many` against
the JAX engine's, on the 16x16 affine config of test_torch_infer.py
(float32, 'highest')."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from gndnet_tpu.checkpoint import import_torch_state_dict
from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.infer import GroundInferenceEngine as JaxEngine
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.infer import GroundInferenceEngine
from gndnet_tpu_torch.ops.postproc import segment_cloud
from gndnet_tpu_torch.weights import init_state_dict
from test_torch_infer import SMALL, THRESHOLD, _labels_agree, scene

BUCKET = 1024


@pytest.fixture(scope="module")
def engines():
    """The port's seeded weights with random BN statistics in both
    engines (the JAX variables through the JAX package's importer)."""
    jcfg, cfg = JaxConfig(**SMALL), GndNetConfig(**SMALL)
    sd = init_state_dict(cfg, seed=0)
    rng = np.random.default_rng(0)
    for name, t in sd.items():
        if name.endswith("running_mean"):
            t.copy_(torch.from_numpy(rng.normal(0, 0.1, t.shape)))
        elif name.endswith("running_var"):
            t.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, t.shape)))
    return (JaxEngine(jcfg, import_torch_state_dict(sd, jcfg),
                      threshold=THRESHOLD, bucket=BUCKET),
            GroundInferenceEngine(cfg, sd, threshold=THRESHOLD,
                                  bucket=BUCKET, device="cpu"))


def _scans(seed, sizes):
    rng = np.random.default_rng(seed)
    return [scene(rng, n) for n in sizes]


@pytest.mark.parametrize("transfer_dtype", ["float32", "int16"])
def test_infer_many_matches_jax(engines, transfer_dtype):
    """Three scans of different lengths in one bucket: elevation to rtol
    1e-4 / atol 1e-5, labels equal away from the threshold, results in
    submission order and cut to each scan's length."""
    jeng, teng = engines
    if transfer_dtype != "float32":
        jeng = JaxEngine(jeng.cfg, jeng._variables, threshold=THRESHOLD,
                         bucket=BUCKET, transfer_dtype=transfer_dtype)
        teng = GroundInferenceEngine(teng.cfg, teng.model.state_dict(),
                                     threshold=THRESHOLD, bucket=BUCKET,
                                     transfer_dtype=transfer_dtype,
                                     device="cpu")
    scans = _scans(0, (600, 700, 900))
    want, got = jeng.infer_many(scans), teng.infer_many(scans)
    assert len(got) == 3
    for scan, (ej, lj), (et, lt) in zip(scans, want, got):
        assert et.shape == (16, 16) and et.dtype == np.float32
        assert lt.shape == (scan.shape[0],) and lt.dtype == np.int8
        np.testing.assert_allclose(et, ej, rtol=1e-4, atol=1e-5)
        _labels_agree(scan, ej, lj, lt, tol=1e-4)
    assert set(np.unique(got[0][1])) == {-1, 0, 1}


# id: (transfer_dtype, transfer_features, columns a scan has, sizes)
FILL_CASES = {
    "float32": ("float32", None, 4, (600, 700, 900)),
    "int16": ("int16", None, 4, (600, 700, 900)),
    "float32_k3": ("float32", 3, 4, (600, 1000)),
    "int16_k3": ("int16", 3, 4, (600, 1000)),
    "float32_3_columns": ("float32", None, 3, (500, 800)),
    "int16_3_columns": ("int16", None, 3, (500, 800)),
    "float32_6_columns_f64": ("float32", None, 6, (700, 900)),
    "int16_6_columns_f64": ("int16", 3, 6, (700, 900)),
    "float32_on_the_boundary": ("float32", 3, 4, (BUCKET, BUCKET - 1)),
    "int16_on_the_boundary": ("int16", None, 4, (BUCKET, 100)),
    "float32_mixed": ("float32", None, 4, (BUCKET, BUCKET + 1)),
    "int16_mixed": ("int16", 3, 3, (600, 1500)),
    "float32_burst16": ("float32", None, 4,
                        (BUCKET + 1, 2 * BUCKET, *range(1100, 1996, 64))),
    "int16_k3_burst16": ("int16", 3, 4,
                         (BUCKET - 1, BUCKET, *range(100, 996, 64))),
}


def _columns(scan, columns):
    """The scan with `columns` columns (float64 above the config's 4), its
    first point far out of int16's range."""
    rng = np.random.default_rng(columns)
    if columns > scan.shape[1]:
        extra = rng.uniform(0, 1, (scan.shape[0], columns - scan.shape[1]))
        scan = np.concatenate([scan, extra], axis=1)
    scan = np.array(scan[:, :columns])
    scan[0, :3] = 1e4
    return scan


@pytest.mark.parametrize("case,path", [
    pytest.param(case, path, id=case if path == "burst" else f"{case}-{path}")
    for path in ("burst", "single") for case in FILL_CASES])
def test_infer_many_fills_the_stack_prepare_gives(engines, monkeypatch,
                                                   case, path):
    """What reaches `run_many` is bit-equal to the JAX engine's `_prepare`
    of each scan, built with the same transfer type and columns: a burst
    through `infer_many` (their np.stack) and single scans through
    `infer_pipelined`, in both transfer types, with fewer columns shipped
    than the config has, scans of fewer or more columns than shipped, and
    lengths on a bucket's boundary, in bursts of 2, 3 and 16.  `_fill`
    writes each scan once, a burst's on several threads where the process
    may run on more than one core; a burst over two buckets raises before
    it writes a row, while single scans of two buckets are served each in
    its own."""
    transfer_dtype, k, columns, sizes = FILL_CASES[case]
    jeng, teng = engines
    oracle = JaxEngine(jeng.cfg, jeng._variables, threshold=THRESHOLD,
                       bucket=BUCKET, transfer_dtype=transfer_dtype,
                       transfer_features=k)
    eng = GroundInferenceEngine(teng.cfg, teng.model.state_dict(),
                                threshold=THRESHOLD, bucket=BUCKET,
                                transfer_dtype=transfer_dtype,
                                transfer_features=k, device="cpu")
    scans = [_columns(s, columns) for s in _scans(6, sizes)]
    stacks, fills = [], []
    run_many, fill = eng.run_many, eng._fill

    def recorded_run_many(padded, **kw):
        stacks.append(padded.numpy().copy())
        return run_many(padded, **kw)

    def recorded_fill(points, out):
        fills.append(points.shape)
        fill(points, out)

    monkeypatch.setattr(eng, "run_many", recorded_run_many)
    monkeypatch.setattr(eng, "_fill", recorded_fill)
    want = [oracle._prepare(s)[0] for s in scans]
    if path == "burst":
        if len({w.shape for w in want}) > 1:
            with pytest.raises(ValueError, match="mixed buckets"):
                eng.infer_many(scans, eager=True)
            assert fills == [] and stacks == []
            assert eng.counts()["scans"] == 0
            return
        got = eng.infer_many(scans, eager=True)
        want = [np.stack(want)]
    else:
        got = list(eng.infer_pipelined(scans, 2))
        want = [w[None] for w in want]
    assert len(stacks) == len(want)
    for stack, w in zip(stacks, want):
        assert stack.dtype == w.dtype and stack.shape == w.shape
        assert stack.tobytes() == w.tobytes()
    assert len(fills) == len(scans) == eng.counts()["scans"]
    assert [labels.shape for _, labels in got] == [(n,) for n in sizes]
    split = path == "burst" and len(os.sched_getaffinity(0)) >= 4
    assert eng.counts()["parallel_fills"] == int(split)


def _engine(engines):
    _, teng = engines
    return GroundInferenceEngine(teng.cfg, teng.model.state_dict(),
                                 threshold=THRESHOLD, bucket=BUCKET,
                                 device="cpu")


@pytest.mark.parametrize("call,k,one_core", [
    ("infer", 1, False), ("infer_many", 1, False), ("infer_many", 2, False),
    ("infer_many", 16, False), ("infer_many", 16, True)])
def test_fill_threads(engines, monkeypatch, call, k, one_core):
    """A single scan (`infer`, a burst of one) fills on the caller's
    thread; a burst on a process that may run on four cores or more is
    shared by the caller and `gndnet-fill` threads, min(K, cores // 2) in
    all, each scan filled once, and fills on the caller's thread where the
    process may run on one.  PyTorch's thread count stays as it was."""
    if one_core:
        monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0})
    eng = _engine(engines)
    threads, fill = [], eng._fill

    def recorded_fill(points, out):
        threads.append((threading.get_ident(),
                        threading.current_thread().name))
        fill(points, out)

    monkeypatch.setattr(eng, "_fill", recorded_fill)
    scans = _scans(7, [600 + 20 * i for i in range(k)])
    torch_threads = torch.get_num_threads()
    if call == "infer":
        eng.infer(scans[0])
    else:
        eng.infer_many(scans, eager=True)
    assert len(threads) == k
    workers = min(k, len(os.sched_getaffinity(0)) // 2)
    caller = threading.get_ident()
    if k == 1 or workers < 2:
        assert {t for t, _ in threads} == {caller}
        assert eng.counts()["parallel_fills"] == 0
    else:
        assert all(t == caller or name.startswith("gndnet-fill")
                   for t, name in threads)
        assert len({t for t, _ in threads}) <= workers
        assert eng.counts()["parallel_fills"] == 1
    assert torch.get_num_threads() == torch_threads


class _HeldRing:
    """A host ring for a CPU engine that records when a slot is given back
    unsent."""

    allocs = 0

    def __init__(self):
        self.released, self.sent = [], 0

    def acquire(self, shape, dtype):
        self.host = torch.empty(shape, dtype=dtype)
        return self.host

    def release(self):
        self.released.append(time.perf_counter())

    def send(self):
        self.sent += 1
        return self.host.clone()


@pytest.mark.parametrize("k,bad", [(2, 0), (16, 0), (16, 15), (16, 6)])
def test_failing_fill_waits_for_the_burst(engines, monkeypatch, k, bad):
    """A `_fill` that raises on one scan of a burst: its exception reaches
    the caller, the slot is given back only after every fill has ended (no
    fill starts or ends after it), nothing is counted, and the next burst
    on the engine is served as if none had failed."""
    eng = _engine(engines)
    ring = eng._burst_ring = _HeldRing()
    fill, sizes, stamps = eng._fill, [600 + 20 * i for i in range(k)], []

    def slow_fill(points, out):
        stamps.append(time.perf_counter())
        try:
            if points.shape[0] == sizes[bad]:
                raise RuntimeError("fill failed")
            time.sleep(0.05)
            fill(points, out)
        finally:
            stamps.append(time.perf_counter())

    scans = _scans(8, sizes)
    monkeypatch.setattr(eng, "_fill", slow_fill)
    before = eng.counts()
    with pytest.raises(RuntimeError, match="fill failed"):
        eng.infer_many(scans, eager=True)
    time.sleep(0.2)
    assert len(ring.released) == 1 and ring.sent == 0
    assert stamps and max(stamps) < ring.released[0]
    assert eng.counts() == before
    monkeypatch.setattr(eng, "_fill", fill)
    got = eng.infer_many(scans, eager=True)
    want = eng.run_many(torch.from_numpy(
        np.stack([eng._prepare(s)[0] for s in scans])))
    assert len(ring.released) == 1 and ring.sent == 1
    for (elev, labels), e, l, n in zip(got, *want, sizes):
        np.testing.assert_array_equal(elev, e.numpy())
        np.testing.assert_array_equal(labels, l[:n].numpy())
    assert eng.counts()["scans"] == before["scans"] + k


def test_infer_many_rejects_mixed_buckets(engines):
    scans = _scans(1, (600, 1500))
    for engine in engines:
        with pytest.raises(ValueError, match="mixed buckets"):
            engine.infer_many(scans)


def test_infer_many_of_one_scan_equals_infer(engines):
    _, teng = engines
    scan = _scans(2, (800,))[0]
    (elev, labels), = teng.infer_many([scan])
    e1, l1 = teng.infer(scan)
    np.testing.assert_array_equal(elev, e1)
    np.testing.assert_array_equal(labels, l1)


def test_infer_many_equals_per_scan_infer(engines):
    """B=3 in one call against three B=1 calls of the port: the canvases
    are equal (test_torch_train_canvas.py), the SegNet may convolve a
    batch in another order."""
    _, teng = engines
    scans = _scans(3, (500, 1000, 1024))
    for (eb, lb), scan in zip(teng.infer_many(scans), scans):
        e1, l1 = teng.infer(scan)
        np.testing.assert_allclose(eb, e1, rtol=1e-5, atol=1e-6)
        _labels_agree(scan, e1, l1, lb, tol=1e-5)


def test_run_many_reference_path_matches_kernel_path(engines):
    _, teng = engines
    prepared = [teng._prepare(s)[0] for s in _scans(4, (700, 900))]
    padded = torch.from_numpy(np.stack(prepared))
    e1, l1 = teng.run_many(padded)
    e2, l2 = teng.run_many(padded, reference=True)
    assert e1.shape == (2, 16, 16) and l1.shape == (2, BUCKET)
    assert l1.dtype == torch.int8
    assert torch.equal(e1, e2) and torch.equal(l1, l2)


def test_run_many_labels_in_one_batched_gather(engines):
    """run_many labels its K scans in one batched `segment_cloud` call,
    bit-equal to labelling each scan against its own map in a loop."""
    _, teng = engines
    prepared = [teng._prepare(s)[0] for s in _scans(5, (700, 900, 1000))]
    padded = torch.from_numpy(np.stack(prepared))
    elev, labels = teng.run_many(padded)
    pts = teng.device_points(padded)
    loop = torch.stack([
        segment_cloud(p, teng.cfg.grid_range, teng.cfg.voxel_size[0], e.t(),
                      teng.threshold) for p, e in zip(pts, elev)])
    assert torch.equal(labels, loop.to(torch.int8))
    assert set(labels.unique().tolist()) == {-1, 0, 1}
