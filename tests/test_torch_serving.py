"""The port's serving stack on the CPU against the JAX engine's: infer_async,
infer_pipelined, transfer_bytes, the AOT artifact and its dispatch,
StreamingEngine, and load_torch_checkpoint (the 16x16 affine config of
test_torch_infer.py, float32, 'highest', bucket 256)."""

import json
import os
import time

import numpy as np
import pytest
import torch

from gndnet_tpu.checkpoint import export_torch_state_dict, import_torch_state_dict
from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.infer import GroundInferenceEngine as JaxEngine
from gndnet_tpu_torch import _ext
from gndnet_tpu_torch.checkpoint import load_torch_checkpoint
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.infer import GroundInferenceEngine, StreamingEngine
from gndnet_tpu_torch.utils import compile_cache
from gndnet_tpu_torch.weights import init_state_dict
from test_torch_infer import SMALL, THRESHOLD, _labels_agree, scene

BUCKET = 256
SIZES = (300, 700, 256, 1000, 90)       # four buckets, one scan each size


@pytest.fixture(scope="module")
def weights():
    """The port's seeded weights with random BN statistics, and the same
    as JAX variables."""
    jcfg, cfg = JaxConfig(**SMALL), GndNetConfig(**SMALL)
    sd = init_state_dict(cfg, seed=0)
    rng = np.random.default_rng(0)
    for name, t in sd.items():
        if name.endswith("running_mean"):
            t.copy_(torch.from_numpy(rng.normal(0, 0.1, t.shape)))
        elif name.endswith("running_var"):
            t.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, t.shape)))
    return jcfg, cfg, sd, import_torch_state_dict(sd, jcfg)


@pytest.fixture(scope="module")
def engines(weights):
    jcfg, cfg, sd, variables = weights
    return (JaxEngine(jcfg, variables, threshold=THRESHOLD, bucket=BUCKET),
            GroundInferenceEngine(cfg, sd, threshold=THRESHOLD,
                                  bucket=BUCKET, device="cpu"))


def _scans(seed, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [scene(rng, n) for n in sizes]


def _same(a, b):
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_infer_async_matches_infer(engines):
    """(n, pred, labels) device tensors that, once fetched, are `infer`'s
    result bit for bit, scan by scan."""
    _, teng = engines
    for scan in _scans(1):
        n, pred, labels = teng.infer_async(scan)
        assert n == scan.shape[0] and isinstance(pred, torch.Tensor)
        assert labels.shape[0] == -(-max(n, 1) // BUCKET) * BUCKET
        got = (pred.cpu().numpy(), labels[:n].cpu().numpy())
        assert _same(got, teng.infer(scan))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_infer_pipelined_matches_infer_and_jax(engines, depth):
    """Submission order kept; bit-equal to the port's `infer`; JAX's
    `infer_pipelined` on the same variables to rtol 1e-4 / atol 1e-5,
    labels equal away from the threshold."""
    jeng, teng = engines
    scans = _scans(2)
    got = list(teng.infer_pipelined(scans, depth=depth))
    want = list(jeng.infer_pipelined(scans, depth=depth))
    assert len(got) == len(scans) == len(want)
    for scan, g, (ej, lj) in zip(scans, got, want):
        assert _same(g, teng.infer(scan))
        assert g[1].shape == (scan.shape[0],) and g[1].dtype == np.int8
        np.testing.assert_allclose(g[0], np.asarray(ej), rtol=1e-4,
                                   atol=1e-5)
        _labels_agree(scan, np.asarray(ej), np.asarray(lj), g[1], tol=1e-4)
    with pytest.raises(ValueError, match="depth"):
        next(teng.infer_pipelined(scans, depth=0))


@pytest.mark.parametrize("transfer_dtype", ["float32", "int16"])
@pytest.mark.parametrize("features", [3, 4])
def test_transfer_bytes_match_jax(weights, transfer_dtype, features):
    jcfg, cfg, sd, variables = weights
    kw = dict(threshold=THRESHOLD, bucket=BUCKET,
              transfer_dtype=transfer_dtype, transfer_features=features)
    jeng = JaxEngine(jcfg, variables, **kw)
    teng = GroundInferenceEngine(cfg, sd, device="cpu", **kw)
    for n in (1, 255, 256, 257, 1000):
        assert teng.transfer_bytes(n) == jeng.transfer_bytes(n)
        pts = np.random.default_rng(n).uniform(-2, 18, (n, 4))
        padded, _ = teng._prepare(pts.astype(np.float32))
        assert padded.nbytes == teng.transfer_bytes(n)


def test_aot_roundtrip_matches_fresh_engine(weights, tmp_path):
    """aot_save -> aot_load into a fresh CPU engine: the artifact records
    the example shape and transfer type, and every scan, of the recorded
    bucket or another, is bit-equal to a fresh engine's."""
    _, cfg, sd, _ = weights
    src = GroundInferenceEngine(cfg, sd, threshold=THRESHOLD, bucket=BUCKET,
                                device="cpu")
    path = str(tmp_path / "engine.aot")
    size = src.aot_save(path)
    assert size == os.path.getsize(path) > 0
    meta = compile_cache.load_compiled(path, "cpu")
    assert meta == {"example_shape": [512, 4], "example_dtype": "float32",
                    "transfer_dtype": "float32"}
    dst = GroundInferenceEngine(cfg, sd, threshold=THRESHOLD, bucket=BUCKET,
                                device="cpu")
    dst.aot_load(path)
    assert dst._aot_shape == (512, 4)
    assert dst.counts()["captures"] == 0        # no graphs on the CPU
    fresh = GroundInferenceEngine(cfg, sd, threshold=THRESHOLD,
                                  bucket=BUCKET, device="cpu")
    for scan in _scans(3, (300, 600)):          # 512 (recorded) and 768
        assert _same(dst.infer(scan), fresh.infer(scan))


def test_aot_custom_shape_dispatch(weights, monkeypatch):
    """An artifact saved for a custom n dispatches on the shape it records,
    not the engine's default: scans of that padded shape go to the
    engine's graph cache, as one scan of (1, 768, 4), others to `run`.
    The loader and the cache are mocked (a CPU engine captures no
    graph)."""
    _, cfg, sd, _ = weights
    eng = GroundInferenceEngine(cfg, sd, threshold=THRESHOLD, bucket=BUCKET,
                                device="cpu")
    custom = tuple(eng._example_input(600).shape)          # (768, 4)
    hits, graphs = [], eng._graphs

    def cache(padded):
        hits.append(tuple(padded.shape))
        return graphs(padded)

    monkeypatch.setattr(compile_cache, "load_compiled",
                        lambda path, device: {"example_shape": list(custom),
                                              "transfer_dtype": "float32"})
    monkeypatch.setattr(eng, "_graphs", cache)
    eng.aot_load("ignored.aot")
    assert eng._aot_shape == custom and hits == []
    rng = np.random.default_rng(4)
    eng.infer(scene(rng, 600))                  # pads to 768: the graph
    eng.infer(scene(rng, 300))                  # pads to 512: run
    list(eng.infer_pipelined([scene(rng, 700), scene(rng, 100)]))
    assert hits == [(1, *custom)] * 2
    eng.warmup(600)                             # warmup stays eager
    assert hits == [(1, *custom)] * 2

    eng16 = GroundInferenceEngine(cfg, sd, threshold=THRESHOLD,
                                  bucket=BUCKET, transfer_dtype="int16",
                                  device="cpu")
    with pytest.raises(ValueError, match="transfer_dtype"):
        eng16.aot_load("ignored.aot")


@pytest.mark.parametrize("field,value,match", [
    ("magic", "nope", "not a gndnet AOT artifact"),
    ("platform", "cuda", "compiled for 'cuda'"),
    ("torch_version", "0.0.1", "compiled with torch 0.0.1"),
    ("kernels", {"affine_scan": "0" * 16}, "compiled for other kernel"),
])
def test_load_compiled_rejects_mismatches(weights, tmp_path, field, value,
                                          match):
    _, cfg, sd, _ = weights
    eng = GroundInferenceEngine(cfg, sd, bucket=BUCKET, device="cpu")
    path = tmp_path / "engine.aot"
    eng.aot_save(str(path))
    payload = json.loads(path.read_text())
    if field == "kernels":
        value = dict(payload["kernels"], **value)
    payload[field] = value
    path.write_text(json.dumps(payload))
    with pytest.raises(ValueError, match=match):
        eng.aot_load(str(path))
    with pytest.raises(ValueError, match=match):
        compile_cache.load_compiled(str(path), "cpu")


def test_load_compiled_rejects_other_files(tmp_path):
    for name, data in (("bin.aot", b"\x80\x04\x95 not json"),
                       ("list.aot", b"[1, 2]"),
                       ("other.aot", b'{"magic": "gndnet-aot-v1"}')):
        (tmp_path / name).write_bytes(data)
        with pytest.raises(ValueError, match="not a gndnet AOT artifact"):
            compile_cache.load_compiled(str(tmp_path / name), "cpu")


def test_save_compiled_is_atomic(tmp_path, monkeypatch):
    """The artifact is written to a temporary file and renamed: a write
    that fails leaves the previous artifact whole."""
    path = str(tmp_path / "engine.aot")
    compile_cache.save_compiled(path, "cpu", meta={"example_shape": [1]})
    before = open(path, "rb").read()

    def failing_replace(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr(compile_cache.os, "replace", failing_replace)
    with pytest.raises(OSError, match="disk full"):
        compile_cache.save_compiled(path, "cpu", meta={"example_shape": [2]})
    assert open(path, "rb").read() == before
    monkeypatch.undo()
    assert compile_cache.load_compiled(path, "cpu") == {"example_shape": [1]}


def test_enable_compilation_cache_moves_the_kernel_builds(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(_ext, "BUILD_DIR", _ext.BUILD_DIR)
    cache = tmp_path / "kernels"
    assert compile_cache.enable_compilation_cache(str(cache)) == str(cache)
    assert cache.is_dir()
    for name in _ext.sources():
        path = _ext._lib_path(name)
        assert os.path.dirname(path) == str(cache)
        assert _ext.source_digest(name) in path


def _wait_for(srv, seq, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        out = srv.latest()
        if out is not None and out[0] == seq:
            return out
        time.sleep(0.005)
    raise AssertionError(f"no result for seq {seq} in {timeout} s")


@pytest.mark.parametrize("mailbox", ["native", "lock"])
def test_streaming_engine_latest_value(engines, mailbox):
    """`submit` never blocks and returns increasing seqs; stale frames are
    dropped (processed <= submitted); the last result is `infer` of the
    last submitted scan; a malformed scan counts in `errors` and the
    thread keeps serving."""
    _, teng = engines
    native = mailbox == "native"
    if native:
        from gndnet_tpu_torch import native as host

        if not host.available():
            pytest.skip("native toolchain unavailable")
    srv = StreamingEngine(teng, warmup=True,
                          use_native_mailbox=native).start()
    try:
        assert srv.native_mailbox == native
        assert srv.compile_seconds > 0 and srv.latest() is None
        scans = _scans(5)
        seqs = [srv.submit(s) for s in scans]
        assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
        out = _wait_for(srv, seqs[-1])
        assert _same(out[1:], teng.infer(scans[-1]))
        assert srv.errors == 0 and 1 <= srv.processed <= len(scans)

        srv.submit(np.full(8, 1.5, np.float32))     # neither (N, F) nor 2-D
        deadline = time.time() + 30
        while srv.errors == 0 and time.time() < deadline:
            time.sleep(0.005)
        assert srv.errors == 1 and srv.last_error
        seq = srv.submit(scans[0])
        out = _wait_for(srv, seq)
        assert _same(out[1:], teng.infer(scans[0]))
        assert srv.errors == 1
    finally:
        srv.stop()
    assert not srv._thread.is_alive()


def test_streaming_engine_requires_native_when_asked(engines, monkeypatch):
    from gndnet_tpu_torch import native as host

    _, teng = engines
    monkeypatch.setattr(host, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native"):
        StreamingEngine(teng, warmup=False, use_native_mailbox=True)
    srv = StreamingEngine(teng, warmup=False)
    assert not srv.native_mailbox


def test_load_torch_checkpoint_matches_jax_engine(weights, tmp_path):
    """A reference .pth.tar written from JAX variables by the JAX
    package's exporter: the port engine built from it serves the JAX
    engine's elevations to rtol 1e-4 / atol 1e-5; epoch and lowest_loss
    round-trip, and a bare state dict loads the same weights."""
    jcfg, cfg, _, variables = weights
    path = str(tmp_path / "model.pth.tar")
    sd_np = export_torch_state_dict(variables, jcfg)
    torch.save({"state_dict": sd_np, "epoch": 7, "lowest_loss": 0.125}, path)
    ckpt = load_torch_checkpoint(path, cfg)
    assert ckpt["epoch"] == 7 and ckpt["lowest_loss"] == 0.125
    bare = str(tmp_path / "bare.pth.tar")
    torch.save(sd_np, bare)
    loaded = load_torch_checkpoint(bare, cfg)
    assert loaded["epoch"] == 0 and loaded["lowest_loss"] == float("inf")
    assert loaded["state_dict"].keys() == ckpt["state_dict"].keys()
    assert all(torch.equal(loaded["state_dict"][k], v)
               for k, v in ckpt["state_dict"].items())

    teng = GroundInferenceEngine(cfg, ckpt["state_dict"], threshold=THRESHOLD,
                                 bucket=BUCKET, device="cpu")
    jeng = JaxEngine(jcfg, variables, threshold=THRESHOLD, bucket=BUCKET)
    for scan in _scans(6, (700, 300)):
        (ej, lj), (et, lt) = jeng.infer(scan), teng.infer(scan)
        np.testing.assert_allclose(et, np.asarray(ej), rtol=1e-4, atol=1e-5)
        _labels_agree(scan, np.asarray(ej), np.asarray(lj), lt, tol=1e-4)
