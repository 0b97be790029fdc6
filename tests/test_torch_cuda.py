"""The CUDA kernels against their plain versions on the card, at small
shapes.  Every test needs a CUDA device and skips without one; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py imports JAX, which the card's host need
not have.)
"""

import numpy as np
import pytest
import torch

from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.infer import GroundInferenceEngine
from gndnet_tpu_torch import train
from gndnet_tpu_torch.ops import affine, sort
from gndnet_tpu_torch.synthetic import synthetic_labelled_batch, synthetic_scan
from gndnet_tpu_torch.weights import init_state_dict

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 2, 255, 256, 4096, 4097, 70_000])
def test_sort_kernel(dev, n):
    rng = np.random.default_rng(n)
    for x in (rng.integers(-2**31, 2**31 - 1, n), rng.integers(-9, 9, n)):
        x = torch.from_numpy(x.astype(np.int32)).to(dev)
        before = sort.sort_i32.launches
        got = sort.sort_i32(x)
        assert sort.sort_i32.launches == before + 1
        assert torch.equal(got, sort.sort_i32_plain(x))


@pytest.mark.parametrize("ny,nx", [(10, 13), (100, 100), (250, 250)])
def test_histogram_kernel(dev, ny, nx):
    """Shared-memory counters up to 12288 cells, global atomics above."""
    rng = np.random.default_rng(ny)
    ids = torch.from_numpy(rng.integers(0, ny * nx + 1, (2, 50_000)).astype(
        np.int32)).to(dev)
    for x in (ids, ids.sort(dim=1).values.contiguous()):
        assert torch.equal(affine.histogram_counts(x, ny, nx),
                           affine.histogram_counts_plain(x, ny, nx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap", [5, None])
@pytest.mark.parametrize("a", [3, 4, 5])
def test_scan_kernel(dev, dtype, cap, a):
    rng = np.random.default_rng(a)
    n, ncells, c = 5000, 300, 64
    counts = np.bincount(rng.integers(0, ncells, n), minlength=ncells)
    counts[7] += 400                                    # longer than a pass
    counts = torch.from_numpy(counts.astype(np.int32)).to(dev)
    pts = torch.from_numpy(rng.normal(
        size=(int(counts.sum()), a)).astype(np.float32) * 10).to(dev)
    starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    mmat = torch.from_numpy(rng.normal(size=(a, c)).astype(np.float32)).to(
        dev)
    tot, smax = affine.affine_scan_gather(pts, starts, counts, mmat, cap,
                                          dtype)
    tot_p, smax_p = affine.affine_scan_gather_plain(pts, starts, counts,
                                                    mmat, cap, dtype)
    assert torch.equal(tot, tot_p)
    assert torch.equal(smax.float(), smax_p.float())


def _stream(dev, a, seed, c=64):
    """5000 rows in 300 cells (one longer than a staging pass), ~45% of
    rows repeating an earlier row of their cell (exact ties)."""
    rng = np.random.default_rng(seed)
    counts = np.bincount(rng.integers(0, 300, 5000), minlength=300)
    counts[7] += 400
    counts[11] = 0
    pts = rng.normal(size=(int(counts.sum()), a)).astype(np.float32) * 10
    starts = np.cumsum(counts) - counts
    for cell in range(300):
        for r in range(starts[cell] + 1, starts[cell] + counts[cell]):
            if rng.uniform() < 0.45:
                pts[r] = pts[rng.integers(starts[cell], r)]
    mmat = rng.normal(size=(a, c)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dev) for x in (
        pts, starts.astype(np.int32), counts.astype(np.int32), mmat))


@pytest.mark.parametrize("dtype,cap", [(torch.float32, 5),
                                       (torch.float32, None),
                                       (torch.bfloat16, None),
                                       (torch.bfloat16, 5),
                                       (torch.bfloat16, 100)])
@pytest.mark.parametrize("a", [3, 4, 5])
def test_argmax_scan_kernels(dev, dtype, cap, a):
    """K5 where `_make_scan_gather` takes it (bf16 with a cap), K4
    otherwise: tot, smax and argpos equal the plain version's exactly."""
    pts, starts, counts, mmat = _stream(dev, a, a)
    packed = affine.packed_argmax(dtype, cap)
    fn = (affine.affine_scan_argmax_packed if packed
          else affine.affine_scan_argmax_pair)
    before = fn.launches
    tot, smax, pos = fn(pts, starts, counts, mmat, cap, dtype)
    assert fn.launches == before + 1
    tot_p, smax_p, pos_p = affine.affine_scan_argmax_plain(
        pts, starts, counts, mmat, cap, dtype, packed)
    assert torch.equal(tot, tot_p)
    assert torch.equal(smax.float(), smax_p.float())
    assert torch.equal(pos, pos_p)
    assert int(pos[11].max()) == -1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ncells", [300, 20_000])
def test_dmmat_kernel(dev, dtype, ncells):
    """K6 against its plain version within 1e-5 of the result's scale
    (another f32 summation order), and the same bits on every run (no
    float atomics)."""
    rng = np.random.default_rng(ncells)
    n = 50_000
    pts = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32)).to(
        dev)
    counts = torch.from_numpy(rng.integers(0, 3, ncells).astype(
        np.int32)).to(dev)
    pos = torch.from_numpy(rng.integers(0, n, (ncells, 64)).astype(
        np.int32)).to(dev)
    pos[counts == 0] = -1
    d = torch.from_numpy(rng.normal(size=(ncells, 64)).astype(
        np.float32)).to(dev).to(dtype)
    before = affine.affine_bwd_dmmat.launches
    got = affine.affine_bwd_dmmat(pts, pos, d, counts, dtype)
    again = affine.affine_bwd_dmmat(pts, pos, d, counts, dtype)
    assert affine.affine_bwd_dmmat.launches == before + 2
    want = affine.affine_bwd_dmmat_plain(pts, pos, d, counts, dtype)
    assert torch.equal(got, again)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


def test_train_steps_kernel_path_match_plain_path(dev):
    """Two f32 train steps at B=2 through K3, K4 and K6 against the plain
    path, TF32 off: losses within rel 1e-5, parameters within 1e-5 of
    each tensor's scale (K6 and cuDNN's backward sum in other orders)."""
    cfg = GndNetConfig(pc_range=(0.0, -8.0, -4.0, 16.0, 8.0, 4.0),
                       grid_range=(0.0, -8.0, 16.0, 8.0),
                       max_points_voxel=20, lidar_height=1.7,
                       fused_impl="affine")
    pts, labels = synthetic_labelled_batch(cfg, np.random.default_rng(1), 2,
                                           3000)
    kern = train.create_train_state(cfg, 10)
    plain = train.create_train_state(cfg, 10)
    before = affine.affine_scan_argmax_pair.launches
    for _ in range(2):
        _, lk = train.make_train_step(cfg)(kern, pts, labels)
        _, lp = train.make_train_step(cfg, reference=True)(plain, pts,
                                                           labels)
        assert abs(float(lk) - float(lp)) <= 1e-5 * abs(float(lp))
    assert affine.affine_scan_argmax_pair.launches == before + 2
    for (name, a), b in zip(kern.model.state_dict().items(),
                            plain.model.state_dict().values()):
        scale = max(float(b.abs().max()), 1e-4)
        assert float((a - b).abs().max()) <= 1e-5 * scale, name


def test_engine_kernel_path_matches_plain_path(dev):
    cfg = GndNetConfig(pc_range=(0.0, -8.0, -4.0, 16.0, 8.0, 4.0),
                       grid_range=(0.0, -8.0, 16.0, 8.0),
                       max_points_voxel=20, lidar_height=1.7,
                       fused_impl="affine")
    eng = GroundInferenceEngine(cfg, init_state_dict(cfg, seed=0),
                                bucket=512)
    scan = synthetic_scan(cfg, np.random.default_rng(0), 3000)
    padded = torch.from_numpy(eng._prepare(scan)[0])
    e1, l1 = eng.run(padded)
    e2, l2 = eng.run(padded, reference=True)
    assert torch.equal(e1, e2) and torch.equal(l1, l2)
