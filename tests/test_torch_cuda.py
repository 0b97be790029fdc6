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
from gndnet_tpu_torch.ops import affine, sort
from gndnet_tpu_torch.synthetic import synthetic_scan
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
