"""The CUDA kernels against their plain versions on the card, at small
shapes.  Every test needs a CUDA device and skips without one; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py imports JAX, which the card's host need
not have.)
"""

import time

import numpy as np
import pytest
import torch

from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.infer import GroundInferenceEngine
from gndnet_tpu_torch.models.segnet import no_tf32
from gndnet_tpu_torch import _ext, train
from gndnet_tpu_torch.ops import affine, affine_aux, segment, sort
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


@pytest.mark.parametrize("ny,nx,batch", [
    (10, 13, 2), (100, 100, 2), (100, 100, 16), (250, 250, 2),
    (2, affine.HIST_CLUSTER_MAX_CELLS // 2 + 1, 2)])
def test_histogram_kernel(dev, ny, nx, batch):
    """K3: one cluster launch a call up to HIST_CLUSTER_MAX_CELLS cells
    (kitti_sem at B=2 and at an `infer_many` burst's B=16, fine_grid's
    250x250), the global route just above: counts and ends equal to the
    plain versions on unsorted and sorted ids, one launch counted a call;
    every cluster size that holds the grid, and the global route, on the
    smaller grids."""
    rng = np.random.default_rng(ny + batch)
    nc = ny * nx
    ids = torch.from_numpy(rng.integers(0, nc + 1, (batch, 50_000)).astype(
        np.int32)).to(dev)
    routes = [0] + [g for g in (1, 2, 4, 8, 16)
                    if nc <= g * affine.HIST_CTA_CELLS] if nc <= 62_500 else []
    for x in (ids, ids.sort(dim=1).values.contiguous()):
        want_ends, want_counts = affine.histogram_ends_plain(x, ny, nx)
        before = affine.cell_histogram.launches
        counts = affine.histogram_counts(x, ny, nx)
        ends, counts2 = affine.histogram_ends(x, ny, nx)
        assert affine.cell_histogram.launches == before + 2
        assert counts.shape == (batch, ny, nx)
        assert torch.equal(counts.reshape(batch, -1), want_counts)
        assert torch.equal(counts2, want_counts)
        assert torch.equal(ends, want_ends)
        for g in routes:
            ends, counts = affine.cell_histogram(x, ny, nx, True, g)
            assert torch.equal(counts, want_counts), g
            assert torch.equal(ends, want_ends), g


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


def _kitti_train_stream(dev):
    """kitti_sem's B=2 training inputs to K5 from `synthetic.py` scans:
    the cell-sorted stream, run starts and counts (20 000 cells), and a
    random (4, 64) mmat."""
    from gndnet_tpu_torch.config import kitti_sem_config
    from gndnet_tpu_torch.ops import pillarize as pz
    cfg = kitti_sem_config()
    rng = np.random.default_rng(2)
    points, _ = synthetic_labelled_batch(cfg, rng, 2, cfg.num_points)
    pts = torch.from_numpy(points).to(dev)
    geom = pz.PillarGeometry.from_config(cfg)
    ctx = pz.bin_points_batch(pts, geom)
    spts, starts, counts = pz.cell_stream(pts.reshape(-1, pts.shape[-1]),
                                          ctx, geom)
    mmat = torch.from_numpy(rng.normal(size=(pts.shape[-1], 64)).astype(
        np.float32)).to(dev)
    return spts.contiguous(), starts, counts, mmat


@pytest.mark.parametrize("case,width", [
    ("kitti_B2", 64), ("one_cell_cap100", 64), ("one_cell_cap4096", 64),
    ("kitti_B2", 24), ("kitti_B2", 100), ("kitti_B2", 129), ("empty", 64)])
def test_argmax_scan_kernel_serving_shapes(dev, case, width):
    """K5 (a warp per cell, K2's body with the packed argmax key) at
    kitti_sem's B=2 training shapes from `synthetic.py`, one cell of 5 000
    points at cap 100 and at cap 4096 (the key's 12-bit rank field), 24 /
    100 / 129 channels (channel groups, odd widths without paired stores),
    and every cell empty: tot, smax and argpos equal to the plain
    version's, one launch a call."""
    spts, starts, counts, mmat = _kitti_train_stream(dev)
    rng = np.random.default_rng(width)
    cap = 100
    if width != 64:
        mmat = torch.from_numpy(rng.normal(size=(mmat.shape[0], width))
                                .astype(np.float32)).to(dev)
    if case.startswith("one_cell"):
        cap = int(case[len("one_cell_cap"):])
        counts = torch.zeros_like(counts)
        counts[12_345] = 5000
        starts = torch.zeros_like(starts)
        spts = torch.from_numpy((rng.normal(size=(5000, spts.shape[1]))
                                 * 10).astype(np.float32)).to(dev)
    if case == "empty":
        counts = torch.zeros_like(counts)
    before = affine.affine_scan_argmax_packed.launches
    got = affine.affine_scan_argmax_packed(spts, starts, counts, mmat, cap,
                                           torch.bfloat16)
    assert affine.affine_scan_argmax_packed.launches == before + 1
    want = affine.affine_scan_argmax_plain(spts, starts, counts, mmat, cap,
                                           torch.bfloat16, True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if case == "kitti_B2":
        assert int(counts.max()) > cap and int((counts > 0).sum()) > 1000


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ncells,a,width,empty", [
    (300, 4, 64, False), (20_000, 4, 64, False), (125_000, 4, 64, False),
    (20_000, 4, 64, True), (20_000, 4, 24, False), (20_000, 4, 100, False),
    (20_000, 4, 129, False), (20_000, 1, 64, False), (20_000, 8, 64, False)])
def test_dmmat_kernel(dev, dtype, ncells, a, width, empty):
    """K6 against its plain version within 1e-5 of the result's scale
    (another f32 summation order), the same bits in 20 calls (no float
    atomics; the ticket goes back to 0), and one device operation a call:
    argmax rows drawn anywhere in the stream, 24 / 100 / 129 channels
    (fewer than a warp's 64, two groups, odd), 1 and 8 features, a
    125 000-cell table larger than the resident grid, every cell empty."""
    from gndnet_tpu_torch.profile_serve import kernel_times
    rng = np.random.default_rng(ncells + width + a)
    n = 50_000
    pts = torch.from_numpy(rng.normal(size=(n, a)).astype(np.float32)).to(
        dev)
    counts = torch.from_numpy(rng.integers(0, 3, ncells).astype(
        np.int32)).to(dev)
    if empty:
        counts.zero_()
    pos = torch.from_numpy(rng.integers(0, n, (ncells, width)).astype(
        np.int32)).to(dev)
    pos[counts == 0] = -1
    d = torch.from_numpy(rng.normal(size=(ncells, width)).astype(
        np.float32)).to(dev).to(dtype)
    before = affine.affine_bwd_dmmat.launches
    got = affine.affine_bwd_dmmat(pts, pos, d, counts, dtype)
    again = [affine.affine_bwd_dmmat(pts, pos, d, counts, dtype)
             for _ in range(19)]
    assert affine.affine_bwd_dmmat.launches == before + 20
    want = affine.affine_bwd_dmmat_plain(pts, pos, d, counts, dtype)
    assert all(torch.equal(got, g) for g in again)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    if empty:
        assert scale == 0.0 and not got.any()
    # torch.profiler now and then drops a window's device records in a long
    # process (none, or 4 of 5 kernels seen): profile 20 calls, again when
    # it saw nothing, and round as chip_smoke does
    for _ in range(3):
        prof = kernel_times(lambda: affine.affine_bwd_dmmat(
            pts, pos, d, counts, dtype), 20)
        if "device_ops_per_call" in prof:
            break
    assert round(prof["device_ops_per_call"]) == 1


@pytest.mark.parametrize("case,width,dtype", [
    ("kitti_B2", 64, torch.float32), ("kitti_B2", 64, torch.bfloat16),
    ("one_cell_cap100", 64, torch.float32),
    ("one_cell_nocap", 64, torch.float32),
    ("one_cell_nocap", 64, torch.bfloat16),
    ("kitti_B2", 24, torch.float32), ("kitti_B2", 100, torch.float32),
    ("kitti_B2", 129, torch.bfloat16), ("empty", 64, torch.float32)])
def test_pair_argmax_scan_kernel_serving_shapes(dev, case, width, dtype):
    """K4 (`scan_cells`' (value, row) mode) at kitti_sem's B=2 training
    shapes from `synthetic.py`, f32 at cap 100 and bf16 without a cap, one
    cell of 5 000 points at cap 100 and without a cap (past K5's 4096-row
    key), 24 / 100 / 129 channels, and every cell empty: tot, smax and
    argpos equal to the plain version's, one launch a call."""
    spts, starts, counts, mmat = _kitti_train_stream(dev)
    rng = np.random.default_rng(width)
    cap = 100 if dtype == torch.float32 else None
    if width != 64:
        mmat = torch.from_numpy(rng.normal(size=(mmat.shape[0], width))
                                .astype(np.float32)).to(dev)
    if case.startswith("one_cell"):
        cap = 100 if case == "one_cell_cap100" else None
        counts = torch.zeros_like(counts)
        counts[12_345] = 5000
        starts = torch.zeros_like(starts)
        spts = torch.from_numpy((rng.normal(size=(5000, spts.shape[1]))
                                 * 10).astype(np.float32)).to(dev)
    if case == "empty":
        counts = torch.zeros_like(counts)
    assert not affine.packed_argmax(dtype, cap)
    before = affine.affine_scan_argmax_pair.launches
    got = affine.affine_scan_argmax_pair(spts, starts, counts, mmat, cap,
                                         dtype)
    assert affine.affine_scan_argmax_pair.launches == before + 1
    want = affine.affine_scan_argmax_plain(spts, starts, counts, mmat, cap,
                                           dtype, False)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if case == "kitti_B2":
        assert int(counts.max()) > 100 and int((counts > 0).sum()) > 1000


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


def _k7_stream(kind, n, rng):
    if kind == "runs":
        return np.sort(rng.integers(0, n // 20 + 1, n))
    if kind == "negated":
        return np.flip(-np.sort(rng.integers(0, n // 20 + 1, n)))
    if kind == "one_cell":
        return np.full(n, 3)
    # the drop run: the last 60% of rows share one id, over many tiles
    cells = np.sort(rng.integers(0, n // 20 + 1, n))
    cells[int(0.4 * n):] = n
    return cells


@pytest.mark.parametrize("kind", ["runs", "negated", "one_cell", "drop"])
@pytest.mark.parametrize("n,width", [(1, 4), (1000, 4), (5000, 64),
                                     (70_001, 4), (20_480, 64), (4000, 6),
                                     (30_000, 200)])
def test_suffix_segment_kernel(dev, kind, n, width):
    """K7 against its plain version, which sums in the kernel's order: max
    (f32 and bf16) and sum equal to the bit, and the same bits on a second
    run; N is not always a multiple of the kernel's tile, rows of 6
    columns are not a 16-byte multiple, and 200 columns take four column
    chunks."""
    rng = np.random.default_rng(n + width)
    cell = torch.from_numpy(_k7_stream(kind, n, rng).astype(np.int32)).to(
        dev)
    x = torch.from_numpy(rng.normal(size=(n, width)).astype(np.float32)).to(
        dev)
    before = segment.suffix_segment_reduce.launches
    for xx in (x, x.bfloat16()):
        got = segment.suffix_segment_reduce(xx, cell, "max", 1)
        assert got.dtype == xx.dtype
        assert torch.equal(got, segment.suffix_segment_reduce_plain(
            xx, cell, "max", 1))
    x[:, -1] = (x[:, -1] > 0).float()
    got = segment.suffix_segment_reduce(x, cell, "sum", 1)
    again = segment.suffix_segment_reduce(x, cell, "sum", 1)
    want = segment.suffix_segment_reduce_plain(x, cell, "sum", 1)
    assert segment.suffix_segment_reduce.launches == before + 4
    assert torch.equal(got, again)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["drop", "one_cell", "negated_drop", "runs"])
@pytest.mark.parametrize("width", [64, 4])
def test_suffix_segment_kernel_serving_shapes(dev, kind, width):
    """K7 at the sorted frontend's shapes, (102 400, 64) max and (102 400,
    4) sums, with a chain of whole-run tiles longer than the look-back's
    32-tile window (the drop run over 60% of the rows, one cell, the
    flipped negated stream whose drop run leads): equal to the plain
    version to the bit, f32 and bf16, and 20 calls give the same bits."""
    n = 102_400
    rng = np.random.default_rng(width)
    cells = np.sort(rng.integers(0, 10_000, n))
    if kind != "runs":
        cells[int(0.4 * n):] = 10_000
    if kind == "one_cell":
        cells[:] = 10_000
    if kind == "negated_drop":
        cells = np.flip(-cells)
    cell = torch.from_numpy(cells.astype(np.int32).copy()).to(dev)
    x = torch.from_numpy(rng.normal(size=(n, width)).astype(np.float32)).to(
        dev)
    op, types = (("max", (x, x.bfloat16())) if width == 64
                 else ("sum", (x,)))
    for xx in types:
        want = segment.suffix_segment_reduce_plain(xx, cell, op, 1)
        before = segment.suffix_segment_reduce.launches
        for _ in range(20):
            assert torch.equal(segment.suffix_segment_reduce(xx, cell, op, 1),
                               want)
        assert segment.suffix_segment_reduce.launches == before + 20


def _serving_cells(ncells, points, rng):
    """Run starts and counts of `points` rows over `ncells` cells as a
    served kitti_sem scan gives them: about a quarter of the cells
    occupied, a few far over the cap of 100."""
    occupied = rng.choice(ncells, ncells // 4, replace=False)
    counts = np.bincount(rng.choice(occupied, points), minlength=ncells)
    counts[occupied[:ncells // 500]] += 550
    starts = np.cumsum(counts) - counts
    return starts.astype(np.int32), counts.astype(np.int32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["kitti_sem", "infer_many_K16", "empty",
                                  "one_cell_cap", "one_cell_nocap"])
def test_scan_kernel_serving_shapes(dev, case, dtype):
    """K2 (one warp a cell) at kitti_sem's serving shape (10 000 cells,
    ~100 000 points, cap 100), at `infer_many`'s K=16 (160 000 cells), with
    every cell empty, and with one cell of 5 000 points under cap 100 and
    without a cap: tot, counts and smax equal to the plain version's."""
    rng = np.random.default_rng(7)
    ncells, points, cap = 10_000, 100_000, 100
    if case == "infer_many_K16":
        ncells, points = 160_000, 1_600_000
    starts, counts = _serving_cells(ncells, points, rng)
    if case == "empty":
        counts[:] = 0
    if case.startswith("one_cell"):
        counts[:] = 0
        counts[4321] = 5000
        starts[:] = 0
        cap = 100 if case == "one_cell_cap" else None
    pts = rng.normal(size=(max(int(counts.sum()), 1), 4)).astype(np.float32)
    pts[:, :3] *= 30
    mmat = rng.normal(size=(4, 64)).astype(np.float32)
    pts, starts, counts, mmat = (torch.from_numpy(a).to(dev)
                                 for a in (pts, starts, counts, mmat))
    before = affine.affine_scan_gather.launches
    tot, smax = affine.affine_scan_gather(pts, starts, counts, mmat, cap,
                                          dtype)
    assert affine.affine_scan_gather.launches == before + 1
    tot_p, smax_p = affine.affine_scan_gather_plain(pts, starts, counts,
                                                    mmat, cap, dtype)
    assert smax.dtype == dtype
    assert torch.equal(tot, tot_p)
    assert torch.equal(smax.float(), smax_p.float())


@pytest.mark.parametrize("width", [24, 100, 129])
def test_scan_kernel_channel_groups(dev, width):
    """K2 with fewer channels than a warp's 64, with two 64-channel groups,
    and with an odd count (no paired stores): equal to the plain version,
    bf16 and f32."""
    rng = np.random.default_rng(width)
    starts, counts = _serving_cells(2000, 20_000, rng)
    pts = torch.from_numpy(rng.normal(size=(int(counts.sum()), 5)).astype(
        np.float32) * 10).to(dev)
    mmat = torch.from_numpy(rng.normal(size=(5, width)).astype(
        np.float32)).to(dev)
    starts, counts = (torch.from_numpy(a).to(dev) for a in (starts, counts))
    for dtype in (torch.bfloat16, torch.float32):
        tot, smax = affine.affine_scan_gather(pts, starts, counts, mmat, 100,
                                              dtype)
        tot_p, smax_p = affine.affine_scan_gather_plain(pts, starts, counts,
                                                        mmat, 100, dtype)
        assert torch.equal(tot, tot_p)
        assert torch.equal(smax.float(), smax_p.float())


def test_sorted_engine_kernel_path_matches_plain_path(dev):
    """The sorted impl with K7 against its plain path (f32, TF32 off):
    the same elevation to the bit."""
    cfg = GndNetConfig(pc_range=(0.0, -8.0, -4.0, 16.0, 8.0, 4.0),
                       grid_range=(0.0, -8.0, 16.0, 8.0),
                       max_points_voxel=20, lidar_height=1.7,
                       fused_impl="sorted")
    eng = GroundInferenceEngine(cfg, init_state_dict(cfg, seed=0),
                                bucket=1024)
    scan = synthetic_scan(cfg, np.random.default_rng(0), 3000)
    padded = torch.from_numpy(eng._prepare(scan)[0])
    before = segment.suffix_segment_reduce.launches
    e1, _ = eng.run(padded)
    assert segment.suffix_segment_reduce.launches == before + 3
    e2, _ = eng.run(padded, reference=True)
    assert torch.equal(e1, e2)


@pytest.mark.parametrize("n", [1, 2, 255, 256, 4096, 4097, 70_000])
def test_sort2_kernel(dev, n):
    """K10 against its plain version and np.lexsort: full-range words with
    INT32_MAX / INT32_MIN and repeated lo, and the call site's (cell,
    iota) pairs."""
    rng = np.random.default_rng(n)
    full = rng.integers(-2**31, 2**31 - 1, (2, n), endpoint=True)
    full[0, ::3] = 2**31 - 1
    full[0, 1::5] = -2**31
    full[1, ::4] = full[1, 0]
    cells = np.stack([rng.integers(0, 62_502, n), np.arange(n)])
    for hi, lo in (full, cells):
        hi = hi.astype(np.int32)
        lo = lo.astype(np.int32)
        th, tl = torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev)
        before = sort.sort2_i32.launches
        got = sort.sort2_i32(th, tl)
        assert sort.sort2_i32.launches == before + 1
        want = sort.sort2_i32_plain(th, tl)
        order = np.lexsort((lo, hi))
        for g, w, ref in zip(got, want, (hi[order], lo[order])):
            assert torch.equal(g, w)
            np.testing.assert_array_equal(g.cpu().numpy(), ref)


def _radix_keys(case, rng):
    """K1's inputs: the kitti_sem packed keys (and with two indices
    swapped across CTAs), duplicates with both int32 extremes, a constant
    digit, short lengths, and both sides of the cluster radix sort's
    capacity."""
    if case.startswith("packed_102400"):
        # low 17 bits in order (their passes skipped), or out of order only
        # across the boundary of CTAs 0 and 1 (16 CTAs of 6400)
        index = np.arange(102_400)
        if case.endswith("swap"):
            index[[6399, 6400]] = index[[6400, 6399]]
        return rng.integers(0, 10_001, 102_400) * 131_072 + index
    if case == "extremes":
        x = rng.integers(-5, 5, 5000)
        x[rng.permutation(5000)[:120]] = np.repeat([2**31 - 1, -2**31], 60)
        return x
    if case == "constant_digit":
        return (rng.integers(-2**20, 2**20, 70_000) & ~0xFF00) | 0x3700
    n = {"limit": sort.RADIX_MAX_I32,
         "above_limit": sort.RADIX_MAX_I32 + 1}.get(case)
    n = int(case.split("_")[1]) if n is None else n
    return rng.integers(-2**31, 2**31 - 1, n, endpoint=True)


@pytest.mark.parametrize("case", ["packed_102400", "packed_102400_swap",
                                  "extremes",
                                  "constant_digit", "n_1", "n_2", "n_255",
                                  "n_257", "n_4097", "limit", "above_limit"])
def test_radix_sort_kernel(dev, case):
    """sort_i32 (the cluster radix kernel up to RADIX_MAX_I32 keys, the
    bitonic kernel above) against its plain version and torch.sort, one
    launch a call."""
    x = torch.from_numpy(_radix_keys(case, np.random.default_rng(5)).astype(
        np.int32)).to(dev)
    before = sort.sort_i32.launches
    got = sort.sort_i32(x)
    assert sort.sort_i32.launches == before + 1
    assert torch.equal(got, sort.radix_sort_plain(x)
                       if x.numel() <= sort.RADIX_MAX_I32
                       else sort.sort_i32_plain(x))
    assert torch.equal(got, torch.sort(x).values)


def _radix_pairs(case, rng):
    """K10's inputs: the fine_grid (cell, iota) pairs, negative hi,
    repeated lo, lo in order (its passes skipped) and out of order only
    across two CTAs, both int32 extremes, a constant digit, short lengths,
    and both sides of the capacity."""
    if case == "cells_102400":
        return rng.integers(0, 62_501, 102_400), np.arange(102_400)
    if case == "negative_hi_repeated_lo":
        return rng.integers(-2**31, 0, 50_000), rng.integers(-3, 3, 50_000)
    if case == "constant_digit":
        hi = (rng.integers(-2**20, 2**20, 30_000) & ~0xFF) | 0x5A
        return hi, rng.integers(0, 2**16, 30_000)
    if case == "sorted_lo_repeats":
        return (rng.integers(-2**31, 2**31 - 1, 60_000, endpoint=True),
                np.sort(rng.integers(-3000, 3000, 60_000)))
    if case == "cta_boundary_descent":
        # 102 400 pairs on 16 CTAs of 6400: lo in order but across the
        # boundary of CTAs 0 and 1, which only the key before a slice shows
        lo = np.arange(102_400)
        lo[[6399, 6400]] = lo[[6400, 6399]]
        return rng.integers(0, 62_501, 102_400), lo
    n = {"limit": sort.RADIX_MAX_PAIRS,
         "above_limit": sort.RADIX_MAX_PAIRS + 1}.get(case)
    n = int(case.split("_")[1]) if n is None else n
    words = rng.integers(-2**31, 2**31 - 1, (2, n), endpoint=True)
    words[0, ::3] = 2**31 - 1
    words[0, 1::5] = -2**31
    words[1, ::4] = words[1, 0]
    return words[0], words[1]


@pytest.mark.parametrize("case", ["cells_102400", "negative_hi_repeated_lo",
                                  "constant_digit", "sorted_lo_repeats",
                                  "cta_boundary_descent", "n_1", "n_2",
                                  "n_255", "n_257", "n_4097", "limit",
                                  "above_limit"])
def test_radix_sort2_kernel(dev, case):
    """sort2_i32 (the cluster radix kernel up to RADIX_MAX_PAIRS pairs, the
    bitonic kernel above) against its plain version and np.lexsort, one
    launch a call."""
    hi, lo = (w.astype(np.int32) for w in _radix_pairs(
        case, np.random.default_rng(6)))
    th, tl = torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev)
    before = sort.sort2_i32.launches
    got = sort.sort2_i32(th, tl)
    assert sort.sort2_i32.launches == before + 1
    want = (sort.radix_sort2_plain(th, tl) if hi.size <= sort.RADIX_MAX_PAIRS
            else sort.sort2_i32_plain(th, tl))
    order = np.lexsort((lo, hi))
    for g, w, ref in zip(got, want, (hi[order], lo[order])):
        assert torch.equal(g, w)
        np.testing.assert_array_equal(g.cpu().numpy(), ref)


def test_radix_capacity_and_refusal(dev):
    """The card schedules the cluster of 16 that ops/sort.py's capacities
    assume; the C entries refuse one key more, and the wrappers take no
    launch for an empty input."""
    cap = _ext.function("cluster_radix_sort_capacity")
    assert (cap(4), cap(8)) == (sort.RADIX_MAX_I32, sort.RADIX_MAX_PAIRS)
    n = sort.RADIX_MAX_PAIRS + 1
    x = torch.zeros(n, dtype=torch.int32, device=dev)
    out = torch.empty_like(x)
    stream = _ext.stream_ptr(x)
    assert _ext.function("cluster_radix_sort2_i32")(
        x.data_ptr(), x.data_ptr(), out.data_ptr(), out.data_ptr(), n,
        stream) != 0
    n = sort.RADIX_MAX_I32 + 1
    x = torch.zeros(n, dtype=torch.int32, device=dev)
    out = torch.empty_like(x)
    assert _ext.function("cluster_radix_sort_i32")(
        x.data_ptr(), out.data_ptr(), n, stream) != 0
    before = (sort.sort_i32.launches, sort.sort2_i32.launches)
    assert sort.sort_i32(x[:0]).numel() == 0
    assert sort.sort2_i32(x[:0], x[:0])[0].numel() == 0
    assert (sort.sort_i32.launches, sort.sort2_i32.launches) == before


def _k8_stream(dev, n, width, seed):
    """Sorted ids with a run over many tiles, the kept mask rank < 7 in
    column 3, mmat8 row 3 zero."""
    rng = np.random.default_rng(seed)
    cell = np.sort(rng.integers(0, n // 25 + 1, n))
    cell[n // 5:n // 2] = cell[n // 5]
    cell = np.sort(cell).astype(np.int32)
    rank = np.arange(n) - np.searchsorted(cell, cell, side="left")
    pts8 = np.zeros((n, 8), np.float32)
    pts8[:, :3] = rng.normal(size=(n, 3)) * 10
    pts8[:, 3] = rank < 7
    pts8[:, 4] = rng.uniform(size=n)
    mmat8 = (rng.normal(size=(8, width)) * 0.3).astype(np.float32)
    mmat8[3] = 0
    return tuple(torch.from_numpy(x).to(dev) for x in (cell, pts8, mmat8))


def _device_ops(fn) -> float:
    """Device operations one call of fn() enqueues, by torch.profiler over
    20 calls; again when a window's device records were dropped (as
    test_dmmat_kernel)."""
    from gndnet_tpu_torch.profile_serve import kernel_times
    fn()
    for _ in range(3):
        prof = kernel_times(fn, 20)
        if "device_ops_per_call" in prof:
            break
    return prof["device_ops_per_call"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_prefix", [None, 7])
@pytest.mark.parametrize("n,width", [(1024, 16), (20_480, 64),
                                     (70_144, 64)])
def test_affine_segment_scan_kernel(dev, dtype, max_prefix, n, width):
    """K8 against its plain version, which sums in the kernel's order:
    sums, counts and maxima equal to the bit, on the stream, on one cell
    throughout (every tile carried by the look-back) and with rows masked
    at random (a prefix can be the mask value, rounded in bf16); the same
    bits in 20 calls; one device operation a call."""
    cell, pts8, mmat8 = _k8_stream(dev, n, width, n + width)
    masked = pts8.clone()
    masked[torch.from_numpy(np.random.default_rng(n).random(n) < 0.1).to(
        dev), 3] = 0.0
    for c, p in ((cell, pts8), (torch.zeros_like(cell), pts8),
                 (cell, masked)):
        before = affine_aux.affine_segment_scan.launches
        got = affine_aux.affine_segment_scan(c, p, mmat8, out_dtype=dtype,
                                             chunk=128, max_prefix=max_prefix)
        again = [affine_aux.affine_segment_scan(c, p, mmat8,
                                                out_dtype=dtype, chunk=128)
                 for _ in range(19)]
        assert affine_aux.affine_segment_scan.launches == before + 20
        want = affine_aux.affine_segment_scan_plain(c, p, mmat8,
                                                    out_dtype=dtype,
                                                    chunk=128)
        for k, w in enumerate(want):
            assert got[k].dtype == w.dtype and torch.equal(got[k], w)
            assert all(torch.equal(got[k], a[k]) for a in again)
    assert round(_device_ops(lambda: affine_aux.affine_segment_scan(
        cell, pts8, mmat8, out_dtype=dtype, chunk=128))) == 1


@pytest.mark.parametrize("n,width", [(128, 6), (70_144, 128)])
def test_segment_broadcast_kernel(dev, n, width):
    """K9 against its plain version: equal to the bit (max is exact) on the
    stream and on one cell throughout; payload-at-start streams broadcast
    each run's payload; the same bits in 20 calls; one device operation a
    call."""
    rng = np.random.default_rng(n)
    cell = np.sort(rng.integers(0, n // 40 + 1, n))
    cell[n // 3:] = cell[-1]
    cell = torch.from_numpy(cell.astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.normal(size=(width, n)).astype(
        np.float32)).to(dev)
    starts = torch.ones(n, dtype=torch.bool, device=dev)
    starts[1:] = cell[1:] != cell[:-1]
    payload = torch.where(starts, vals, -3.0e38)
    before = affine_aux.segment_broadcast_t.launches
    for c, v in ((cell, vals), (cell, payload), (torch.zeros_like(cell),
                                                 vals)):
        got = affine_aux.segment_broadcast_t(c, v, chunk=128)
        assert torch.equal(got, affine_aux.segment_broadcast_t_plain(
            c, v, chunk=128))
        assert all(torch.equal(got, affine_aux.segment_broadcast_t(
            c, v, chunk=128)) for _ in range(19))
    assert affine_aux.segment_broadcast_t.launches == before + 60
    first = torch.searchsorted(cell, cell)
    assert torch.equal(affine_aux.segment_broadcast_t(cell, payload,
                                                      chunk=128),
                       payload[:, first])
    assert round(_device_ops(lambda: affine_aux.segment_broadcast_t(
        cell, vals, chunk=128))) == 1


def _fine_engine(dtype="float32", precision="highest"):
    from gndnet_tpu_torch.config import fine_grid_config
    cfg = fine_grid_config().replace(fused_impl="affine",
                                     compute_dtype=dtype,
                                     matmul_precision=precision)
    return cfg, GroundInferenceEngine(cfg, init_state_dict(cfg, seed=0))


def test_fine_grid_affine_engine_kernel_path_matches_plain_path(dev):
    """fine_grid served through 'affine' (K10, K3, K2) against its plain
    path at f32 with TF32 off: the same elevation to the bit."""
    cfg, eng = _fine_engine()
    scan = synthetic_scan(cfg, np.random.default_rng(0), 100_000)
    padded = torch.from_numpy(eng._prepare(scan)[0])
    before = (sort.sort2_i32.launches, sort.sort_i32.launches)
    with no_tf32(True):
        e1, l1 = eng.run(padded)
        assert (sort.sort2_i32.launches, sort.sort_i32.launches) == (
            before[0] + 1, before[1])
        e2, l2 = eng.run(padded, reference=True)
    assert torch.equal(e1, e2) and torch.equal(l1, l2)


@pytest.mark.parametrize("grid", ["16x16", "fine_grid"])
def test_infer_many_matches_infer(dev, grid):
    """Scans of one bucket through `infer_many`, one fused call at B=K (the
    batched sorts: no K1 or K10; K3 and K2 once), against per-scan
    `infer` (K1, or K10 on fine_grid, once per scan), f32 with TF32 off:
    the batched canvas equal to the per-scan ones."""
    if grid == "fine_grid":
        cfg, eng = _fine_engine()
        sizes, pair_sort = (100_000, 99_000), sort.sort2_i32
    else:
        cfg = GndNetConfig(pc_range=(0.0, -8.0, -4.0, 16.0, 8.0, 4.0),
                           grid_range=(0.0, -8.0, 16.0, 8.0),
                           max_points_voxel=20, lidar_height=1.7,
                           fused_impl="affine")
        eng = GroundInferenceEngine(cfg, init_state_dict(cfg, seed=0),
                                    bucket=1024)
        sizes, pair_sort = (3100, 3500, 4000), sort.sort_i32
    rng = np.random.default_rng(1)
    scans = [synthetic_scan(cfg, rng, n) for n in sizes]
    counted = (sort.sort_i32, sort.sort2_i32, affine.cell_histogram,
               affine.affine_scan_gather)
    with no_tf32(True):
        before = [fn.launches for fn in counted]
        many = eng.infer_many(scans)
        assert [fn.launches - b for fn, b in zip(counted, before)] == \
            [0, 0, 1, 1]
        before = pair_sort.launches
        ones = [eng.infer(s) for s in scans]
        assert pair_sort.launches == before + len(scans)
    pts = eng.device_points(torch.from_numpy(np.stack(
        [eng._prepare(s)[0] for s in scans])))
    with torch.no_grad():
        assert torch.equal(eng.model.canvas(pts), torch.cat(
            [eng.model.canvas(p[None]) for p in pts]))
    # the canvases are equal; cuDNN may convolve a batch in another order
    # than one scan, and the SegNet's max-pool argmax routing can turn
    # that into up to 1e-2 of elevation (chip_smoke.py's IMPL_ELEV_ATOL)
    for (eb, lb), (e1, l1) in zip(many, ones):
        np.testing.assert_allclose(eb, e1, rtol=0, atol=1e-2)
        assert lb.shape == l1.shape and lb.dtype == np.int8


@pytest.mark.parametrize("impl", ["affine", "sorted"])
def test_aot_graph_replays_match_eager(dev, impl, tmp_path):
    """aot_load captures one CUDA graph of `run` for the artifact's bucket
    shape: replays of it (no wrapper counts them) give the eager `run`'s
    bits, `infer` / `infer_pipelined` / `StreamingEngine` serve through it,
    and a scan of another bucket runs eagerly (its kernels counted)."""
    from gndnet_tpu_torch.infer import StreamingEngine

    cfg = GndNetConfig(pc_range=(0.0, -8.0, -4.0, 16.0, 8.0, 4.0),
                       grid_range=(0.0, -8.0, 16.0, 8.0),
                       max_points_voxel=20, lidar_height=1.7,
                       fused_impl=impl, compute_dtype="bfloat16",
                       matmul_precision="default")
    sd = init_state_dict(cfg, seed=0)
    eager = GroundInferenceEngine(cfg, sd, bucket=1024)
    path = str(tmp_path / "engine.aot")
    assert eager.aot_save(path, n=3000) > 0
    served = GroundInferenceEngine(cfg, sd, bucket=1024)
    served.aot_load(path)
    shape, graph = served._graph
    assert shape == (3072, 4) and graph is not None
    rng = np.random.default_rng(2)
    scans = [synthetic_scan(cfg, rng, n) for n in (3000, 2500, 3072)]
    counter, per_scan = ((sort.sort_i32, 1) if impl == "affine"
                         else (segment.suffix_segment_reduce, 3))
    before = counter.launches
    for scan in scans:
        padded = torch.from_numpy(eager._prepare(scan)[0]).to(dev)
        e1, l1 = eager.run(padded)
        e2, l2 = served._dispatch(padded)
        assert torch.equal(e1, e2) and torch.equal(l1, l2)
        e3, l3 = served.infer(scan)
        assert np.array_equal(e3, e1.cpu().numpy())
        assert np.array_equal(l3, l1[:len(scan)].cpu().numpy())
    assert counter.launches == before + per_scan * len(scans)   # eager only
    assert graph.replays == 2 * len(scans)
    piped = list(served.infer_pipelined(scans, depth=2))
    assert all(np.array_equal(a[0], b[0]) for a, b in
               zip(piped, map(served.infer, scans)))
    before = counter.launches
    other = served.infer(synthetic_scan(cfg, rng, 5000))      # 5120 rows
    assert counter.launches > before and other[1].shape == (5000,)
    srv = StreamingEngine(served, warmup=False,
                          use_native_mailbox=False).start()
    try:
        seq = srv.submit(scans[0])
        for _ in range(2000):
            if srv.latest() is not None and srv.latest()[0] == seq:
                break
            time.sleep(0.005)
        assert srv.errors == 0
        assert np.array_equal(srv.latest()[1], served.infer(scans[0])[0])
    finally:
        srv.stop()


def test_binning_on_the_card_equals_the_cpu(dev):
    """Cell ids and grid indices on the card equal the CPU's (IEEE float32
    division, as the JAX package bins) on fine_grid's 0.4 m cells, where
    division by a Python scalar, a product with its reciprocal on the
    card, moved points on cell edges into the next cell."""
    from gndnet_tpu_torch.config import fine_grid_config
    from gndnet_tpu_torch.ops import pillarize as pz
    from gndnet_tpu_torch.ops.postproc import _cell_indices

    cfg = fine_grid_config()
    geom = pz.PillarGeometry.from_config(cfg)
    for seed in range(6):
        scan = torch.from_numpy(synthetic_scan(cfg, np.random.default_rng(
            seed), 100_000))
        cpu, card = pz.bin_points(scan, geom), pz.bin_points(scan.to(dev),
                                                             geom)
        assert torch.equal(card.cell.cpu(), cpu.cell)
        for a, b in zip(_cell_indices(scan.to(dev), cfg.grid_range,
                                      cfg.voxel_size[0]),
                        _cell_indices(scan, cfg.grid_range,
                                      cfg.voxel_size[0])):
            assert torch.equal(a.cpu(), b)
