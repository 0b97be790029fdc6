"""The port's reference-style pillar path against the JAX package on the
CPU: pillar binning (`count_and_rank`, `pillarize`, `pillarize_batch`),
decoration, the flat-stream canvas and the pillar scatter, then
`GroundEstimatorNet.forward` against JAX's `apply` on the same pillars,
and against the port's own fused 'scatter' path.

Tolerances: ranks, counts, pillars, coordinates, masks and scattered
canvases identical; decorated features and flat canvases within 1e-6
(another summation order of the cell means); the forward's elevation and
updated running statistics within 1e-5 of their scale; the pillar path
against the fused path at the JAX package's own rtol / atol 1e-5, 1e-4
with use_norm (tests/test_models.py:184-213)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu.checkpoint import import_torch_state_dict
from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.models.gndnet import GroundEstimatorNet as JaxNet
from gndnet_tpu.ops import pillarize as jpz
from gndnet_tpu.ops.scatter import scatter_pillars_to_canvas as jscatter
from gndnet_tpu_torch import native
from gndnet_tpu_torch.models.gndnet import GroundEstimatorNet
from gndnet_tpu_torch.ops import pillarize as pz
from gndnet_tpu_torch.ops.scatter import scatter_pillars_to_canvas
from gndnet_tpu_torch.weights import init_state_dict, state_dict_from_flax
from oracles import voxelize_oracle
from test_torch_train import SMALL, _close_to_scale

# tests/test_pillarize.py's grid, and one of two z layers
GEOMS = {"nz1": ((0.0, 0.0, -4.0, 8.0, 8.0, 4.0), (1.0, 1.0, 8.0), (8, 8, 1)),
         "nz2": ((0.0, 0.0, -4.0, 8.0, 8.0, 4.0), (1.0, 1.0, 4.0), (8, 8, 2))}
DECOR_TOL = 1e-6
FORWARD_SHARE = 1e-5


def _geoms(name):
    args = GEOMS[name]
    return jpz.PillarGeometry(*args), pz.PillarGeometry(*args)


def _cloud(rng, n=500, f=4, lo=(-1, -1, -5), hi=(9, 9, 5)):
    """tests/test_pillarize.py's cloud: uniform in and around the box."""
    pts = rng.uniform(size=(n, f)).astype(np.float32)
    pts[:, :3] = pts[:, :3] * (np.array(hi) - np.array(lo)) + np.array(lo)
    return pts


def _equal(got, want):
    for name in want._fields:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=name)


# --- binning ----------------------------------------------------------------

@pytest.mark.parametrize("geom", sorted(GEOMS))
@pytest.mark.parametrize("cap", [1, 3, 5])
def test_count_and_rank_matches_jax(geom, cap):
    jgeom, geom = _geoms(geom)
    pts = _cloud(np.random.default_rng(cap))
    pts[:60:2] = pts[1:61:2]                      # repeated points
    want = jpz.count_and_rank(jpz.bin_points(jnp.asarray(pts), jgeom), cap)
    got = pz.count_and_rank(pz.bin_points(torch.from_numpy(pts), geom), cap)
    _equal(got, want)


# (cloud, max_points, max_voxels): over-full cells, max_voxels below the
# occupied count (tests/test_pillarize.py:78, :193), more slots than cells
# + 1, every point out of range
CASES = {"roomy": ("uniform", 5, 64), "cap2": ("uniform", 2, 64),
         "voxels8": ("uniform", 5, 8), "voxels4": ("flat", 8, 4),
         "padded": ("uniform", 5, 80), "invalid": ("invalid", 5, 16)}


def _case_cloud(kind, rng):
    if kind == "flat":
        return _cloud(rng, n=200, lo=(0, 0, -1), hi=(8, 8, 1))
    if kind == "invalid":
        return np.full((10, 4), 100.0, np.float32)
    return _cloud(rng)


@pytest.mark.parametrize("geom", sorted(GEOMS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_pillarize_matches_jax_and_oracles(geom, case):
    """Array-equal to JAX's `pillarize`; its pillars also equal
    tests/oracles.py's and the port's native voxelizer's (the reference's
    sequential loop with the capacity semantics both packages keep)."""
    kind, cap, nvox = CASES[case]
    jgeom, geom = _geoms(geom)
    pts = _case_cloud(kind, np.random.default_rng(7))
    want = jpz.pillarize(jnp.asarray(pts), jgeom, cap, nvox)
    got = pz.pillarize(torch.from_numpy(pts), geom, cap, nvox)
    _equal(got, want)
    n = int(got.n_pillars)
    ctx = pz.bin_points(torch.from_numpy(pts), geom)
    assert n == min(len(torch.unique(ctx.cell[ctx.valid])), nvox)
    for ov, oc, on in (
            voxelize_oracle(pts, geom.voxel_size, geom.pc_range, cap, nvox,
                            reference_break=False),
            native.voxelize(pts, geom.voxel_size, geom.pc_range, cap, nvox,
                            reference_break=False)):
        assert ov.shape[0] == n
        np.testing.assert_array_equal(got.coors[:n].numpy(), oc)
        np.testing.assert_array_equal(got.num_points[:n].numpy(), on)
        np.testing.assert_array_equal(got.voxels[:n].numpy(), ov)
    assert not got.voxels[n:].any() and not got.mask[n:].any()


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_pillarize_batch_matches_jax(geom):
    """JAX's vmap of `pillarize`: each scan's slots start at 0 in its own
    first-touch order; an all-invalid scan and one over capacity."""
    jgeom, geom = _geoms(geom)
    rng = np.random.default_rng(3)
    pts = np.stack([_cloud(rng), _cloud(rng), _cloud(rng)])
    pts[1, 100:] = 1e9
    pts[2] = 1e9
    for cap, nvox in ((5, 64), (3, 6)):
        want = jpz.pillarize_batch(jnp.asarray(pts), jgeom, cap, nvox)
        got = pz.pillarize_batch(torch.from_numpy(pts), geom, cap, nvox)
        _equal(got, want)
        for b in range(3):
            _equal(pz.pillarize(torch.from_numpy(pts[b]), geom, cap, nvox),
                   jax.tree_util.tree_map(lambda x: x[b], want))


# --- decoration and canvases ------------------------------------------------

@pytest.mark.parametrize("geom", sorted(GEOMS))
@pytest.mark.parametrize("with_distance", [False, True])
def test_decorate_pillars_matches_jax(geom, with_distance):
    """(M, P, F) and (B, M, P, F) pillars, within 1e-6."""
    jgeom, geom = _geoms(geom)
    rng = np.random.default_rng(11)
    pts = np.stack([_cloud(rng), _cloud(rng)])
    pb = jpz.pillarize_batch(jnp.asarray(pts), jgeom, 5, 64)
    xy = pb.coors[..., jnp.array([2, 1])]
    want = jpz.decorate_pillars(pb.voxels, pb.num_points, xy, jgeom, 5,
                                with_distance)
    t = lambda x: torch.from_numpy(np.array(x))
    got = pz.decorate_pillars(t(pb.voxels), t(pb.num_points), t(xy), geom,
                              5, with_distance)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=DECOR_TOL,
                               atol=DECOR_TOL)
    one = pz.decorate_pillars(t(pb.voxels[0]), t(pb.num_points[0]),
                              t(xy[0]), geom, 5, with_distance)
    np.testing.assert_allclose(one.numpy(), np.asarray(want[0]),
                               rtol=DECOR_TOL, atol=DECOR_TOL)


@pytest.mark.parametrize("with_distance", [False, True])
def test_decorate_points_and_scatter_max_canvas_match_jax(with_distance):
    jgeom, geom = _geoms("nz1")
    rng = np.random.default_rng(5)
    pts = np.stack([_cloud(rng), _cloud(rng)])
    jctx = jpz.bin_points_batch(jnp.asarray(pts), jgeom)
    ctx = pz.bin_points_batch(torch.from_numpy(pts), geom)
    jranks, ranks = jpz.count_and_rank(jctx, 3), pz.count_and_rank(ctx, 3)
    flat = pts.reshape(-1, 4)
    want, wkept = jpz.decorate_points(jnp.asarray(flat), jctx, jranks, jgeom,
                                      with_distance)
    got, kept = pz.decorate_points(torch.from_numpy(flat), ctx, ranks, geom,
                                   with_distance)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(wkept))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=DECOR_TOL, atol=DECOR_TOL)
    feats = rng.normal(size=(flat.shape[0], 6)).astype(np.float32)
    floor = np.abs(rng.normal(size=6)).astype(np.float32)
    for pad in (None, floor):
        want = jpz.scatter_max_canvas(
            jnp.asarray(feats), jctx, jranks, jgeom, 3,
            None if pad is None else jnp.asarray(pad))
        got = pz.scatter_max_canvas(
            torch.from_numpy(feats), ctx, ranks, geom, 3,
            None if pad is None else torch.from_numpy(pad))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=DECOR_TOL, atol=DECOR_TOL)
    _, geom2 = _geoms("nz2")
    ctx2 = pz.bin_points_batch(torch.from_numpy(pts), geom2)
    with pytest.raises(ValueError, match="nz == 1"):
        pz.scatter_max_canvas(torch.from_numpy(feats), ctx2,
                              pz.count_and_rank(ctx2, 3), geom2, 3)


def _one_layer_cloud(rng, n=500):
    """nz = 2 with one pillar per 2-D cell: a cell's points all lie in the
    z layer its (x + y) parity picks."""
    pts = _cloud(rng, n, lo=(0, 0, 0), hi=(8, 8, 1))
    parity = (np.floor(pts[:, 0]) + np.floor(pts[:, 1])) % 2
    pts[:, 2] = np.where(parity == 0, -2.0, 2.0) + pts[:, 2] - 0.5
    return pts


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_scatter_pillars_to_canvas_matches_jax(geom):
    jgeom, geom = _geoms(geom)
    rng = np.random.default_rng(9)
    pts = np.stack([_one_layer_cloud(rng), _one_layer_cloud(rng)])
    pts[1, 300:] = 1e9
    pb = jpz.pillarize_batch(jnp.asarray(pts), jgeom, 5, 64)
    feats = rng.normal(size=(2, 64, 7)).astype(np.float32)
    want = jscatter(jnp.asarray(feats), pb.coors, pb.mask, geom.ny, geom.nx)
    got = scatter_pillars_to_canvas(
        torch.from_numpy(feats), torch.from_numpy(np.array(pb.coors)),
        torch.from_numpy(np.array(pb.mask)), geom.ny, geom.nx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the forward ------------------------------------------------------------

def _model_cfgs(use_norm, vfe, nz=1):
    kw = dict(SMALL, use_norm=use_norm, vfe_filters=vfe, fused_impl="scatter")
    if nz == 2:
        kw["voxel_size"] = (1.0, 1.0, 4.0)
    return JaxConfig(**kw), kw


def _random_state_dict(cfg, seed):
    """`init_state_dict` with batch-norm statistics away from (0, 1)."""
    rng = np.random.default_rng(seed)
    sd = init_state_dict(cfg, seed=seed)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            sd[k] = torch.from_numpy(rng.normal(0, 0.1, v.shape)
                                     .astype(np.float32))
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape)
                                     .astype(np.float32))
    return sd


def _labelled_points(rng, b=2, n=600, nz=1):
    if nz == 2:
        return np.stack([_one_layer_cloud(rng, n) * np.array(
            [2, 2, 1, 1], np.float32) - np.array([0, 8, 0, 0], np.float32)
            for _ in range(b)])
    pts = np.zeros((b, n, 4), np.float32)
    pts[..., 0] = rng.uniform(0, 16, (b, n))
    pts[..., 1] = rng.uniform(-8, 8, (b, n))
    pts[..., 2] = 0.05 * pts[..., 0] - 0.5 + rng.normal(0, 0.02, (b, n))
    pts[..., 3] = rng.uniform(0, 1, (b, n))
    pts[:, :40, :3] = pts[:, :1, :3]               # a cell over the cap
    return pts


FORWARDS = {"plain_64": (False, (64,), 1), "norm_64": (True, (64,), 1),
            "plain_32_64": (False, (32, 64), 1),
            "norm_32_64": (True, (32, 64), 1),
            "norm_32_64_nz2": (True, (32, 64), 2)}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", sorted(FORWARDS))
def test_forward_matches_jax(case, train):
    """`forward` against JAX's `apply(variables, voxels, coors, num_points,
    mask, train)` on the same pillars: the elevation, and in training the
    updated running statistics, within 1e-5 of their scale."""
    use_norm, vfe, nz = FORWARDS[case]
    jcfg, kw = _model_cfgs(use_norm, vfe, nz)
    from gndnet_tpu_torch.config import GndNetConfig

    cfg = GndNetConfig(**kw)
    assert cfg.nz == nz
    sd = _random_state_dict(cfg, seed=len(case))
    variables = import_torch_state_dict(sd, jcfg)
    pts = _labelled_points(np.random.default_rng(21), nz=nz)
    pb = jpz.pillarize_batch(jnp.asarray(pts),
                             jpz.PillarGeometry.from_config(jcfg),
                             jcfg.max_points_voxel, jcfg.max_voxels)
    out = JaxNet(jcfg).apply(variables, pb.voxels, pb.coors, pb.num_points,
                             pb.mask, train=train,
                             mutable=["batch_stats"] if train else False)
    want, mut = out if train else (out, None)
    model = GroundEstimatorNet(cfg, device="cpu")
    model.load_state_dict(sd)
    t = lambda x: torch.from_numpy(np.array(x))
    got = model(t(pb.voxels), t(pb.coors), t(pb.num_points), t(pb.mask),
                train=train)
    assert got.requires_grad == train
    _close_to_scale(got.detach().numpy(), np.asarray(want), FORWARD_SHARE,
                    "elevation")
    if train:
        stats = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, {
            "params": variables["params"],
            "batch_stats": mut["batch_stats"]}), cfg)
        moved = model.state_dict()
        for name, w in stats.items():
            if "running" in name:
                assert not torch.equal(w, sd[name]), name
                _close_to_scale(moved[name].numpy(), w.numpy(),
                                FORWARD_SHARE, name)


@pytest.mark.parametrize("use_norm", [False, True])
def test_pillar_path_matches_fused_path(use_norm):
    """JAX's test_fused_path_matches_pillar_path[_use_norm] on the port:
    `forward` on `pillarize_batch` against `fused` through 'scatter'."""
    from gndnet_tpu_torch.config import GndNetConfig

    cfg = GndNetConfig(**_model_cfgs(use_norm, (64,))[1])
    model = GroundEstimatorNet(cfg, device="cpu")
    model.load_state_dict(_random_state_dict(cfg, seed=3))
    pts = torch.from_numpy(_labelled_points(np.random.default_rng(4)))
    pb = pz.pillarize_batch(pts, model.geom, cfg.max_points_voxel,
                            cfg.max_voxels)
    ref = model(pb.voxels, pb.coors, pb.num_points, pb.mask)
    tol = 1e-4 if use_norm else 1e-5
    np.testing.assert_allclose(model.fused(pts).numpy(), ref.numpy(),
                               rtol=tol, atol=tol)


def test_amax_splits_tied_gradients_like_jax():
    """The pillar max's gradient splits evenly among tied rows, as
    `jnp.max`'s does (not to one row, as `torch.max(dim)` sends it)."""
    x = np.array([[[1.0], [1.0], [0.0]]], np.float32)
    want = jax.grad(lambda v: jnp.max(v, axis=1).sum())(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    torch.amax(t, dim=1).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
