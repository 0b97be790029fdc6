"""The port's multi-process parallelism against the JAX package on the CPU.

The port's ranks are spawned processes over gloo (`parallel.multihost.
spawn`, a `file://` rendezvous under tmp_path, one intra-op thread each);
they import no JAX.  The oracle runs in this process: the JAX package's
`make_dp_*`, `make_spatial_infer` and tp rule on its 8 virtual CPU devices
(tests/conftest.py), from the same weights (the port's state dict through
`gndnet_tpu.checkpoint.import_torch_state_dict`).  The configuration is
tests/test_parallel.py's: 16x16 cells, 512-point scans, at most 16 points
a cell, batch 4.

Tolerances, as the JAX package's own tests hold its mesh against one
device: inference rtol 1e-4 / atol 1e-5 (dp inference and tp 1e-5 /
1e-6); a train step's loss rel 1e-5, parameters rtol 1e-3 / atol 1e-5,
batch-norm statistics rtol 1e-4 / atol 1e-6.  The single-device port step
that a mesh step is held against runs on one thread here, as the ranks do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gndnet_tpu import train as jtrain
from gndnet_tpu.checkpoint import import_torch_state_dict
from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.models.gndnet import GroundEstimatorNet as JaxNet
from gndnet_tpu.parallel import mesh as jmesh
from gndnet_tpu.parallel import spatial as jspatial
from gndnet_tpu.parallel import tp as jtp
from gndnet_tpu_torch import train
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.models.gndnet import GroundEstimatorNet
from gndnet_tpu_torch.parallel import multihost, spatial, tp
from gndnet_tpu_torch.weights import init_state_dict, state_dict_from_flax

JOBS = "gndnet_tpu_torch.parallel.rank_jobs:"
CFG = dict(pc_range=(0.0, -8.0, -4.0, 16.0, 8.0, 4.0),
           grid_range=(0.0, -8.0, 16.0, 8.0), voxel_size=(1.0, 1.0, 8.0),
           max_points_voxel=16, max_voxels=256, input_features=4,
           batch_size=4, use_norm=False, lr=0.05)
INFER_RTOL, INFER_ATOL = 1e-4, 1e-5
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-5
STAT_RTOL, STAT_ATOL = 1e-4, 1e-6


def _configs(**kw):
    kw = {**CFG, **kw}
    return JaxConfig(**kw), GndNetConfig(**kw)


def batch(rng, cfg=None, b=4, n=512):
    """tests/test_parallel.py's batch: a sloped plane and its heights."""
    cfg = cfg or GndNetConfig(**CFG)
    pts = np.zeros((b, n, 4), np.float32)
    pts[..., 0] = rng.uniform(cfg.pc_range[0] + 0.2, cfg.pc_range[3] - 0.2,
                              (b, n))
    pts[..., 1] = rng.uniform(cfg.pc_range[1] + 0.2, cfg.pc_range[4] - 0.2,
                              (b, n))
    pts[..., 2] = 0.05 * pts[..., 0] - 0.5 + rng.normal(0, 0.05, (b, n))
    labels = np.zeros((b, cfg.ny, cfg.nx), np.float32)
    labels[:] = (0.05 * (np.arange(cfg.nx) + 0.5) - 0.5)[None, None, :]
    return pts, labels


def weights(cfg, seed=0) -> dict:
    """Seeded weights with batch-norm statistics away from (0, 1), so eval
    mode does not normalise by the identity."""
    sd = init_state_dict(cfg, seed)
    rng = np.random.default_rng(seed + 100)
    for name, t in sd.items():
        if name.endswith("running_mean"):
            t.copy_(torch.from_numpy(rng.normal(0, 0.2, t.shape)))
        elif name.endswith("running_var"):
            t.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, t.shape)))
    return sd


def jax_variables(sd, jcfg):
    return jax.tree_util.tree_map(jnp.asarray,
                                  import_torch_state_dict(sd, jcfg))


def jax_state(sd, jcfg):
    """JAX's TrainState at step 0 holding the port's weights."""
    v = jax_variables(sd, jcfg)
    tx = jtrain.make_optimizer(jcfg, 10)
    return JaxNet(jcfg), tx, jtrain.TrainState(
        step=jnp.asarray(0, jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]))


def jax_state_dict(state, cfg) -> dict:
    return state_dict_from_flax(jax.tree_util.tree_map(np.array, {
        "params": state.params, "batch_stats": state.batch_stats}), cfg)


def single_step(cfg, sd, pts, labels, steps=1):
    """The port's single-device step on the whole batch, one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state = train.create_train_state(cfg, 10, state_dict=sd,
                                         device="cpu")
        step = train.make_train_step(cfg)
        losses = [float(step(state, pts, labels)[1]) for _ in range(steps)]
    finally:
        torch.set_num_threads(threads)
    return losses, state.model.state_dict()


def assert_state_close(got: dict, want: dict, what: str) -> None:
    """Parameters at PARAM_*, batch-norm statistics at STAT_*."""
    for name, w in want.items():
        if not w.is_floating_point():
            continue
        stat = "running" in name
        np.testing.assert_allclose(
            got[name].numpy(), w.numpy(),
            rtol=STAT_RTOL if stat else PARAM_RTOL,
            atol=STAT_ATOL if stat else PARAM_ATOL, err_msg=f"{what} {name}")


def spawn(tmp_path, job, world, **kwargs):
    return multihost.spawn(JOBS + job, world, kwargs=kwargs, device="cpu",
                           workdir=str(tmp_path / job), timeout=300)


def gathered(results, dp):
    """The global (B, ny, nx) from the ranks' dp shards (sp index 0), after
    checking that the sp ranks of every dp row agree exactly."""
    rows = {}
    for r in results:
        if r["dp"] in rows:
            assert torch.equal(rows[r["dp"]], r["out"])
        rows[r["dp"]] = r["out"]
    return torch.cat([rows[i] for i in range(dp)]).numpy()


# --- inference ----------------------------------------------------------------

def test_spatial_infer_dp2_sp4_matches_jax(tmp_path):
    """make_spatial_infer on a dp=2 x sp=4 mesh of 8 ranks against JAX's
    make_spatial_infer on 8 devices and the port's unsharded forward."""
    jcfg, cfg = _configs()
    sd = weights(cfg)
    pts, _ = batch(np.random.default_rng(9))
    got = gathered(spawn(tmp_path, "infer_job", 8, cfg=cfg, state_dict=sd,
                         points=pts, dp=2, sp=4), 2)
    mesh = jmesh.make_mesh(dp=2, sp=4)
    want = jspatial.make_spatial_infer(jcfg, mesh)(
        jmesh.replicate(mesh, jax_variables(sd, jcfg)),
        jmesh.shard_batch(mesh, jnp.asarray(pts)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=INFER_RTOL,
                               atol=INFER_ATOL)
    model = GroundEstimatorNet(cfg, device="cpu")
    model.load_state_dict(sd)
    np.testing.assert_allclose(got, model.fused(torch.from_numpy(pts)),
                               rtol=INFER_RTOL, atol=INFER_ATOL)


def test_dp_infer_and_eval_dp4_match_jax(tmp_path):
    """make_dp_infer and make_dp_eval_step at dp=4 against JAX's."""
    jcfg, cfg = _configs()
    sd = weights(cfg)
    pts, labels = batch(np.random.default_rng(8))
    results = spawn(tmp_path, "infer_job", 4, cfg=cfg, state_dict=sd,
                    points=pts, labels=labels, dp=4, sp=1)
    mesh = jmesh.make_mesh(dp=4, sp=1)
    model, _, state = jax_state(sd, jcfg)
    want = jmesh.make_dp_infer(model, jcfg, mesh)(
        jmesh.replicate(mesh, jax_variables(sd, jcfg)),
        jmesh.shard_batch(mesh, jnp.asarray(pts)))
    np.testing.assert_allclose(gathered(results, 4), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    loss = jmesh.make_dp_eval_step(model, jcfg, mesh)(
        jmesh.replicate(mesh, state),
        *jmesh.shard_batch(mesh, (jnp.asarray(pts), jnp.asarray(labels))))
    for r in results:
        assert r["eval"] == pytest.approx(float(loss), rel=LOSS_RTOL)


# --- training -----------------------------------------------------------------

@pytest.mark.parametrize("beta", [0.0, 0.1])
def test_dp2_train_step_matches_single_device_and_jax(tmp_path, beta):
    """One dp=2 step (sync-BN over dp, gradients averaged) against the
    port's single-device step on the concatenated batch and JAX's
    make_dp_train_step; both ranks end with the same bits.

    The parameters are held at beta=0 (no smoothness term).  The map is
    flat where the canvas is empty, so second differences there are
    rounding noise around 0 and |.|'s gradient takes their sign: at
    beta=0.1 this batch's down2.conv2 weight lands 1.39x the tolerance
    from the single-device step, and JAX's own dp step lands as far from
    JAX's single-device step (the port's dp step agrees with JAX's
    single-device one, and vice versa).  At beta=0.1 the loss is held."""
    jcfg, cfg = _configs(beta=beta)
    sd = weights(cfg)
    pts, labels = batch(np.random.default_rng(7))
    results = spawn(tmp_path, "train_job", 2, cfg=cfg, state_dict=sd,
                    points=pts, labels=labels, dp=2, sp=1)
    got = results[0]["state_dict"]
    for k, v in results[1]["state_dict"].items():
        assert torch.equal(v, got[k]), k
    assert results[0]["losses"] == results[1]["losses"]

    losses, single = single_step(cfg, sd, pts, labels)
    assert results[0]["losses"][0] == pytest.approx(losses[0], rel=LOSS_RTOL)
    if beta:
        return
    assert_state_close(got, single, "vs the single-device step:")

    mesh = jmesh.make_mesh(dp=2, sp=1)
    model, tx, state = jax_state(sd, jcfg)
    state, loss = jmesh.make_dp_train_step(model, tx, jcfg, mesh)(
        jmesh.replicate(mesh, state),
        *jmesh.shard_batch(mesh, (jnp.asarray(pts), jnp.asarray(labels))))
    assert results[0]["losses"][0] == pytest.approx(float(loss),
                                                    rel=LOSS_RTOL)
    assert_state_close(got, jax_state_dict(state, cfg), "vs JAX's dp step:")


def test_halo_exchange_gradient_matches_unsharded_conv(tmp_path):
    """The sharded 3x3 conv over 4 ranks' slabs (halo_exchange forward and
    backward) against the unsharded SAME conv and its autograd gradients:
    the slabs' input gradient, and the parameter gradients summed over
    ranks."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 3, 16, 5)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(4, 3, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(4,)).astype(np.float32))
    probe = torch.from_numpy(rng.normal(size=(2, 4, 16, 5))
                             .astype(np.float32))
    res = spawn(tmp_path, "halo_job", 4, x=x, weight=w, bias=b, probe=probe)
    xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
    out = F.conv2d(xr, wr, br, padding=1)
    (out * probe).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.cat([r["out"] for r in res], 2),
                               out.detach(), **tol)
    np.testing.assert_allclose(torch.cat([r["grad"] for r in res], 2),
                               xr.grad, **tol)
    np.testing.assert_allclose(sum(r["grad_w"] for r in res), wr.grad, **tol)
    np.testing.assert_allclose(sum(r["grad_b"] for r in res), br.grad, **tol)
    # edge ranks see zeros beyond the image; interior ones their neighbours
    assert torch.equal(res[1]["out"], out.detach()[:, :, 4:8])


def test_halo_exchange_on_one_rank_is_zero_padding():
    x = torch.arange(24.0).reshape(1, 2, 3, 4)
    y = spatial.halo_exchange(x, None)
    assert y.shape == (1, 2, 5, 4)
    assert torch.equal(y[:, :, 1:4], x)
    assert not y[:, :, 0].any() and not y[:, :, 4].any()


@pytest.mark.parametrize("ny,sp,hl", [(100, 4, 28), (100, 1, 100),
                                      (250, 2, 128), (10, 2, 8), (10, 4, 4)])
def test_slab_height(ny, sp, hl):
    """tests/test_parallel.py::test_slab_height's cases, and JAX's."""
    assert spatial.slab_height(ny, sp) == hl == jspatial.slab_height(ny, sp)


def test_spatial_constraint_errors():
    """use_norm cannot be sharded over sp; the checks come before any
    process group is needed, as in JAX."""
    _, cfg = _configs(use_norm=True)
    with pytest.raises(ValueError, match="use_norm"):
        spatial.make_spatial_infer(cfg, None)
    with pytest.raises(ValueError, match="use_norm"):
        spatial.make_spmd_train_step(cfg, None)
    with pytest.raises(ValueError, match="use_norm"):
        train.train_and_evaluate(cfg, sp=2, device="cpu")
    with pytest.raises(ValueError, match="divide by dp=3"):
        train.train_and_evaluate(cfg.replace(use_norm=False), dp=3,
                                 device="cpu")
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        train.train_and_evaluate(cfg.replace(use_norm=False), dp=2,
                                 device="cpu")


# --- tensor parallelism ---------------------------------------------------------

def _sharded_names(jcfg, cfg, sd, size):
    """The state-dict names of the leaves JAX's tp rule shards over `size`
    devices."""
    variables = jax_variables(sd, jcfg)
    mesh = jtp.make_tp_mesh(tp=size)
    specs = jtp.tp_variable_specs(variables, mesh)
    marks = jax.tree_util.tree_map(
        lambda x, s: np.full(x.shape, float(any(a is not None
                                                for a in s.spec))),
        variables, specs)
    return {k for k, v in state_dict_from_flax(marks, cfg).items()
            if bool(v.all())}


@pytest.mark.parametrize("size", [8, 4])
def test_tp_rule_shards_the_leaves_jax_shards(size):
    jcfg, cfg = _configs()
    sd = GroundEstimatorNet(cfg, device="cpu").state_dict()
    specs = tp.tp_variable_specs(sd, size)
    mine = {k for k, s in specs.items() if s == 0}
    assert len(mine) >= 10
    assert mine == _sharded_names(jcfg, cfg, init_state_dict(cfg), size)
    assert specs["encoder_decoder.regressor.weight"] is None
    assert specs["encoder_decoder.down1.conv1.cbr_unit.1.num_batches_"
                 "tracked"] is None


@pytest.mark.parametrize("impl", ["scatter", "affine"])
def test_tp_forward_matches_replicated(tmp_path, impl):
    """The tp forward over 4 ranks, each with its output-channel shards,
    against the replicated forward (rtol 1e-5, atol 1e-6)."""
    _, cfg = _configs(fused_impl=impl)
    model = GroundEstimatorNet(cfg, device="cpu")
    model.load_state_dict(weights(cfg))
    sd = model.state_dict()
    pts, _ = batch(np.random.default_rng(15))
    want = model.fused(torch.from_numpy(pts))
    results = spawn(tmp_path, "tp_job", 4, cfg=cfg, state_dict=sd,
                    points=pts)
    for r in results:
        assert r["sharded"] >= 10
        np.testing.assert_allclose(r["out"], want, rtol=1e-5, atol=1e-6)


# --- slow: the JAX package's slow mesh tests, on the port ----------------------

def _unequal_fill(rng, b=4, n=512):
    """tests/test_parallel.py:80-120's batch: scan i confined to x <
    2 + 3.5 i, so per-rank pillar counts differ ~8x under dp=4."""
    pts = np.zeros((b, n, 4), np.float32)
    for i in range(b):
        pts[i, :, 0] = rng.uniform(0.2, 2.0 + 3.5 * i, n)
        pts[i, :, 1] = rng.uniform(-7.8, 7.8, n)
        pts[i, :, 2] = 0.05 * pts[i, :, 0] - 0.5 + rng.normal(0, 0.05, n)
    return pts


@pytest.mark.slow
def test_dp_use_norm_syncbn_unequal_fill_matches_single_device(tmp_path):
    """use_norm sync-BN under dp=4 with unequal pillar counts: the PFN's
    sums AND row counts are summed over dp, so the step matches the
    single-device step on the whole batch and JAX's dp step; the PFN's
    running statistics too.

    beta=0 (no smoothness term), as the JAX package's padded spmd tests
    set it: three quarters of the canvas is empty, so the elevation map is
    flat there, its second differences are rounding noise around 0, and
    |.|'s gradient takes their sign; a B=1 conv rounds otherwise than a
    B=4 one, so the smoothness term's gradient differs between ANY two
    batchings of the same step (measured: up1.conv2's weight 3.7x the
    tolerance at beta=0.1, 0.44x at beta=0)."""
    jcfg, cfg = _configs(use_norm=True, beta=0.0)
    sd = weights(cfg)
    pts = _unequal_fill(np.random.default_rng(21))
    _, labels = batch(np.random.default_rng(21))
    results = spawn(tmp_path, "train_job", 4, cfg=cfg, state_dict=sd,
                    points=pts, labels=labels, dp=4, sp=1)
    got = results[0]["state_dict"]
    losses, single = single_step(cfg, sd, pts, labels)
    assert results[0]["losses"][0] == pytest.approx(losses[0], rel=LOSS_RTOL)
    assert_state_close(got, single, "vs the single-device step:")
    mesh = jmesh.make_mesh(dp=4, sp=1)
    model, tx, state = jax_state(sd, jcfg)
    state, loss = jmesh.make_dp_train_step(model, tx, jcfg, mesh)(
        jmesh.replicate(mesh, state),
        *jmesh.shard_batch(mesh, (jnp.asarray(pts), jnp.asarray(labels))))
    assert results[0]["losses"][0] == pytest.approx(float(loss),
                                                    rel=LOSS_RTOL)
    assert_state_close(got, jax_state_dict(state, cfg), "vs JAX's dp step:")


def _odd_cfg(ny=10, nx=16, **kw):
    return _configs(pc_range=(0.0, -ny / 2.0, -4.0, float(nx), ny / 2.0, 4.0),
                    grid_range=(0.0, -ny / 2.0, float(nx), ny / 2.0), **kw)


@pytest.mark.slow
@pytest.mark.parametrize("ny,sp", [(10, 2), (10, 4), (250, 2)])
def test_spatial_infer_padded_odd_ny_matches_unsharded(tmp_path, ny, sp):
    """Heights that do not divide (fine_grid's 250 among them) on
    zero-padded slabs with masked rows, against JAX's make_spatial_infer
    and the port's unsharded forward."""
    jcfg, cfg = _odd_cfg(ny=ny)
    sd = weights(cfg)
    pts, _ = batch(np.random.default_rng(12), cfg, b=2)
    got = gathered(spawn(tmp_path, "infer_job", sp, cfg=cfg, state_dict=sd,
                         points=pts, dp=1, sp=sp), 1)
    assert got.shape == (2, cfg.ny, cfg.nx)
    mesh = jmesh.make_mesh(dp=1, sp=sp)
    want = jspatial.make_spatial_infer(jcfg, mesh)(
        jmesh.replicate(mesh, jax_variables(sd, jcfg)),
        jmesh.shard_batch(mesh, jnp.asarray(pts)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=INFER_RTOL,
                               atol=INFER_ATOL)
    model = GroundEstimatorNet(cfg, device="cpu")
    model.load_state_dict(sd)
    np.testing.assert_allclose(got, model.fused(torch.from_numpy(pts)),
                               rtol=INFER_RTOL, atol=INFER_ATOL)


@pytest.mark.slow
def test_spatial_infer_affine_matches_unsharded(tmp_path):
    """The affine frontend (the port's kernels' plain versions here) under
    dp=2 x sp=4, against the unsharded affine model and JAX's."""
    jcfg, cfg = _configs(fused_impl="affine")
    sd = weights(cfg)
    pts, _ = batch(np.random.default_rng(21))
    got = gathered(spawn(tmp_path, "infer_job", 8, cfg=cfg, state_dict=sd,
                         points=pts, dp=2, sp=4), 2)
    model = GroundEstimatorNet(cfg, device="cpu")
    model.load_state_dict(sd)
    np.testing.assert_allclose(got, model.fused(torch.from_numpy(pts)),
                               rtol=INFER_RTOL, atol=INFER_ATOL)
    want = JaxNet(jcfg).apply(jax_variables(sd, jcfg), jnp.asarray(pts),
                              method=JaxNet.fused)
    np.testing.assert_allclose(got, np.asarray(want), rtol=INFER_RTOL,
                               atol=INFER_ATOL)


SPMD_CASES = {
    # name: (cfg kwargs, dp, sp, scans), after tests/test_parallel.py's
    # spmd cases
    "sp4_B2": (dict(batch_size=2), 1, 4, 2),
    "dp2_sp2": (dict(), 2, 2, 4),
    "sp2_odd_ny10": (dict(batch_size=2, ny=10), 1, 2, 2),
    "dp2_sp2_ny250": (dict(batch_size=2, ny=250), 2, 2, 2),
}


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(SPMD_CASES))
def test_spmd_train_step_matches_single_device(tmp_path, case):
    """One dp x sp spatial step against the single-device step on the
    whole batch: loss, parameters, batch-norm statistics.  beta=0 for the
    reason `test_dp2_train_step_matches_single_device_and_jax` gives
    (tests/test_parallel.py sets it for the padded cases).

    ny=250 (fine_grid's height on padded 128-row slabs) is held against
    JAX's make_spmd_train_step on the same mesh instead, at that file's
    fine_grid tolerance (rtol 2e-3, atol 3e-4): its canvas is 85% empty,
    so 6370 max-pool windows hold exact ties, and the single-device step
    moves its own loss by 1.4e-4 of itself when the two scans swap places;
    no single-device step is a reference at rel 1e-5 there."""
    kw, dp, sp, b = SPMD_CASES[case]
    kw = dict(kw, beta=0.0)
    ny = kw.pop("ny", None)
    jcfg, cfg = _odd_cfg(ny=ny, **kw) if ny else _configs(**kw)
    sd = weights(cfg)
    pts, labels = batch(np.random.default_rng(11), cfg, b=b)
    results = spawn(tmp_path, "train_job", dp * sp, cfg=cfg, state_dict=sd,
                    points=pts, labels=labels, dp=dp, sp=sp)
    for r in results[1:]:
        assert r["losses"] == results[0]["losses"]
    got = results[0]["state_dict"]
    if ny != 250:
        losses, single = single_step(cfg, sd, pts, labels)
        assert results[0]["losses"][0] == pytest.approx(losses[0],
                                                        rel=LOSS_RTOL)
        assert_state_close(got, single, f"{case} vs the single-device step:")
        return
    mesh = jmesh.make_mesh(dp=dp, sp=sp)
    model, tx, state = jax_state(sd, jcfg)
    state, loss = jspatial.make_spmd_train_step(model, tx, jcfg, mesh)(
        jmesh.replicate(mesh, state),
        *jmesh.shard_batch(mesh, (jnp.asarray(pts), jnp.asarray(labels))))
    assert results[0]["losses"][0] == pytest.approx(float(loss),
                                                    rel=LOSS_RTOL)
    for name, w in jax_state_dict(state, cfg).items():
        stat = "running" in name
        np.testing.assert_allclose(
            got[name].numpy(), w.numpy(), rtol=STAT_RTOL if stat else 2e-3,
            atol=STAT_ATOL if stat else 3e-4, err_msg=f"{case} {name}")


@pytest.mark.slow
def test_spmd_and_dp_train_augmented_run_and_learn(tmp_path):
    """On-device augmentation under both mesh steps: drawn from (step, dp
    index), so the dp shards differ and the sp ranks of a row agree; the
    loss falls."""
    _, cfg = _configs()
    sd = weights(cfg)
    pts, labels = batch(np.random.default_rng(12))
    results = multihost.spawn(
        JOBS + "train_job", 4, device="cpu", workdir=str(tmp_path / "spmd"),
        kwargs=dict(
            cfg=cfg, state_dict=sd, points=pts, labels=labels, dp=2, sp=2,
            steps=8, augment=True))
    losses = results[0]["losses"]
    assert all(r["losses"] == losses for r in results)
    assert np.isfinite(losses).all() and losses[-1] < 0.8 * losses[0]
    plain = spawn(tmp_path, "train_job", 4, cfg=cfg, state_dict=sd,
                  points=pts, labels=labels, dp=4, sp=1, steps=2,
                  augment=False)
    augmented = multihost.spawn(
        JOBS + "train_job", 4, device="cpu", workdir=str(tmp_path / "dp"),
        kwargs=dict(
            cfg=cfg, state_dict=sd, points=pts, labels=labels, dp=4, sp=1,
            steps=2, augment=True))
    assert np.isfinite(augmented[0]["losses"]).all()
    assert augmented[0]["losses"] != plain[0]["losses"]
