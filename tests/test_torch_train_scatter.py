"""Training through the 'scatter' impl against the JAX package on the CPU,
with the PFN plain (use_norm=False, every shipped config) and with its
batch-statistics BatchNorm (use_norm=True, which JAX routes through the
scatter frontend for every impl): the train-mode canvas and its gradient
in the PFN parameters, the PFN's running statistics, three float32 train
steps from the same initial variables, and the 'sorted' impl's refusal
to train."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu import train as jtrain
from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.models.pfn import PFNLayer as JaxPFNLayer
from gndnet_tpu.ops import pillarize as jpz
from gndnet_tpu_torch import train
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.weights import state_dict_from_flax
from test_torch_train import SMALL, _close_to_scale, _labelled

PFN = "voxel_feature_extractor.pfn_layers.0"


def _setup(impl, use_norm, seed=1234):
    kw = {**SMALL, "fused_impl": impl, "use_norm": use_norm}
    jcfg, cfg = JaxConfig(**kw), GndNetConfig(**kw)
    pts, labels = _labelled(np.random.default_rng(seed), cfg)
    model, tx, state = jtrain.create_train_state(jcfg, steps_per_epoch=10)
    initial = jax.tree_util.tree_map(np.array, {
        "params": state.params, "batch_stats": state.batch_stats})
    tstate = train.create_train_state(
        cfg, 10, state_dict=state_dict_from_flax(initial, cfg), device="cpu")
    return jcfg, cfg, pts, labels, (model, tx, state), initial, tstate


def _jax_canvas(jcfg, pts, pfn_vars):
    """`GroundEstimatorNet.fused`'s train-mode canvas (its scatter and
    use_norm branches), as a function of the PFN variables."""
    geom = jpz.PillarGeometry.from_config(jcfg)
    ctx = jpz.bin_points_batch(jnp.asarray(pts), geom)
    cap = jcfg.max_points_voxel
    dec, kept, count = jpz.fused_frontend(
        jnp.asarray(pts.reshape(-1, 4)), ctx, geom, cap)
    layer = JaxPFNLayer(64, use_norm=jcfg.use_norm, last_layer=True)
    if jcfg.use_norm:
        occ = (count > 0).reshape(pts.shape[0], -1)
        rows = jnp.sum(jnp.minimum(occ.sum(axis=1), jcfg.max_voxels)) * cap
        (acts, floor), mut = layer.apply(
            pfn_vars, dec, rows, method=JaxPFNLayer.activate_flat_bn_train,
            mutable=["batch_stats"])
    else:
        acts = layer.apply(pfn_vars, dec, method=JaxPFNLayer.activate_flat)
        floor = layer.apply(pfn_vars, jnp.zeros((1, dec.shape[-1])),
                            method=JaxPFNLayer.activate_flat)[0]
        mut = {}
    canvas = jpz.canvas_from_activations(acts, ctx, kept, count, geom, cap,
                                         pad_floor=floor)
    return canvas, mut


@pytest.mark.parametrize("use_norm", [False, True])
def test_train_canvas_and_pfn_gradient_match_jax(use_norm):
    """The train-mode canvas (within 1e-5), d(sum(canvas * w)) in every
    PFN parameter against `jax.grad` (within 1e-5 of each gradient's
    largest entry: sums over every kept point in another order) and,
    under use_norm, the PFN's running mean and variance after the step
    (within 1e-6 of scale)."""
    jcfg, cfg, pts, _, _, initial, tstate = _setup("scatter", use_norm)
    pfn_vars = {k: initial[k]["voxel_feature_extractor"]["pfn_0"]
                for k in ("params", "batch_stats")
                if "pfn_0" in initial[k].get("voxel_feature_extractor", {})}
    wts = np.random.default_rng(2).normal(
        size=(2, cfg.ny, cfg.nx, 64)).astype(np.float32)

    def loss(params):
        canvas, mut = _jax_canvas(jcfg, pts, {**pfn_vars, "params": params})
        return jnp.sum(canvas * wts), (canvas, mut)

    (_, (jcanvas, mut)), grads = jax.value_and_grad(loss, has_aux=True)(
        pfn_vars["params"])
    net = tstate.model
    canvas = net.canvas(torch.from_numpy(pts), train=True)
    (canvas * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(canvas.detach().numpy(), np.asarray(jcanvas),
                               rtol=0, atol=1e-5)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.array, {
        "params": {"voxel_feature_extractor": {"pfn_0": grads},
                   "encoder_decoder": initial["params"]["encoder_decoder"]},
        "batch_stats": initial["batch_stats"]}), cfg)
    named = dict(net.named_parameters())
    pfn_params = [n for n in named if n.startswith(PFN)]
    assert len(pfn_params) == (3 if use_norm else 2)
    for name in pfn_params:
        _close_to_scale(named[name].grad.numpy(), want[name].numpy(), 1e-5,
                        name)
    if use_norm:
        stats = mut["batch_stats"]["norm"]
        got = net.state_dict()
        for key, jkey in (("running_mean", "mean"), ("running_var", "var")):
            w = np.asarray(stats[jkey])
            assert not np.array_equal(
                w, initial["batch_stats"]["voxel_feature_extractor"][
                    "pfn_0"]["norm"][jkey])
            _close_to_scale(got[f"{PFN}.norm.{key}"].numpy(), w, 1e-6, key)


@pytest.mark.parametrize("impl,use_norm", [("scatter", False),
                                           ("scatter", True),
                                           ("affine", True)])
def test_three_train_steps_match_jax(impl, use_norm):
    """make_train_step at float32 / 'highest' from JAX's initial variables:
    loss within rel 1e-5 at every step; after three steps every parameter
    and batch-norm statistic (the PFN's running mean and variance under
    use_norm) within 2e-2 of its tensor's largest magnitude, floored at
    1e-4 as in tests/test_torch_train.py.  That tolerance is the SegNet's,
    not the PFN's: the two frameworks' f32 convs differ by ~1e-5, so the
    ~100 000 ReLU inputs of a step put about one within rounding distance
    of zero, and that one position's gradient flips between the two
    (measured at this size: up to 8e-3 of a tensor's scale after three
    steps; the precise PFN check is the test above)."""
    jcfg, cfg, pts, labels, (model, tx, state), _, tstate = _setup(
        impl, use_norm)
    jstep = jtrain.make_train_step(model, tx, jcfg)
    tstep = train.make_train_step(cfg)
    for i in range(3):
        state, jloss = jstep(state, jnp.asarray(pts), jnp.asarray(labels))
        tstate, tloss = tstep(tstate, pts, labels)
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-5), i
    final = jax.tree_util.tree_map(np.array, {
        "params": state.params, "batch_stats": state.batch_stats})
    want = state_dict_from_flax(final, cfg)
    got = tstate.model.state_dict()
    if use_norm:
        assert int(got[f"{PFN}.norm.num_batches_tracked"]) == 3
    for name, w in want.items():
        _close_to_scale(got[name].numpy(), w.numpy(), 2e-2, name,
                        floor=1e-4)


def test_sorted_impl_does_not_train():
    """No gradient through K7, as the JAX package has none through its
    Pallas kernel; with use_norm, training takes the scatter frontend."""
    cfg = GndNetConfig(**{**SMALL, "fused_impl": "sorted"})
    pts, labels = _labelled(np.random.default_rng(3), cfg)
    state = train.create_train_state(cfg, 10, device="cpu")
    with pytest.raises(NotImplementedError, match="JAX package"):
        train.make_train_step(cfg)(state, pts, labels)
    normed = cfg.replace(use_norm=True)
    state = train.create_train_state(normed, 10, device="cpu")
    _, loss = train.make_train_step(normed)(state, pts, labels)
    assert np.isfinite(float(loss))
