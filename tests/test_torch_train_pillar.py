"""Training on the reference-style pillar path and with loss scaling,
against the JAX package on the CPU.

The weights are flax's initialisation from JAX's `create_train_state`
(as tests/test_torch_train*.py take them).  Every step is compared from
the same state: before each step JAX's
TrainState is rebuilt from the port's (weights, statistics, momentum,
update count, loss scale), so the rounding of one step does not compound
into the next.  The first loss is held to rel 1e-5, later ones (each
computed from equal weights) to rel 2e-2: where a max-pool window of the
updated SegNet is near-tied, the two packages can route its unpool
differently (ROADMAP.md §3; measured 0.16% in the third loss-scaled
step).  The parameters, momentum and running statistics after each step
are held to 2e-2 of their scale, floored at 1e-4
(tests/test_torch_train_scatter.py's tolerance); the loss scale and its
run of finite steps exactly.  2e-2 is the SegNet's, not the pillar path's
or the loss scaling's: JAX's jitted step does not always
give its own `jax.grad`'s gradient where a ReLU or max-pool window is
within rounding distance of a kink (with `init_state_dict(seed=2)`
weights one up1.conv1 weight moves 5.2e-5 in the jitted step, 4.834e-4 in
JAX's step run eagerly and in the port's; the gradients upstream of it,
a BatchNorm shift's among them, then differ by ~3% of their size).

* `make_train_step(use_pillar_path=True)` at f32 for a one- and a
  two-layer PFN, with and without use_norm, and `make_eval_step(
  use_pillar_path=True)`.
* The use_norm invariant of tests/test_train.py:196-215 on the port: its
  fused use_norm step against its own pillar-path step (loss rel 1e-5,
  parameters rtol 1e-3 / atol 1e-5, PFN running statistics rtol 1e-4 /
  atol 1e-6).
* Loss scaling against JAX's `create_train_state(loss_scaling=True)`:
  finite steps with flax's growth rule, and a forced overflow, which keeps
  everything but the scale and the step count.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training.dynamic_scale import DynamicScale as JaxDynamicScale

from gndnet_tpu import train as jtrain
from gndnet_tpu.checkpoint import import_torch_state_dict
from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.models.gndnet import GroundEstimatorNet as JaxNet
from gndnet_tpu_torch import train
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.weights import state_dict_from_flax
from test_torch_train import SMALL, _close_to_scale, _labelled

STEP_SHARE = 2e-2
PFN = "voxel_feature_extractor.pfn_layers"


def _configs(**kw):
    kw = {**SMALL, "fused_impl": "scatter", **kw}
    return JaxConfig(**kw), GndNetConfig(**kw)


@functools.lru_cache(maxsize=None)
def _jax_created(use_norm: bool, vfe: tuple):
    """JAX's `create_train_state(loss_scaling=True)` (flax's `init_model`
    takes ~13 s on one core: once per PFN)."""
    jcfg, _ = _configs(use_norm=use_norm, vfe_filters=vfe)
    return jtrain.create_train_state(jcfg, 10, loss_scaling=True)[2]


def _initial(cfg) -> dict:
    """flax's initial weights for `cfg`, in the port's names."""
    state = _jax_created(cfg.use_norm, cfg.vfe_filters)
    return state_dict_from_flax(jax.tree_util.tree_map(np.array, {
        "params": state.params, "batch_stats": state.batch_stats}), cfg)


def _momentum(tstate) -> dict:
    named = dict(tstate.model.named_parameters())
    return {n: tstate.tx.sgd.state[p]["momentum_buffer"]
            for n, p in named.items() if p in tstate.tx.sgd.state}


def _jax_state(jcfg, tstate):
    """JAX's TrainState holding the port's state (at step 0, what JAX's
    `create_train_state` builds)."""
    sd = {k: v.detach().clone() for k, v in
          tstate.model.state_dict().items()}
    variables = import_torch_state_dict(sd, jcfg)
    tx = jtrain.make_optimizer(jcfg, 10)
    opt_state = tx.init(variables["params"])
    momentum = _momentum(tstate)
    if momentum:
        trace = import_torch_state_dict({**sd, **momentum}, jcfg)["params"]
        opt_state = (opt_state[0], opt_state[1]._replace(trace=trace),
                     opt_state[2]._replace(count=jnp.asarray(
                         tstate.tx.count, jnp.int32)))
    ds = tstate.dynamic_scale
    jds = None if ds is None else JaxDynamicScale(
        growth_interval=ds.growth_interval, fin_steps=ds.fin_steps,
        scale=jnp.float32(ds.scale))
    state = jtrain.TrainState(
        step=jnp.asarray(tstate.step, jnp.int32),
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=jax.tree_util.tree_map(jnp.asarray, opt_state),
        dynamic_scale=jds)
    return JaxNet(jcfg), tx, state


def _assert_state_close(state, tstate, cfg, share=STEP_SHARE):
    """Parameters, running statistics and momentum of the port's state
    against JAX's, within `share` of scale."""
    final = jax.tree_util.tree_map(np.array, {
        "params": state.params, "batch_stats": state.batch_stats})
    got = tstate.model.state_dict()
    for name, w in state_dict_from_flax(final, cfg).items():
        _close_to_scale(got[name].numpy(), w.numpy(), share, name,
                        floor=1e-4)
    trace = jax.tree_util.tree_map(np.array, {
        "params": state.opt_state[1].trace,
        "batch_stats": state.batch_stats})
    momentum = _momentum(tstate)
    for name, w in state_dict_from_flax(trace, cfg).items():
        if name in momentum:
            _close_to_scale(momentum[name].numpy(), w.numpy(), share,
                            "momentum " + name, floor=1e-4)


def _loss_rtol(step: int) -> float:
    return 1e-5 if step == 0 else STEP_SHARE


def _step_both(jcfg, cfg, tstate, pts, labels, jax_steps, **kw):
    """One step of each package from the port's state; returns (JAX's new
    state, JAX's loss, the port's loss).  `jax_steps` caches JAX's jitted
    step."""
    model, tx, state = _jax_state(jcfg, tstate)
    if "step" not in jax_steps:
        jax_steps["step"] = jtrain.make_train_step(model, tx, jcfg, **kw)
    state, jloss = jax_steps["step"](state, jnp.asarray(pts),
                                     jnp.asarray(labels))
    tstate, tloss = train.make_train_step(cfg, **kw)(tstate, pts, labels)
    return state, float(jloss), float(tloss)


PILLAR_CASES = {"plain_64": (False, (64,)), "norm_64": (True, (64,)),
                "norm_32_64": (True, (32, 64))}


@pytest.fixture
def one_thread():
    """The port's steps on one intra-op thread, where the first step of
    the norm_64 case agrees with JAX's within 1e-9.  The number of threads
    sets the rounding of torch's CPU convolutions (by up to 1.1e-5 at 8
    threads against 1), and on 8 threads one pre-activation of up2.conv1,
    5.6e-6 from the ReLU's kink, changes sign in the first step: that
    position's cotangent drops out of the gradients upstream of it, so
    one of the block's batch-norm shifts lands at 1.96x and its conv
    weight's momentum at 4.97x the 2e-2 share from JAX's, whose ReLU
    keeps it.  Which side of a kink rounding lands on is no property of
    the port, and no bound that holds the other tensors at 2e-2 covers
    it.  The loss-scaled steps run on one thread too: on 4 threads
    (OMP_NUM_THREADS=4) 24 of the 147 456 momenta of up1.conv1's conv
    weight land at 1.94x the share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", sorted(PILLAR_CASES))
def test_pillar_path_steps_match_jax(case, request):
    if case == "norm_64":
        request.getfixturevalue("one_thread")
    use_norm, vfe = PILLAR_CASES[case]
    jcfg, cfg = _configs(use_norm=use_norm, vfe_filters=vfe)
    sd = _initial(cfg)
    pts, labels = _labelled(np.random.default_rng(1234), cfg)
    tstate = train.create_train_state(cfg, 10, state_dict=sd, device="cpu")
    steps = {}
    for i in range(2):
        state, jloss, tloss = _step_both(jcfg, cfg, tstate, pts, labels,
                                         steps, use_pillar_path=True)
        assert tloss == pytest.approx(jloss, rel=_loss_rtol(i)), i
        assert tstate.step == tstate.tx.count == int(state.step) == i + 1
        _assert_state_close(state, tstate, cfg)
    model, _, state = _jax_state(jcfg, tstate)
    want = jtrain.make_eval_step(model, jcfg, use_pillar_path=True)(
        state, jnp.asarray(pts), jnp.asarray(labels))
    got = train.make_eval_step(cfg, use_pillar_path=True)(tstate, pts,
                                                          labels)
    assert float(got) == pytest.approx(float(want), rel=STEP_SHARE)
    # every parameter of the stack moved
    for name, w in tstate.model.state_dict().items():
        if name.startswith(PFN) and "running" not in name \
                and "num_batches" not in name:
            assert not torch.equal(w, sd[name]), name


def test_use_norm_fused_step_matches_pillar_step():
    """tests/test_train.py:196-215 on the port: the fused use_norm step
    derives the padded pillar tensor's batch statistics from the flat
    stream; it equals the pillar path's step."""
    _, cfg = _configs(use_norm=True)
    sd = _initial(cfg)
    pts, labels = _labelled(np.random.default_rng(5), cfg)
    sp = train.create_train_state(cfg, 10, state_dict=sd, device="cpu")
    sf = train.create_train_state(cfg, 10, state_dict=sd, device="cpu")
    sp, lp = train.make_train_step(cfg, use_pillar_path=True)(sp, pts,
                                                              labels)
    sf, lf = train.make_train_step(cfg)(sf, pts, labels)
    assert float(lf) == pytest.approx(float(lp), rel=1e-5)
    for (name, a), b in zip(sp.model.named_parameters(),
                            sf.model.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)
    got, want = sf.model.state_dict(), sp.model.state_dict()
    for key in ("running_mean", "running_var"):
        name = f"{PFN}.0.norm.{key}"
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6)


# --- loss scaling -------------------------------------------------------------

def test_create_train_state_with_loss_scaling_has_flax_defaults():
    """The port's `create_train_state(loss_scaling=True)` against JAX's:
    flax's rule and defaults, at step 0."""
    _, cfg = _configs()
    jstate = _jax_created(False, (64,))
    tstate = train.create_train_state(cfg, 10, loss_scaling=True,
                                      device="cpu")
    for key in ("growth_factor", "backoff_factor", "growth_interval",
                "fin_steps", "scale", "minimum_scale"):
        assert getattr(tstate.dynamic_scale, key) == getattr(
            jstate.dynamic_scale, key), key
    assert tstate.step == int(jstate.step) == 0
    assert train.create_train_state(cfg, 10, device="cpu").dynamic_scale \
        is None


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("growth_interval", [2000, 2])
def test_loss_scaled_steps_match_jax(growth_interval):
    """Three finite steps: the scale and the run of finite steps equal
    after every step (with a growth interval of 2 the scale doubles at the
    third), the loss and the state as above."""
    jcfg, cfg = _configs()
    sd = _initial(cfg)
    # the data of tests/test_torch_train_scatter.py's unscaled steps
    pts, labels = _labelled(np.random.default_rng(1234), cfg)
    tstate = train.create_train_state(cfg, 10, loss_scaling=True,
                                      state_dict=sd, device="cpu")
    tstate.dynamic_scale.growth_interval = growth_interval
    steps = {}
    for i in range(3):
        state, jloss, tloss = _step_both(jcfg, cfg, tstate, pts, labels,
                                         steps)
        assert tloss == pytest.approx(jloss, rel=_loss_rtol(i)), i
        ds = tstate.dynamic_scale
        assert ds.scale == float(state.dynamic_scale.scale), i
        assert ds.fin_steps == int(state.dynamic_scale.fin_steps), i
        _assert_state_close(state, tstate, cfg)
    assert tstate.dynamic_scale.scale == (131072.0 if growth_interval == 2
                                          else 65536.0)
    assert tstate.step == tstate.tx.count == 3


def test_overflowing_loss_scaled_step_is_skipped_as_jax_skips_it():
    """A scale at the float32 maximum overflows the gradients (alpha 1000
    and labels 10 off make every elevation's scaled cotangent overflow):
    the step keeps the parameters, momentum, running statistics (the
    PFN's under use_norm and the SegNet's) and the schedule's count,
    halves the scale, resets the run of finite steps, and still counts as
    a step; the next step trains."""
    jcfg, cfg = _configs(use_norm=True, alpha=1000.0)
    sd = _initial(cfg)
    pts, labels = _labelled(np.random.default_rng(9), cfg)
    labels = labels + 10.0
    tstate = train.create_train_state(cfg, 10, loss_scaling=True,
                                      state_dict=sd, device="cpu")
    steps = {}
    # one finite step first, so the momentum is not zero
    _step_both(jcfg, cfg, tstate, pts, labels, steps)
    assert tstate.tx.count == 1
    top = float(np.finfo(np.float32).max)
    tstate.dynamic_scale.scale = top
    tstate.dynamic_scale.fin_steps = 1
    before = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    before_momentum = {k: v.clone() for k, v in _momentum(tstate).items()}
    state, jloss, tloss = _step_both(jcfg, cfg, tstate, pts, labels, steps)
    assert not np.isfinite(jloss) and not np.isfinite(tloss)
    assert int(state.step) == tstate.step == 2
    assert int(state.opt_state[2].count) == tstate.tx.count == 1
    half = float(np.float32(top) * np.float32(0.5))
    assert tstate.dynamic_scale.scale == float(state.dynamic_scale.scale) \
        == half
    assert tstate.dynamic_scale.fin_steps == 0 \
        == int(state.dynamic_scale.fin_steps)
    for name, v in tstate.model.state_dict().items():
        if "num_batches_tracked" not in name:
            assert torch.equal(v, before[name]), name
    for name, v in _momentum(tstate).items():
        assert torch.equal(v, before_momentum[name]), name
    _assert_state_close(state, tstate, cfg, share=0.0)
    tstate.dynamic_scale.scale = 1.0
    train.make_train_step(cfg)(tstate, pts, labels)
    assert tstate.tx.count == 2 and tstate.step == 3


def test_smoothness_gradient_on_flat_stretches_matches_jax():
    """On a flat stretch of the elevation map the second differences are
    exactly 0, where `jnp.abs`'s gradient is +1 (torch's `abs` gives 0):
    `spatial_smooth_loss`'s gradient equals `jax.grad`'s there."""
    from gndnet_tpu import losses as jlosses
    from gndnet_tpu_torch import losses

    pred = np.zeros((2, 6, 7), np.float32)
    pred[:, 3:, 4:] = np.random.default_rng(0).normal(size=(2, 3, 3))
    want = jax.grad(jlosses.spatial_smooth_loss)(jnp.asarray(pred))
    t = torch.from_numpy(pred).requires_grad_()
    losses.spatial_smooth_loss(t).backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
