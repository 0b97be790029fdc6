"""The train step as one device program, on the CPU: what lets the card
capture it as one CUDA graph (tests/test_torch_cuda.py and chip_smoke's
`graphs` phase replay it there).

* The step's body reads nothing back to the host: no `.item()`, `bool()`,
  `int()`, `float()`, `tolist()` or `numpy()` of a tensor, with loss
  scaling, augmentation and the clip, on 'affine' and 'scatter' (use_norm
  too) and on the pillar path.  The kernels' wrappers are exempt: on the
  CPU each runs its kernel's plain version, which stands in for one launch
  that reads nothing back on the card (chip_smoke replays them under
  `torch.cuda.set_sync_debug_mode("error")`).
* The device schedules against JAX's schedules traced under `jit`, bit for
  bit, at every boundary and, for the live StepLR, at every count of 150
  epochs.  Between boundaries XLA's CPU `pow` and `cos` round otherwise
  than correctly now and then, so no bits are claimed there.
* The update equals the JAX package's optax chain as `jit` compiles it,
  bit for bit, over six steps that cross a StepLR boundary, a skipped
  (non-finite) one among them.
* Four loss-scaled steps with one forced non-finite step against JAX's
  jitted loss-scaled step, from the same state before each step (the
  tolerances of tests/test_torch_train_pillar.py).
* Restores copy into the live tensors: `load_state_dict`,
  `checkpoint.restore_checkpoint` and the bench's restore leave every
  tensor of the state the same object, and the next step equals a fresh
  state's.
* The augmentation draws are an input of the step, drawn from
  `augment_generator(0, step)`, and the step's host mirror moves once a
  step, a skipped one too.
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.train import make_optimizer as jax_optimizer
from gndnet_tpu.utils import schedules as jsched
from gndnet_tpu_torch import evaluate, train
from gndnet_tpu_torch.checkpoint import checkpoint_dict, restore_checkpoint
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.data import augmentation as taug
from gndnet_tpu_torch.infer import GroundInferenceEngine
from gndnet_tpu_torch.ops import affine, segment, sort
from gndnet_tpu_torch.synthetic import synthetic_scan
from gndnet_tpu_torch.utils import schedules as tsched
from gndnet_tpu_torch.utils.graphs import GraphCache
from gndnet_tpu_torch.weights import init_state_dict
from test_torch_train import SMALL, _labelled
from test_torch_train_pillar import (_assert_state_close,
                                     _configs, _initial, _loss_rtol,
                                     _step_both, one_thread)  # noqa: F401

HOST_READS = ("item", "__bool__", "__int__", "__float__", "tolist", "numpy")
# the wrappers that launch a kernel on the card (their plain version here)
KERNELS = ((affine, ("cell_histogram", "histogram_counts", "histogram_ends",
                     "affine_scan_gather", "affine_scan_argmax_pair",
                     "affine_scan_argmax_packed", "affine_bwd_dmmat")),
           (sort, ("sort_i32", "sort2_i32")),
           (segment, ("suffix_segment_reduce",)))


@contextlib.contextmanager
def no_host_reads(monkeypatch):
    """Every tensor-to-host read raises inside the block, except inside a
    kernel wrapper."""
    exempt = [0]

    def guard(name, orig):
        def read(self, *args, **kwargs):
            if not exempt[0]:
                raise AssertionError(f"host read: Tensor.{name}")
            return orig(self, *args, **kwargs)
        return read

    def kernel(fn):
        def run(*args, **kwargs):
            exempt[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                exempt[0] -= 1
        return run

    for module, names in KERNELS:
        for name in names:
            monkeypatch.setattr(module, name, kernel(getattr(module, name)))
    with monkeypatch.context() as m:
        for name in HOST_READS:
            m.setattr(torch.Tensor, name, guard(name,
                                                getattr(torch.Tensor, name)))
        yield


CASES = {
    "affine_bf16": dict(compute_dtype="bfloat16",
                        matmul_precision="default"),
    "affine_f32": {},
    "scatter_use_norm": dict(fused_impl="scatter", use_norm=True),
    "pillar_path_use_norm": dict(fused_impl="scatter", use_norm=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_reads_nothing_back(case, monkeypatch):
    """Two steps (loss-scaled, augmented, clipped) and an eval step read
    no tensor back to the host; the steps train."""
    cfg = GndNetConfig(**SMALL).replace(use_grad_clip=True, clip=0.5,
                                        **CASES[case])
    pillar = case.startswith("pillar")
    pts, labels = _labelled(np.random.default_rng(3), cfg)
    state = train.create_train_state(cfg, 10, loss_scaling=True,
                                     device="cpu")
    before = [p.detach().clone() for p in state.tx.params]
    step = train.make_train_step(cfg, augment=True, use_pillar_path=pillar)
    evaluate_step = train.make_eval_step(cfg, use_pillar_path=pillar)
    with no_host_reads(monkeypatch):
        for _ in range(2):
            _, loss = step(state, pts, labels)
        valid = evaluate_step(state, pts, labels)
    assert np.isfinite(float(loss)) and np.isfinite(float(valid))
    assert state.step == int(state.step_t) == state.tx.count == 2
    assert state.dynamic_scale.fin_steps == 2
    assert all(not torch.equal(p, q) for p, q in zip(state.tx.params,
                                                     before))
    assert step.eager_steps == 2 and step.replays == 0


# --- schedules -----------------------------------------------------------------

# name: (schedule of a module, its boundaries, the bound of libm's
# rounding where the schedule takes a pow or cos of a non-integer)
F32_ULP = 2.0 ** -23
SCHEDULES = {
    "step_lr": (lambda m: m.step_lr(0.1, 2, 0.8, 3), (6, 12, 18, 60), None),
    "constant": (lambda m: m.constant_lr(0.05), (0,), None),
    "manual": (lambda m: m.manual_stepping([3, 7, 12],
                                           [0.1, 0.05, 0.01, 0.001]),
               (3, 7, 12), None),
    "burnin_staircase": (lambda m: m.exponential_decay_with_burnin(
        0.1, 4, 0.8, burnin_learning_rate=0.01, burnin_steps=3),
        (3, 4, 8, 12, 40), None),
    # pow(0.8, s / 4): a 0.82-ulp powf against a correctly rounded one
    "smooth": (lambda m: m.exponential_decay_with_burnin(
        0.1, 4, 0.8, staircase=False), (0, 4, 8),
        lambda want: abs(want) * 2 * F32_ULP),
    # cos of the decay: one ulp of a value of magnitude <= 1, times the
    # 0.5 * base_lr it is scaled by (1 + cos cancels near the end)
    "cosine": (lambda m: m.cosine_decay_with_warmup(
        0.1, 36, warmup_learning_rate=0.01, warmup_steps=5,
        hold_base_rate_steps=3), (5, 8, 36), lambda want: 0.05 * F32_ULP),
    "cosine_plain": (lambda m: m.cosine_decay_with_warmup(0.1, 36),
                     (0, 36), lambda want: 0.05 * F32_ULP),
    "cosine_long_warmup": (lambda m: m.cosine_decay_with_warmup(
        0.013, 10000, warmup_learning_rate=0.001, warmup_steps=700,
        hold_base_rate_steps=300), (700, 1000, 10000),
        lambda want: 0.0065 * F32_ULP),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_device_schedules_equal_jax_traced(name):
    """Each schedule's device form at int32 counts 2 either side of every
    boundary against JAX's jitted schedule, as a float32 0-dim tensor:
    the same bits, except where it takes a pow or cos of a non-integer.
    There XLA's CPU backend calls glibc's `powf` and `cosf`, which are
    not correctly rounded (0.82 ulp for `powf`), and the port takes the
    float64 function rounded to float32 (which the card computes alike):
    the two differ by at most that rounding.  The warmup line, the hold,
    the steps and the burn-in carry no such rounding and are bit-equal."""
    make, bounds, libm = SCHEDULES[name]
    want_fn, got_fn = jax.jit(make(jsched)), make(tsched)
    counts = sorted({max(b + d, 0) for b in bounds for d in range(-2, 3)})
    differ = []
    for c in counts:
        got = got_fn(torch.tensor(c, dtype=torch.int32))
        want = np.asarray(want_fn(jnp.int32(c)))
        assert got.dtype == torch.float32 and got.shape == ()
        if got.numpy().view(np.int32) != want.view(np.int32):
            assert libm is not None, c
            assert abs(float(got) - float(want)) <= libm(float(want)), c
            differ.append(c)
    assert len(differ) <= len(counts) // 2, differ


def test_live_step_lr_equals_jax_at_every_count():
    """StepLR(15, 0.8) at 50 steps an epoch over 150 epochs, every count."""
    want_fn = jax.jit(jax.vmap(jsched.step_lr(0.001, 15, 0.8, 50)))
    got_fn = tsched.step_lr(0.001, 15, 0.8, 50)
    counts = np.arange(150 * 50, dtype=np.int32)
    want = np.asarray(want_fn(jnp.asarray(counts)))
    got = got_fn(torch.from_numpy(counts)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert got_fn(7499) == pytest.approx(float(want[-1]), rel=1e-6)


# --- the update --------------------------------------------------------------------

def test_update_equals_jitted_optax_bit_for_bit():
    """`Optimizer.step` against the JAX package's `make_optimizer` chain
    (add_decayed_weights -> trace -> scale_by_schedule(-step_lr)) and
    `optax.apply_updates` under `jax.jit`, as its train step runs them,
    from the same parameters and gradients: the same parameters and
    momentum to the bit after each of six steps at 2 steps an epoch with
    a StepLR step of one epoch, so the rate changes at counts 2 and 4.
    The fourth step is skipped (`finite` false) on both sides: nothing
    but its gradients is drawn."""
    import optax

    kw = dict(lr=0.05, lr_step_size=1, lr_gamma=0.5, weight_decay=0.0005,
              momentum=0.9)
    rng = np.random.default_rng(11)
    shapes = {"w": (64, 9), "b": (64,), "conv": (3, 3, 16, 32)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    tx = jax_optimizer(JaxConfig(**kw), 2)

    @jax.jit
    def jax_step(grads, opt_state, p):
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(v.copy()))
               for v in params.values()]
    opt = train.make_optimizer(GndNetConfig(**kw), tparams, 2)
    for k in range(6):
        grads = {n: (rng.normal(size=s) * 0.8).astype(np.float32)
                 for n, s in shapes.items()}
        if k != 3:
            jparams, opt_state = jax_step(
                {n: jnp.asarray(g) for n, g in grads.items()}, opt_state,
                jparams)
        for p, g in zip(tparams, grads.values()):
            p.grad = torch.from_numpy(g)
        opt.step(torch.tensor(k != 3))
        momentum = opt_state[1].trace
        for i, n in enumerate(shapes):
            assert np.array_equal(tparams[i].detach().numpy().view(np.int32),
                                  np.asarray(jparams[n]).view(np.int32)), k
            assert np.array_equal(opt.momentum[i].numpy().view(np.int32),
                                  np.asarray(momentum[n]).view(np.int32)), k
    assert opt.count == 5


# --- loss scaling ----------------------------------------------------------------

@pytest.mark.usefixtures("one_thread")
def test_loss_scaled_steps_with_a_non_finite_step_match_jax():
    """Four steps at a growth interval of 2 against JAX's jitted
    loss-scaled step, each from the port's state: two finite steps, a
    third whose labels hold a NaN (its gradients are not finite: the
    parameters, momentum, update count and running statistics stay, the
    scale halves, its run resets, the step counts), a fourth finite one.
    The data of tests/test_torch_train_pillar.py's loss-scaled steps."""
    jcfg, cfg = _configs()
    sd = _initial(cfg)
    pts, labels = _labelled(np.random.default_rng(1234), cfg)
    bad = labels.copy()
    bad[0, 3, 4] = np.nan
    tstate = train.create_train_state(cfg, 10, loss_scaling=True,
                                      state_dict=sd, device="cpu")
    ds = tstate.dynamic_scale
    ds.growth_interval = 2
    scale_t = ds.scale_t
    steps = {}
    for i in range(4):
        kept = {k: v.clone() for k, v in tstate.model.state_dict().items()}
        momentum = [m.clone() for m in tstate.tx.momentum]
        state, jloss, tloss = _step_both(jcfg, cfg, tstate, pts,
                                         bad if i == 2 else labels, steps)
        assert ds.scale == float(state.dynamic_scale.scale), i
        assert ds.fin_steps == int(state.dynamic_scale.fin_steps), i
        assert tstate.tx.count == int(state.opt_state[2].count), i
        assert tstate.step == int(state.step) == int(tstate.step_t) == i + 1
        if i == 2:
            assert not np.isfinite(jloss) and not np.isfinite(tloss)
            for name, v in tstate.model.state_dict().items():
                if "num_batches_tracked" not in name:
                    assert torch.equal(v, kept[name]), name
            for m, n in zip(tstate.tx.momentum, momentum):
                assert torch.equal(m, n)
            _assert_state_close(state, tstate, cfg, share=0.0)
        else:
            assert tloss == pytest.approx(jloss, rel=_loss_rtol(i)), i
            _assert_state_close(state, tstate, cfg)
    assert ds.scale_t is scale_t
    assert (ds.scale, ds.fin_steps, tstate.tx.count) == (32768.0, 1, 3)


# --- restores copy in place ------------------------------------------------------

def _tensors(state) -> list:
    return state.tensors()


@pytest.mark.parametrize("how", ["load_state_dict", "restore_checkpoint",
                                 "bench_restore"])
def test_restore_copies_into_the_live_tensors(how, tmp_path):
    """After a restore every tensor of the state is the object it was
    (the same storage), it holds the restored values, and the next step
    equals a fresh state's step from the same checkpoint."""
    cfg = GndNetConfig(**SMALL)
    pts, labels = _labelled(np.random.default_rng(4), cfg)
    step = train.make_train_step(cfg)
    src = train.create_train_state(cfg, 10, loss_scaling=True, seed=1,
                                   device="cpu")
    for _ in range(2):
        step(src, pts, labels)
    ckpt = checkpoint_dict(src, epoch=1, lowest_loss=0.5)
    live = train.create_train_state(cfg, 10, loss_scaling=True, seed=2,
                                    device="cpu")
    step(live, pts, labels)
    ids = [(id(t), t.data_ptr()) for t in _tensors(live)]
    if how == "load_state_dict":
        live.model.load_state_dict(ckpt["state_dict"])
        live.load_state_dict(copy.deepcopy(ckpt["optimizer"]))
    elif how == "restore_checkpoint":
        path = str(tmp_path / "ckpt.pth.tar")
        torch.save(ckpt, path)
        assert restore_checkpoint(path, live)["epoch"] == 1
    else:   # gndnet_tpu_torch.bench.bench_train's restore()
        live.model.load_state_dict(copy.deepcopy(src.model.state_dict()))
        live.tx.load_state_dict(copy.deepcopy(src.tx.state_dict()))
        live.step = src.step
        live.dynamic_scale.load_state_dict(src.dynamic_scale.state_dict())
    assert [(id(t), t.data_ptr()) for t in _tensors(live)] == ids
    for a, b in zip(_tensors(live), _tensors(src)):
        assert torch.equal(a, b)
    fresh = train.create_train_state(cfg, 10, loss_scaling=True, seed=3,
                                     device="cpu")
    restore_checkpoint(ckpt, fresh)
    _, want = train.make_train_step(cfg, eager=True)(fresh, pts, labels)
    _, got = step(live, pts, labels)
    assert torch.equal(got, want)
    for a, b in zip(_tensors(live), _tensors(fresh)):
        assert torch.equal(a, b)


# --- augmentation draws and the step's host mirror ---------------------------------

def test_augmentation_draws_are_inputs_of_the_step(monkeypatch):
    """The draws fed to the step's program are `augment_draws(
    augment_generator(0, s))` of step s, a skipped step included; the
    host mirror and the device count move once a step."""
    # alpha 1000 and labels 10 off: a scale at the float32 maximum
    # overflows the gradients (tests/test_torch_train_pillar.py)
    cfg = GndNetConfig(**SMALL).replace(alpha=1000.0)
    pts, labels = _labelled(np.random.default_rng(5), cfg)
    labels = labels + 10.0
    state = train.create_train_state(cfg, 10, loss_scaling=True,
                                     device="cpu")
    step = train.make_train_step(cfg, augment=True)
    fed = []
    program = step.program

    def record(st, *tensors):
        fed.append([t.clone() for t in tensors[2:]])
        return program(st, *tensors)

    monkeypatch.setattr(step, "program", record)
    for s in range(3):
        state.dynamic_scale.scale = (float(np.finfo(np.float32).max)
                                     if s == 1 else 65536.0)
        step(state, pts, labels)
        assert state.step == int(state.step_t) == s + 1
    assert state.tx.count == 2     # step 1 was skipped
    for s, (ang, dz) in enumerate(fed):
        want = taug.augment_draws(taug.augment_generator(
            train.AUGMENT_SEED, s, "cpu"), 2, cfg)
        assert torch.equal(ang, want[0]) and torch.equal(dz, want[1]), s
    assert not torch.equal(fed[0][0], fed[1][0])


def test_cpu_programs_run_eagerly():
    """On the CPU the graphed programs run their functions: `infer_many`
    and the RMSE batch give their eager versions' bits, and count eager
    calls, no replay."""
    cfg = GndNetConfig(**SMALL).replace(lidar_height=1.7)
    engine = GroundInferenceEngine(cfg, init_state_dict(cfg, seed=0),
                                   bucket=512, device="cpu")
    rng = np.random.default_rng(6)
    scans = [synthetic_scan(cfg, rng, n) for n in (500, 450, 512)]
    for (a, b), (c, d) in zip(engine.infer_many(scans),
                              engine.infer_many(scans, eager=True)):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    assert engine._graphs.replays == 0 and engine._graphs.eager_calls == 1
    pts, labels = _labelled(rng, cfg)
    program = evaluate.batch_rmse_program(engine.model)
    assert isinstance(program, GraphCache)
    got = program(torch.from_numpy(pts), torch.from_numpy(labels))
    want = evaluate.batch_rmse_program(engine.model, eager=True)(
        torch.from_numpy(pts), torch.from_numpy(labels))
    assert got.shape == (2,) and torch.equal(got, want)
