"""Training parts of the port against the JAX package on the CPU: the
losses, the optimizer chain, train-mode batch norm and the pool's tie
gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu import losses as jlosses
from gndnet_tpu import train as jtrain
from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.models.segnet import ConvBNRelu as JaxConvBNRelu
from gndnet_tpu.ops.pooling import max_pool_argmax as jax_pool
from gndnet_tpu_torch import losses, train
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.models.segnet import ConvBNRelu
from gndnet_tpu_torch.ops.pooling import max_pool_argmax


# --- losses -----------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(0)
    a = (rng.normal(size=(2, 12, 9)) * 2).astype(np.float32)
    b = rng.normal(size=(2, 12, 9)).astype(np.float32)
    m = (rng.uniform(size=(2, 12, 9)) > 0.4).astype(np.float32)
    ta, tb, tm = (torch.from_numpy(v) for v in (a, b, m))
    ja, jb, jm = (jnp.asarray(v) for v in (a, b, m))
    pairs = [(losses.smooth_l1(ta, tb), jlosses.smooth_l1(ja, jb)),
             (losses.spatial_smooth_loss(ta),
              jlosses.spatial_smooth_loss(ja)),
             (losses.masked_huber_loss(ta, tb, tm),
              jlosses.masked_huber_loss(ja, jb, jm)),
             (losses.total_loss(ta, tb, 0.7, 0.3),
              jlosses.total_loss(ja, jb, 0.7, 0.3))]
    for got, want in pairs:
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    ta.requires_grad_(True)
    losses.total_loss(ta, tb).backward()
    want = jax.grad(lambda p: jlosses.total_loss(p, jb))(ja)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-8)


# --- optimizer --------------------------------------------------------------

@pytest.mark.parametrize("clip", [False, True])
def test_optimizer_matches_optax_chain(clip):
    """SGD + momentum + weight decay + StepLR (+ global-norm clip) against
    `make_optimizer` over 2 epochs of 3 steps with the rate halving each
    epoch; parameters within rtol 1e-6 after every step."""
    kw = dict(lr=0.1, momentum=0.9, weight_decay=5e-4, lr_step_size=1,
              lr_gamma=0.5, use_grad_clip=clip, clip=1.5)
    rng = np.random.default_rng(3)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=3).astype(np.float32)}
    tx = jtrain.make_optimizer(JaxConfig(**kw), steps_per_epoch=3)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = train.make_optimizer(GndNetConfig(**kw), tparams.values(), 3)
    clipped = 0
    for _ in range(6):
        grads = {k: (rng.normal(size=v.shape) * 0.8).astype(np.float32)
                 for k, v in params.items()}
        clipped += np.sqrt(sum((g**2).sum() for g in grads.values())) > 1.5
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, opt_state,
            jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7)
    # the rate applied: float32, as the JAX package's traced schedule
    assert opt.count == 6 and opt.lr == float(np.float32(0.1) * np.float32(0.5))
    assert (clipped > 0) == clip or not clip


# --- batch norm and pooling --------------------------------------------------

def test_train_batch_norm_matches_flax():
    """Two train-mode calls: output and running statistics as flax's
    BatchNorm(momentum 0.9) gives them, the biased variance stored."""
    rng = np.random.default_rng(5)
    x1, x2 = ((rng.normal(size=(2, 6, 5, 3)) * 2 + 1).astype(np.float32)
              for _ in range(2))
    jmod = JaxConvBNRelu(8)
    variables = jax.tree_util.tree_map(
        np.array, jmod.init(jax.random.PRNGKey(0), jnp.asarray(x1)))
    variables["params"]["bn"]["scale"] = rng.uniform(0.5, 1.5, 8).astype(
        np.float32)
    variables["params"]["bn"]["bias"] = rng.normal(size=8).astype(np.float32)
    mod = ConvBNRelu(3, 8)
    p = variables["params"]
    sd = {"cbr_unit.0.weight": p["conv"]["kernel"].transpose(3, 2, 0, 1),
          "cbr_unit.0.bias": p["conv"]["bias"],
          "cbr_unit.1.weight": p["bn"]["scale"],
          "cbr_unit.1.bias": p["bn"]["bias"],
          "cbr_unit.1.running_mean": np.zeros(8, np.float32),
          "cbr_unit.1.running_var": np.ones(8, np.float32)}
    mod.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in sd.items()}, strict=False)
    for x in (x1, x2):
        want, mut = jmod.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        variables = {"params": variables["params"], **mut}
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)
    bn = mod.cbr_unit[1]
    stats = variables["batch_stats"]["bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"],
                               rtol=1e-5, atol=1e-6)
    assert int(bn.num_batches_tracked) == 2


def test_pool_tie_gradient_matches_jax():
    """Tied maxima share a window's cotangent equally, as jnp.max's
    gradient does ([1, 1, 0.5, 1] -> [1/3, 1/3, 0, 1/3]); odd trailing
    rows and columns get none."""
    rng = np.random.default_rng(6)
    x = np.round(rng.normal(size=(2, 7, 9, 3)), 1).astype(np.float32)
    x[0, :2, :2, 0] = [[1.0, 1.0], [0.5, 1.0]]
    x[1, 2:4, 2:4, 1] = 0.0
    w = rng.normal(size=(2, 3, 4, 3)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jax_pool(v)[0] * w))(jnp.asarray(x))
    t = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    pooled, idx = max_pool_argmax(t)
    (pooled * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    got = t.grad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[0, :2, :2, 0] / w[0, 0, 0, 0],
                               [[1 / 3, 1 / 3], [0, 1 / 3]], rtol=1e-6)
    assert idx.requires_grad is False
