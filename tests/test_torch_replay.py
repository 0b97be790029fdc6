"""The port's streaming replay harness (`serving/replay.py`) on the CPU,
against the JAX package's `serving/replay.py` on the same engine weights:
free-wheeling runs process every scan with zero drops, and a paced,
overloaded run drops frames instead of queueing them."""

import time

import numpy as np
import pytest

from gndnet_tpu.checkpoint import import_torch_state_dict
from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.infer import GroundInferenceEngine as JaxEngine
from gndnet_tpu.serving.replay import replay as jax_replay
from gndnet_tpu.serving.replay import replay_device as jax_replay_device
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.infer import GroundInferenceEngine
from gndnet_tpu_torch.serving.replay import ReplayReport, replay, replay_device
from gndnet_tpu_torch.weights import init_state_dict

# the config of tests/test_replay.py
CFG = dict(pc_range=(0.0, -8.0, -4.0, 16.0, 8.0, 4.0),
           grid_range=(0.0, -8.0, 16.0, 8.0), voxel_size=(1.0, 1.0, 8.0),
           max_points_voxel=10, max_voxels=128, input_features=4,
           num_points=256)


@pytest.fixture(scope="module")
def engines():
    cfg = GndNetConfig(**CFG)
    sd = init_state_dict(cfg, seed=0)
    jcfg = JaxConfig(**CFG)
    return (JaxEngine(jcfg, import_torch_state_dict(sd, jcfg), bucket=256),
            GroundInferenceEngine(cfg, sd, bucket=256, device="cpu"))


def scans(seed, k=4, n=250):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        s = np.zeros((n, 4), np.float32)
        s[:, 0] = rng.uniform(0.2, 15.8, n)
        s[:, 1] = rng.uniform(-7.8, 7.8, n)
        s[:, 2] = rng.uniform(-2, 0, n)
        out.append(s)
    return out


def _counts(rep):
    return rep.scans_submitted, rep.scans_processed, rep.drop_fraction


def test_feedforward_replay_matches_jax(engines):
    jeng, teng = engines
    rep = replay(teng, scans(0), target_hz=0.0, repeat=2)
    assert isinstance(rep, ReplayReport)
    assert _counts(rep) == (8, 8, 0.0)
    assert _counts(rep) == _counts(jax_replay(jeng, scans(0), target_hz=0.0,
                                              repeat=2))
    assert rep.sustained_hz > 0 and rep.latency_ms_p50 > 0
    assert rep.compile_seconds > 0
    assert rep.as_dict().keys() == ReplayReport.__dataclass_fields__.keys()


def test_device_replay_freewheel_matches_jax(engines):
    """Staged scans, host submit clock and host fetch: free-wheeling
    processes every tick with zero drops, as JAX's does."""
    jeng, teng = engines
    rep = replay_device(teng, scans(1)[0], target_hz=0.0, n_ticks=12, ring=4)
    want = jax_replay_device(jeng, scans(1)[0], target_hz=0.0, n_ticks=12,
                             ring=4)
    assert _counts(rep) == _counts(want) == (12, 12, 0.0)
    assert rep.sustained_hz > 0
    assert rep.latency_ms_p99 >= rep.latency_ms_p50 > 0


@pytest.mark.parametrize("transfer_dtype", ["float32", "int16"])
def test_device_replay_paced(engines, transfer_dtype):
    """A sensible rate sustains; an absurd one never queues beyond the
    ticks (the ring's jitter works for both transfer types)."""
    _, teng = engines
    if transfer_dtype != "float32":
        teng = GroundInferenceEngine(teng.cfg, teng.model.state_dict(),
                                     bucket=256, transfer_dtype="int16",
                                     device="cpu")
    rep = replay_device(teng, scans(2)[0], target_hz=20.0, n_ticks=20,
                        ring=4)
    assert rep.scans_submitted == 20
    assert 1 <= rep.scans_processed
    assert rep.scans_processed + round(rep.drop_fraction * 20) == 20
    fast = replay_device(teng, scans(2)[0], target_hz=5000.0, n_ticks=40,
                         ring=4)
    assert 1 <= fast.scans_processed
    assert fast.scans_processed + round(fast.drop_fraction * 40) == 40


def test_paced_replay_drops_when_overloaded(engines, monkeypatch):
    """At 2000 Hz against an engine that takes at least 20 ms a scan, the
    mailbox drops stale scans rather than queueing them (latest-value
    semantics): far fewer processed than submitted, and the newest scan
    among them.  JAX's replay on the same feed drops too."""
    jeng, teng = engines
    run = teng.infer

    def slow_infer(points):
        time.sleep(0.02)
        return run(points)

    monkeypatch.setattr(teng, "infer", slow_infer)
    feed = scans(3, k=30)
    rep = replay(teng, feed, target_hz=2000.0, repeat=1)
    assert rep.scans_submitted == 30
    assert 1 <= rep.scans_processed <= 10
    assert rep.drop_fraction >= 2 / 3
    want = jax_replay(jeng, feed, target_hz=2000.0, repeat=1)
    assert want.scans_submitted == 30 and want.scans_processed <= 30
