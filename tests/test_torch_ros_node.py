"""The port's ROS2 node (`gndnet_tpu_torch/serving/ros_node.py`) against the
stub ROS2 stack of tests/test_ros_node.py: a real engine on the CPU from a
real reference checkpoint written from JAX variables, one synthetic
PointCloud2 through `callback`, all three publishers fire, and the published
labels are the engine's `infer` of the transformed, NaN-free cloud."""

import importlib
import sys
import time
import types

import numpy as np
import pytest
import torch

from gndnet_tpu_torch.io_shim import pointcloud2_to_numpy
from gndnet_tpu_torch.ops.transforms import (
    quaternion_from_euler,
    transform_cloud,
    transform_from_translation_quaternion,
)
from test_ros_node import _make_fake_modules, _make_msg, tiny_config

TRANSLATION = (0.5, -0.25, 0.1)
ROTATION = quaternion_from_euler(0.0, 0.0, 0.05)     # x, y, z, w


@pytest.fixture
def node_module(monkeypatch, tmp_path):
    """The port's ros_node reloaded with fake ROS2 modules, a real tiny
    checkpoint and a 'cpu' device parameter."""
    from gndnet_tpu.checkpoint import export_torch_state_dict
    from gndnet_tpu.checkpoint import import_torch_state_dict
    from gndnet_tpu_torch.config import GndNetConfig
    from gndnet_tpu_torch.weights import init_state_dict

    jcfg = tiny_config()
    cfg_path = tmp_path / "config.yaml"
    jcfg.to_yaml(str(cfg_path))
    cfg = GndNetConfig.from_yaml(str(cfg_path))
    variables = import_torch_state_dict(init_state_dict(cfg, seed=0), jcfg)
    ckpt_path = tmp_path / "model.pth.tar"
    torch.save({"state_dict": export_torch_state_dict(variables, jcfg),
                "epoch": 3, "lowest_loss": 0.25}, str(ckpt_path))

    publishers = {}
    overrides = {"model_path": str(ckpt_path), "config_path": str(cfg_path),
                 "target_frame": "base_link", "threshold": 0.16,
                 "device": "cpu"}
    fakes, PointCloud2 = _make_fake_modules(overrides, publishers)
    for name, mod in fakes.items():
        monkeypatch.setitem(sys.modules, name, mod)

    import gndnet_tpu_torch.serving.ros_node as ros_node

    module = importlib.reload(ros_node)
    assert module.HAVE_ROS
    yield module, publishers, PointCloud2, cfg, overrides
    for name in fakes:
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.undo()
    importlib.reload(ros_node)


class _Buffer:
    """A TF buffer that knows one transform."""

    def lookup_transform(self, target, source, stamp):
        t = types.SimpleNamespace(x=TRANSLATION[0], y=TRANSLATION[1],
                                  z=TRANSLATION[2])
        q = types.SimpleNamespace(x=ROTATION[0], y=ROTATION[1],
                                  z=ROTATION[2], w=ROTATION[3])
        return types.SimpleNamespace(transform=types.SimpleNamespace(
            translation=t, rotation=q))


def _labels_of(msg) -> np.ndarray:
    """{1, 0, -1} from the published red / green / blue colours."""
    rgb = pointcloud2_to_numpy(bytes(msg.data), msg.point_step,
                               msg.fields)["rgb"]
    return np.select([rgb[:, 0] == 255, rgb[:, 1] == 255], [1, 0],
                     -1).astype(np.int8)


@pytest.mark.parametrize("frame", ["base_link", "velodyne"])
def test_node_callback_publishes_all_topics(node_module, frame):
    module, publishers, PointCloud2, cfg, _ = node_module
    node = module.GndNetNode()
    try:
        assert node.engine.compile_seconds > 0
        assert node.engine.engine.device == torch.device("cpu")
        node.tf_buffer = _Buffer()
        msg, cloud = _make_msg(PointCloud2, cfg, frame)
        if frame != "base_link":
            m = transform_from_translation_quaternion(TRANSLATION, ROTATION)
            cloud = transform_cloud(cloud, m)
        cloud = cloud[~np.isnan(cloud).any(axis=1)]

        # the free-wheeling engine may publish one frame stale: call again
        # until a result lands (every call carries the same cloud)
        deadline = time.time() + 30
        while time.time() < deadline:
            node.callback(msg)
            if publishers["/gndnet/segmented"].published:
                break
            time.sleep(0.05)

        seg = publishers["/gndnet/segmented"].published
        obs = publishers["/gndnet/obstacles"].published
        marker = publishers["/gndnet/ground"].published
        assert seg and obs and marker
        out = seg[-1]
        assert out.header.frame_id == "base_link"
        assert out.point_step == 16
        assert [f.name for f in out.fields] == ["x", "y", "z", "rgb"]
        assert out.width == cloud.shape[0] == 199
        xyz = pointcloud2_to_numpy(bytes(out.data), 16, out.fields)["xyz"]
        np.testing.assert_array_equal(xyz, cloud)
        elevation, labels = node.engine.engine.infer(cloud)
        np.testing.assert_array_equal(_labels_of(out), labels)
        assert obs[-1].point_step == 12
        assert obs[-1].width == int((labels == 1).sum())
        m = marker[-1]
        assert m.type == m.LINE_LIST
        assert len(m.points) > 0 and len(m.points) % 2 == 0
        assert all(np.isfinite(p.z) for p in m.points)
        assert node.engine.errors == 0
    finally:
        node.engine.stop()


def test_node_drops_frame_on_tf_failure(node_module):
    module, publishers, PointCloud2, cfg, _ = node_module
    node = module.GndNetNode()
    try:
        msg, _ = _make_msg(PointCloud2, cfg, "some_other_frame")
        node.callback(msg)      # TF lookup raises -> warn + drop (ref :259-261)
        assert node.get_logger().warnings
        assert not publishers["/gndnet/segmented"].published
        assert node.engine.processed == 0 and node.engine.latest() is None
    finally:
        node.engine.stop()


def test_node_writes_and_loads_the_aot_artifact(node_module, tmp_path):
    """With aot_path set and no file there, the node writes the artifact,
    then serves from it (a CPU engine records its shape, no graph)."""
    module, _, _, cfg, overrides = node_module
    path = tmp_path / "engine.aot"
    overrides["aot_path"] = str(path)
    overrides["compilation_cache_dir"] = str(tmp_path / "kernels")
    from gndnet_tpu_torch import _ext

    build_dir = _ext.BUILD_DIR
    node = module.GndNetNode()
    try:
        assert path.exists()
        engine = node.engine.engine
        assert engine._graph == (tuple(engine._example_input().shape), None)
        assert _ext.BUILD_DIR == str(tmp_path / "kernels")
    finally:
        node.engine.stop()
        _ext.BUILD_DIR = build_dir


def test_resolve_env(monkeypatch):
    from gndnet_tpu_torch.serving.ros_node import resolve_env

    monkeypatch.setenv("GITDIR", "/srv/git")
    assert resolve_env("$GITDIR/model.pth") == "/srv/git/model.pth"
    assert resolve_env("~").startswith("/")
    assert resolve_env("plain/path") == "plain/path"
