"""ROS2 deployment node (optional adapter; import-gated on rclpy).

Counterpart of `gndnet_tpu.serving.ros_node`, the reference's GndNetNode
(reference: ros_node.py:141-296) on the port: declared parameters, TF2
transform into the target frame, NaN filtering, async hand-off to a
free-wheeling inference thread, and publication of the elevation-grid marker
+ segmented cloud + obstacle-only cloud gated on subscriber count.  All
compute lives in the ROS-free core (infer.StreamingEngine, io_shim); this
file only marshals messages.  The engine runs on the card unless the `device`
parameter says 'cpu'.

Environment-variable path resolution ($HOME/~/$GITDIR) follows reference
ros_node.py:32-49.
"""

from __future__ import annotations

import os

import numpy as np

from gndnet_tpu_torch.checkpoint import load_torch_checkpoint
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.infer import GroundInferenceEngine, StreamingEngine
from gndnet_tpu_torch.io_shim import (
    elevation_grid_lines,
    numpy_to_pointcloud2,
    pointcloud2_to_numpy,
)
from gndnet_tpu_torch.ops.transforms import (
    transform_cloud,
    transform_from_translation_quaternion,
)

try:  # pragma: no cover - exercised only in a ROS2 environment
    import rclpy
    from rclpy.node import Node

    HAVE_ROS = True
except ImportError:  # pragma: no cover
    HAVE_ROS = False
    Node = object


def resolve_env(path: str) -> str:
    """Expand ~, $HOME and $GITDIR-style variables in configured paths
    (reference resolveEnv, ros_node.py:32-49)."""
    return os.path.expandvars(os.path.expanduser(path))


class GndNetNode(Node):  # pragma: no cover - needs rclpy at runtime
    """Streaming ground-segmentation node.

    Parameters (reference ros_node.py:144-160): model_path, config_path,
    input_topic, output_topic_*, target_frame, threshold; and device,
    compilation_cache_dir and aot_path."""

    def __init__(self):
        if not HAVE_ROS:
            raise ImportError("rclpy is not available; GndNetNode needs ROS2")
        super().__init__("gndnet_tpu_torch")
        from sensor_msgs.msg import PointCloud2
        from visualization_msgs.msg import Marker
        import tf2_ros

        self.declare_parameter("model_path", "")
        self.declare_parameter("config_path", "")
        self.declare_parameter("input_topic", "/points")
        self.declare_parameter("output_cloud_topic", "/gndnet/segmented")
        self.declare_parameter("output_obstacles_topic", "/gndnet/obstacles")
        self.declare_parameter("output_marker_topic", "/gndnet/ground")
        self.declare_parameter("target_frame", "base_link")
        self.declare_parameter("threshold", 0.16)
        self.declare_parameter("device", "cuda")
        # warm start (utils/compile_cache.py): a persistent directory of the
        # built kernels, and an AOT artifact, written if absent, from which
        # the engine captures one CUDA graph of a scan before serving
        self.declare_parameter("compilation_cache_dir", "")
        self.declare_parameter("aot_path", "")

        cache_dir = resolve_env(
            str(self.get_parameter("compilation_cache_dir").value))
        if cache_dir:
            from gndnet_tpu_torch.utils.compile_cache import (
                enable_compilation_cache,
            )

            enable_compilation_cache(cache_dir)

        cfg_path = resolve_env(str(self.get_parameter("config_path").value))
        self.cfg = GndNetConfig.from_yaml(cfg_path)
        model_path = resolve_env(str(self.get_parameter("model_path").value))
        ckpt = load_torch_checkpoint(model_path, self.cfg)
        engine = GroundInferenceEngine(
            self.cfg, ckpt["state_dict"],
            threshold=float(self.get_parameter("threshold").value),
            shift_cloud=self.cfg.shift_cloud,
            device=str(self.get_parameter("device").value))
        aot_path = resolve_env(str(self.get_parameter("aot_path").value))
        if aot_path:
            if not os.path.exists(aot_path):
                size = engine.aot_save(aot_path)
                self.get_logger().info(
                    f"wrote AOT artifact {aot_path} ({size} bytes)")
            # before the streaming thread starts: nothing else on the card
            engine.aot_load(aot_path)
            self.get_logger().info(f"serving from AOT artifact {aot_path}")
        self.engine = StreamingEngine(engine, warmup=True).start()
        self.get_logger().info(
            f"engine warmed up in {self.engine.compile_seconds:.1f}s")

        self.target_frame = str(self.get_parameter("target_frame").value)
        self.tf_buffer = tf2_ros.Buffer()
        self.tf_listener = tf2_ros.TransformListener(self.tf_buffer, self)

        self.pub_cloud = self.create_publisher(
            PointCloud2, str(self.get_parameter("output_cloud_topic").value), 1)
        self.pub_obstacles = self.create_publisher(
            PointCloud2,
            str(self.get_parameter("output_obstacles_topic").value), 1)
        self.pub_marker = self.create_publisher(
            Marker, str(self.get_parameter("output_marker_topic").value), 1)
        self.sub = self.create_subscription(
            PointCloud2, str(self.get_parameter("input_topic").value),
            self.callback, 1)

    def callback(self, msg):
        decoded = pointcloud2_to_numpy(bytes(msg.data), msg.point_step,
                                       msg.fields)
        cloud = decoded["xyz"]
        if msg.header.frame_id != self.target_frame:
            try:
                ts = self.tf_buffer.lookup_transform(
                    self.target_frame, msg.header.frame_id, msg.header.stamp)
                t = ts.transform.translation
                q = ts.transform.rotation
                m = transform_from_translation_quaternion(
                    (t.x, t.y, t.z), (q.x, q.y, q.z, q.w))
                cloud = transform_cloud(cloud, m)
            except Exception as e:  # drop frame on TF failure (ref :259-261)
                self.get_logger().warning(f"TF lookup failed: {e}")
                return
        cloud = cloud[~np.isnan(cloud).any(axis=1)]
        if cloud.shape[0] == 0:
            return

        self.engine.submit(cloud)
        out = self.engine.latest()   # possibly one frame stale (ref :268-270)
        if out is None:
            return
        _, elevation, labels = out
        n = min(len(labels), cloud.shape[0])

        if self.pub_cloud.get_subscription_count() > 0:
            self._publish_cloud(self.pub_cloud, cloud[:n], labels[:n],
                                msg.header)
        if self.pub_obstacles.get_subscription_count() > 0:
            obs = cloud[:n][labels[:n] == 1]
            self._publish_cloud(self.pub_obstacles, obs, None, msg.header)
        if self.pub_marker.get_subscription_count() > 0:
            self._publish_marker(elevation, msg.header)

    def _publish_cloud(self, pub, cloud, labels, header):
        from sensor_msgs.msg import PointCloud2, PointField

        enc = numpy_to_pointcloud2(cloud[:, :3], rgb_labels=labels)
        msg = PointCloud2()
        msg.header = header
        msg.header.frame_id = self.target_frame
        msg.height = 1
        msg.width = enc["width"]
        msg.point_step = enc["point_step"]
        msg.row_step = enc["point_step"] * enc["width"]
        msg.is_dense = True
        msg.fields = [
            PointField(name=f.name, offset=f.offset, datatype=PointField.FLOAT32,
                       count=1) for f in enc["fields"]]
        msg.data = enc["data"]
        pub.publish(msg)

    def _publish_marker(self, elevation, header):
        from visualization_msgs.msg import Marker

        segs = elevation_grid_lines(elevation, self.cfg)
        m = Marker()
        m.header = header
        m.header.frame_id = self.target_frame
        m.type = Marker.LINE_LIST
        m.scale.x = 0.05
        m.color.r, m.color.g, m.color.a = 1.0, 0.0, 1.0
        from geometry_msgs.msg import Point

        for a, b in segs:
            m.points.append(Point(x=float(a[0]), y=float(a[1]), z=float(a[2])))
            m.points.append(Point(x=float(b[0]), y=float(b[1]), z=float(b[2])))
        self.pub_marker.publish(m)


def main(args=None):  # pragma: no cover
    rclpy.init(args=args)
    node = GndNetNode()
    rclpy.spin(node)


if __name__ == "__main__":  # pragma: no cover
    main()
