"""Typed configuration for gndnet_tpu_torch.

The port's own copy of `gndnet_tpu.config` (same fields, presets, validation
and YAML loader), kept separate so that the PyTorch package imports nothing
of the JAX package.  A single frozen dataclass replaces the reference's
per-script ``yaml.load`` + ``ConfigClass(**dict)`` attr-wrapper (reference:
training.py:72-84, predict_ground.py:70-74, ros_node.py:162-176).  The key
schema is the union of all shipped reference presets
(config/config_kittiSem.yaml, config/config_camera.yaml,
config/config_custom_local.yaml), with validation and derived grid geometry
that the reference recomputes ad hoc (model.py:26-28).

Fields that only the JAX package reads (``dp_axis``, ``sp_axis``) stay so
that one YAML file configures both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import yaml


def _tuple(x: Sequence[float] | None, n: int, name: str) -> tuple:
    if x is None:
        raise ValueError(f"config field {name!r} is required")
    t = tuple(x)
    if len(t) != n:
        raise ValueError(f"config field {name!r} must have {n} entries, got {len(t)}")
    return t


@dataclasses.dataclass(frozen=True)
class AugmentationConfig:
    """Augmentation parameters (reference: dataset_augmentation.py:8-41 and the
    `augmentation parameters` block of config/config_camera.yaml:34-47)."""

    keep_original: bool = False
    num_rotations: int = 0
    num_height_var: int = 0
    num_noise_var: int = 0
    max_front_slope: float = 5.0   # degrees, rotation about y ('x' euler slot)
    max_side_tilt: float = 0.0     # degrees
    max_rotation: float = 0.0      # degrees, yaw
    max_height: float = 0.0        # metres
    noise_coefficient_top: tuple = (0.0, 0.0)
    noise_coefficient_bottom: tuple = (0.4, 0.6)
    noise_min_distance: tuple = (1.2, 4.0)
    noise_density_top: tuple = (1.0, 50.0)
    noise_density_bottom: tuple = (1.0, 50.0)

    @property
    def num_augmentations(self) -> int:
        return self.num_rotations + self.num_height_var + int(self.keep_original)


@dataclasses.dataclass(frozen=True)
class DataPrepConfig:
    """Ground-truth generation parameters (reference:
    config/config_camera.yaml:49-53, semKitti_morph_data_camera.py:316-371)."""

    frame_step: int = 1
    frames_per_block: int = 50
    num_workers: int = 4
    out_dir: str = ""
    camera_fov: bool = False
    fov_degrees: float = 115.0
    fov_aspect_ratio: float = 16.0 / 9.0
    fov_near: float = 0.1
    fov_far: float = 10.0


@dataclasses.dataclass(frozen=True)
class GndNetConfig:
    """Full model/pipeline configuration.

    Field names mirror the reference YAML keys one-to-one so existing config
    files load unchanged (see `from_yaml`).  Reference key inventory:
    SURVEY.md section 5 "config system".
    """

    # --- data ---
    data_dir: str = "data/"
    shift_cloud: bool = True
    lidar_height: float = 1.733
    num_points: int = 100000

    # --- geometry ---
    grid_range: tuple = (-50.0, -50.0, 50.0, 50.0)       # xmin ymin xmax ymax
    pc_range: tuple = (-47.0, -50.0, -4.0, 53.0, 50.0, 4.0)  # xyzxyz minmax
    voxel_size: tuple = (1.0, 1.0, 8.0)
    max_points_voxel: int = 100
    max_voxels: int = 10000
    input_features: int = 4

    # --- train ---
    batch_size: int = 2
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 0.0005
    epochs: int = 120
    use_norm: bool = False
    clip: float = 0.25          # clip norm; the reference declares but never
                                # applies it (training.py:164-165 commented) —
                                # enable with use_grad_clip
    use_grad_clip: bool = False
    max_memory: float = 4000.0  # MiB budget for the in-RAM dataset cache

    # LR schedule (reference: training.py:100 StepLR(step_size=15, gamma=0.8))
    lr_step_size: int = 15
    lr_gamma: float = 0.8

    # --- pillar feature net ---
    vfe_filters: tuple = (64,)
    with_distance: bool = False

    # --- loss ---
    alpha: float = 0.9   # per-cell SmoothL1 weight
    beta: float = 0.1    # spatial smoothness weight

    # --- compute settings (new; no reference analog) ---
    compute_dtype: str = "float32"   # 'float32' | 'bfloat16' for conv compute
    matmul_precision: str = "highest"  # 'highest' = reference-parity f32
                                       # (no TF32 in f32 convs),
                                       # 'default' = the fast setting
    fused_impl: str = "scatter"      # 'scatter' (XLA segment ops; the
                                     # bit-stable parity anchor),
                                     # 'affine' (round-2 fast path: sort +
                                     # segmented scans + affine PFN split;
                                     # same math to float re-association),
                                     # or 'sorted' (experimental pallas
                                     # suffix reduces; see docs/STATUS.md)
    exact_point_cap: bool = True     # reference-exact per-pillar point cap;
                                     # False skips the rank sort on the fused
                                     # path (reduce over ALL in-range points)
    dp_axis: int = 1                 # data-parallel mesh size (1 = off)
    sp_axis: int = 1                 # spatial-parallel mesh size (1 = off)

    # --- sub-configs ---
    augmentation: AugmentationConfig = dataclasses.field(default_factory=AugmentationConfig)
    data_prep: DataPrepConfig = dataclasses.field(default_factory=DataPrepConfig)

    def __post_init__(self):
        object.__setattr__(self, "grid_range", _tuple(self.grid_range, 4, "grid_range"))
        object.__setattr__(self, "pc_range", _tuple(self.pc_range, 6, "pc_range"))
        object.__setattr__(self, "voxel_size", _tuple(self.voxel_size, 3, "voxel_size"))
        object.__setattr__(self, "vfe_filters", tuple(self.vfe_filters))
        if self.max_points_voxel <= 0 or self.max_voxels <= 0:
            raise ValueError("max_points_voxel and max_voxels must be positive")
        if self.input_features < 3:
            raise ValueError("input_features must be >= 3 (xyz)")
        if self.fused_impl not in ("scatter", "affine", "sorted"):
            raise ValueError(f"unsupported fused_impl {self.fused_impl!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported compute_dtype {self.compute_dtype!r}")
        for i in range(3):
            extent = self.pc_range[3 + i] - self.pc_range[i]
            if extent <= 0:
                raise ValueError(f"pc_range extent {i} must be positive")
            if self.voxel_size[i] <= 0:
                raise ValueError("voxel_size entries must be positive")

    # --- derived geometry (reference: model.py:26-28) ---

    @property
    def grid_size(self) -> tuple:
        """(nx, ny, nz) cells, matching np.round of extent/voxel."""
        return tuple(
            int(round((self.pc_range[3 + i] - self.pc_range[i]) / self.voxel_size[i]))
            for i in range(3)
        )

    @property
    def nx(self) -> int:
        return self.grid_size[0]

    @property
    def ny(self) -> int:
        return self.grid_size[1]

    @property
    def nz(self) -> int:
        return self.grid_size[2]

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny

    @property
    def num_decorated_features(self) -> int:
        """PFN input width: raw features + cluster offset (3) + center offset (2)
        [+ distance] (reference: modules/pointpillars.py:91-93)."""
        return self.input_features + 5 + (1 if self.with_distance else 0)

    # --- IO ---

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "GndNetConfig":
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        aug_keys = {
            "keep_original": "keep_original",
            "num_rotations": "num_rotations",
            "num_height_var": "num_height_var",
            "num_noise_var": "num_noise_var",
            "maxFrontSlope": "max_front_slope",
            "maxSideTild": "max_side_tilt",
            "maxRotation": "max_rotation",
            "maxHeight": "max_height",
            "noise_coefficient_top": "noise_coefficient_top",
            "noise_coefficient_bottom": "noise_coefficient_bottom",
            "noise_min_distance": "noise_min_distance",
            "noise_density_top": "noise_density_top",
            "noise_density_bottom": "noise_density_bottom",
        }
        prep_keys = {
            "frame_step": "frame_step",
            "frames_per_block": "frames_per_block",
            "num_workers": "num_workers",
            "out_dir": "out_dir",
        }
        aug_kwargs, prep_kwargs, core = {}, {}, {}
        for k, v in d.items():
            if k in aug_keys:
                if isinstance(v, list):
                    v = tuple(v)
                aug_kwargs[aug_keys[k]] = v
            elif k in prep_keys:
                prep_kwargs[prep_keys[k]] = v
            elif k in known:
                core[k] = v
            # unknown keys ignored, mirroring ConfigClass' permissiveness
        if aug_kwargs:
            core["augmentation"] = AugmentationConfig(**aug_kwargs)
        if prep_kwargs:
            core["data_prep"] = DataPrepConfig(**prep_kwargs)
        return cls(**core)

    @classmethod
    def from_yaml(cls, path: str) -> "GndNetConfig":
        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_yaml(self, path: str) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    def replace(self, **kwargs) -> "GndNetConfig":
        return dataclasses.replace(self, **kwargs)


# Preset equivalents of the reference's shipped YAMLs.

def kitti_sem_config() -> GndNetConfig:
    """Equivalent of reference config/config_kittiSem.yaml (100x100 @ 1 m)."""
    return GndNetConfig()


def camera_config() -> GndNetConfig:
    """Equivalent of reference config/config_camera.yaml (50x50 @ 0.2 m FOV extract)."""
    return GndNetConfig(
        data_dir="data/training/000",
        num_points=10000,
        grid_range=(0.0, -5.0, 10.0, 5.0),
        pc_range=(0.0, -5.0, -4.0, 10.0, 5.0, 4.0),
        voxel_size=(0.2, 0.2, 8.0),
        max_voxels=2500,
        input_features=3,
        augmentation=AugmentationConfig(
            num_rotations=4, num_height_var=1, num_noise_var=1,
            max_front_slope=5.0, max_side_tilt=5.0, max_rotation=180.0,
            max_height=0.5,
            noise_coefficient_top=(0.0, 0.0), noise_coefficient_bottom=(0.0, 0.6),
            noise_min_distance=(0.0, 5.0),
            noise_density_top=(0.1, 50.0), noise_density_bottom=(0.1, 50.0),
        ),
        data_prep=DataPrepConfig(frame_step=2, frames_per_block=50, num_workers=10),
    )


def custom_local_config() -> GndNetConfig:
    """Equivalent of reference config/config_custom_local.yaml (50x50 @ 0.4 m)."""
    return GndNetConfig(
        data_dir="data/training/000",
        grid_range=(-10.0, -10.0, 10.0, 10.0),
        pc_range=(-10.0, -10.0, -4.0, 10.0, 10.0, 4.0),
        voxel_size=(0.4, 0.4, 8.0),
        max_voxels=2500,
        input_features=3,
        augmentation=AugmentationConfig(
            num_rotations=1, num_height_var=2,
            max_front_slope=5.0, max_side_tilt=5.0, max_height=3.0,
        ),
    )


def fine_grid_config() -> GndNetConfig:
    """Fine-grid stress config: 0.4 m cells, 250x250 pseudo-image
    (BASELINE.md config #3; no identical reference preset)."""
    return GndNetConfig(
        pc_range=(-50.0, -50.0, -4.0, 50.0, 50.0, 4.0),
        grid_range=(-50.0, -50.0, 50.0, 50.0),
        voxel_size=(0.4, 0.4, 8.0),
        max_voxels=20000,
    )


def sparse_32beam_config() -> GndNetConfig:
    """32-beam sparse-cloud config (BASELINE.md config #5): the
    kitti_sem grid fed with beam-decimated scans (io_shim.subsample_beams
    halves a 64-beam KITTI sweep), trained with on-device augmentation
    (train.make_train_step(augment=True)).  Half the points, same grid."""
    return GndNetConfig(num_points=50000)


PRESETS = {
    "kitti_sem": kitti_sem_config,
    "camera": camera_config,
    "custom_local": custom_local_config,
    "fine_grid": fine_grid_config,
    "sparse_32beam": sparse_32beam_config,
}


def load_config(name_or_path: str) -> GndNetConfig:
    """Load a preset by name or a YAML file by path."""
    if name_or_path in PRESETS:
        return PRESETS[name_or_path]()
    return GndNetConfig.from_yaml(name_or_path)
