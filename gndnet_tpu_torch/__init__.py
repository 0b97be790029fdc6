"""gndnet_tpu_torch: the PyTorch/CUDA port of gndnet_tpu for NVIDIA Hopper.

The serving path (kitti_sem-style single-scan inference through the affine
pillar canvas) runs on the card, with the sort, cell-count and capped-scan
kernels written by hand in CUDA (`csrc/`).  The package imports nothing of
JAX or of `gndnet_tpu`; that package stays the reference it is tested
against.
"""

from gndnet_tpu_torch.config import GndNetConfig, load_config  # noqa: F401
