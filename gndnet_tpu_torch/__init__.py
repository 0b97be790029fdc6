"""gndnet_tpu_torch: the PyTorch/CUDA port of gndnet_tpu for NVIDIA Hopper.

Serving (kitti_sem-style single-scan inference through the affine pillar
canvas) and batched training (`train.py`) run on the card, with the sort,
cell-count, capped-scan, argmax-scan and d(mmat) kernels written by hand
in CUDA (`csrc/`).  The package imports nothing of JAX or of `gndnet_tpu`;
that package stays the reference it is tested against.
"""

from gndnet_tpu_torch.config import GndNetConfig, load_config  # noqa: F401
