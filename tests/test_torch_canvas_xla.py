"""The port's affine canvas against the JAX `affine_canvas` XLA path
(use_pallas=False), whose float32 segmented-scan graph takes most of this
file's time to compile."""

import numpy as np

from test_torch_pillarize import _canvases, _cloud, _geoms


def test_canvas_matches_xla_path():
    pts = _cloud(np.random.default_rng(4), _geoms("16x16")[0], 1000)
    got, want = _canvases(pts, "16x16", xla=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
