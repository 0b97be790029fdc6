"""K3 with its run ends: the plain version (the CPU path, and the oracle the
cluster kernel is held against on the card) against the JAX package's
`histogram_ends` with its Pallas histogram in interpret mode, and the
kernel's size rule (which grids one cluster counts in shared memory, which
take the global route)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu.ops.pallas_affine import histogram_ends as jax_histogram_ends
from gndnet_tpu_torch.ops import affine


@pytest.mark.parametrize("ny,nx", [(10, 13), (250, 250)])
def test_batched_ends_match_pallas_histogram_ends(ny, nx):
    """B=2 sorted streams of 3000 ids (two Pallas chunks, the second
    padded): item 0 without cell 0 (its end clamps at 0) and with a run
    of 1200 equal ids, item 1 all drop ids.  Ends and counts equal the
    JAX package's; the CPU wrappers launch nothing."""
    rng = np.random.default_rng(ny)
    nc = ny * nx
    ids = np.sort(rng.integers(1, nc + 1, (2, 3000)), axis=1).astype(np.int32)
    ids[0, 900:2100] = ids[0, 900]
    ids[0] = np.sort(ids[0])
    ids[1] = nc
    want_ends, want_counts = jax_histogram_ends(jnp.asarray(ids), ny, nx,
                                                use_pallas=True,
                                                interpret=True)
    before = affine.cell_histogram.launches
    ends, counts = affine.histogram_ends(torch.from_numpy(ids), ny, nx)
    alone = affine.histogram_counts(torch.from_numpy(ids), ny, nx)
    assert affine.cell_histogram.launches == before
    assert ends.dtype == counts.dtype == torch.int32
    assert ends.shape == counts.shape == (2, nc)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(ends.numpy(), np.asarray(want_ends))
    np.testing.assert_array_equal(alone.reshape(2, nc).numpy(),
                                  np.asarray(want_counts))
    assert int(counts[0, 0]) == 0 and int(ends[0, 0]) == 0
    assert int(counts[1].sum()) == 0 and int(ends[1].max()) == 0
    assert int(counts[0].max()) >= 1200


@pytest.mark.parametrize("ny,nx,route", [
    (10, 13, "cluster"),                      # a test grid
    (50, 50, "cluster"),                      # camera, custom_local
    (100, 100, "cluster"),                    # kitti_sem
    (250, 250, "cluster"),                    # fine_grid
    (1, affine.HIST_CLUSTER_MAX_CELLS, "cluster"),
    (2, affine.HIST_CLUSTER_MAX_CELLS // 2 + 1, "global"),
    (1000, 1000, "global")])
def test_histogram_size_rule(ny, nx, route):
    """By ncells alone: one cluster of 16 CTAs up to what their shared
    memory holds, the global route above it."""
    g = affine.histogram_cluster(ny * nx)
    assert g == (16 if route == "cluster" else 0)
    assert (ny * nx <= g * affine.HIST_CTA_CELLS) == (route == "cluster")


def test_histogram_size_rule_rejects_empty_grid():
    with pytest.raises(ValueError):
        affine.histogram_cluster(0)
