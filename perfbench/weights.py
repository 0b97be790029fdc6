"""The benchmark's weights: GndNet's parameters and batch-norm statistics,
drawn from the run's seed on the device in one call, under the state-dict
names of the original model (`voxel_feature_extractor.pfn_layers.0.*`,
`encoder_decoder.<stage>.<conv>.cbr_unit.{0,1}.*`, `...regressor.*`).

Convolution and linear weights and biases are uniform in +-1/sqrt(fan in)
(PyTorch's default initialisation); batch norm's scale is uniform in
[0.8, 1.2], its shift and running mean in [-0.1, 0.1], its running
variance in [0.5, 1.5], so that serving in eval mode is no identity.
"""

from __future__ import annotations

import math

import torch

SEGNET_WIDTHS = (("down1", ((None, 128), (128, 128))),
                 ("down2", ((128, 256), (256, 256))),
                 ("up2", ((256, 256), (256, 128))),
                 ("up1", ((128, 128), (128, 64))))


def layout(cfg) -> list:
    """[(name, shape, low, high)] of every floating leaf, in draw order."""
    width = cfg.vfe_filters[-1]
    d = cfg.input_features + 5
    bound = 1.0 / math.sqrt(d)
    pfn = "voxel_feature_extractor.pfn_layers.0.linear"
    leaves = [(pfn + ".weight", (width, d), -bound, bound),
              (pfn + ".bias", (width,), -bound, bound)]
    for stage, convs in SEGNET_WIDTHS:
        for conv, (cin, cout) in zip(("conv1", "conv2"), convs):
            cin = width if cin is None else cin
            name = f"encoder_decoder.{stage}.{conv}.cbr_unit"
            bound = 1.0 / math.sqrt(9 * cin)
            leaves += [(name + ".0.weight", (cout, cin, 3, 3), -bound, bound),
                       (name + ".0.bias", (cout,), -bound, bound),
                       (name + ".1.weight", (cout,), 0.8, 1.2),
                       (name + ".1.bias", (cout,), -0.1, 0.1),
                       (name + ".1.running_mean", (cout,), -0.1, 0.1),
                       (name + ".1.running_var", (cout,), 0.5, 1.5)]
    bound = 1.0 / math.sqrt(9 * 64)
    leaves += [("encoder_decoder.regressor.weight", (1, 64, 3, 3), -bound,
                bound),
               ("encoder_decoder.regressor.bias", (1,), -bound, bound)]
    return leaves


def make(cfg, seed: int, device) -> dict:
    """{name: tensor} on `device`: every leaf of `layout` from one uniform
    draw of a generator seeded with `seed` on that device, plus batch
    norm's `num_batches_tracked` counters (0)."""
    leaves = layout(cfg)
    sizes = [math.prod(shape) for _, shape, _, _ in leaves]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    draw = torch.rand(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape, lo, hi), part in zip(leaves, draw.split(sizes)):
        out[name] = (lo + (hi - lo) * part).reshape(shape)
        if name.endswith(".1.running_var"):
            out[name[:-len("running_var")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.long, device=device)
    return out
