"""Offline training-log analytics: parse a training.log and plot its loss
curves.

Counterpart of `scripts/plot_losses.py` (reference scripts/log_parser.py:
14-87), on the log `python -m gndnet_tpu_torch.scripts.train` writes.

Example:
  python -m gndnet_tpu_torch.scripts.plot_losses runs/kitti/training.log \\
      --out losses.png
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("log_file")
    p.add_argument("--out", default="losses.png")
    args = p.parse_args(argv)

    from gndnet_tpu_torch.utils.logging import (parse_log_file,
                                                plot_epoch_losses)

    parsed = parse_log_file(args.log_file)
    print(f"epochs: {len(parsed['epochs'])}")
    for e, t in zip(parsed["epochs"], parsed["train_loss"]):
        print(f"  epoch {e}: train {t:.6f}")
    plot_epoch_losses(parsed, args.out)
    print(f"wrote {args.out}")
    return parsed


if __name__ == "__main__":
    main()
