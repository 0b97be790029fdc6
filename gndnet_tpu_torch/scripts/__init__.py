"""Command-line entry points of the port: `python -m
gndnet_tpu_torch.scripts.<name>`."""
