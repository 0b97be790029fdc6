"""The benchmark of gndnet_tpu_torch: `python3 -m perfbench.run` (see
run.py).  It imports the program it measures only inside a run, and never
JAX or the JAX package."""
