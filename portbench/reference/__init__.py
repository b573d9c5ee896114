"""Plain PyTorch reference of the benchmarked configurations: the CMCD core
(cmcd.py), the Philox draws the program's kernels make (philox.py) and one
module per configuration that builds its target from the benchmark's own
data. Nothing here imports the program or JAX."""
