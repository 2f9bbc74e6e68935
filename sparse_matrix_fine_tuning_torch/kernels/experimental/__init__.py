"""Bench-only kernels of the port: the fused dense + Monarch linear
(``more_linear``), which only ``scripts/bench_more_linear.py`` drives, as in
the JAX package's ``kernels/experimental/``."""
