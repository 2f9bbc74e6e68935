"""Bench-only kernels of the port, as in the JAX package's ``kernels/experimental/``:
the fused dense + Monarch linear (``more_linear``), which only
``scripts/bench_more_linear.py`` drives, and the tiled bf16 matmul
(``tiled_matmul``), which only ``scripts/exp_matmul_tiles.py`` drives."""
