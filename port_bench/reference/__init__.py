"""The benchmark's plain reference: float64 numpy that recomputes what the
solver's returned trajectories claim (cost, goal residual, joint limits,
clearance) from the benchmark's own URDF copies and configuration files.

It imports neither ``jax`` nor the JAX package nor the PyTorch port, and
takes nothing the program made: only the trajectories it returned, which it
reads to judge them.  Every product goes through a rounding function
``rnd`` (identity for float64; :func:`arith.tf32` for the control, which
rounds each product's operands to TF32 as a TF32 tensor-core product does).
"""
