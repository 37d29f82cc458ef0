"""The benchmark of the PyTorch/CUDA port ``trajopt_tpu_torch``: verified
solves per second and the batch latency tail of closed-loop batches of
trajectory problems, with per-layer readings from the profiler and a float64
reference that judges the solved trajectories.  See ``run.py``."""
