"""Tests of the benchmark harness.  Run from the checkout's root:

    JAX_PLATFORMS=cpu python -m pytest -q port_bench/tests

They run on the CPU; a test that needs the card is marked ``cuda`` and
decides inside the test whether there is one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device")
    import torch
    torch.set_num_threads(2)          # several workers share the cores
