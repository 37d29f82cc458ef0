"""Operations and bytes of the two ADMM chunk kernels' launches, and the
published peaks they are held to.

Frozen copies at commit f253e5b of ``fused_block.chunk_flops``, the block
chunk's byte count of ``chip_smoke.phase_kernel_check`` (every input read
once and every output written once), ``fused_dense.chunk_flops`` and
``fused_dense.chunk_bytes``, and ``chip_smoke.PEAK_*``, counted for the
lanes a launch solves (its ``active`` mask): operations and bytes follow
from the QP's shapes and the iterations a launch runs (``check_every``),
whatever implements the kernel.
"""

from __future__ import annotations

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def block_flops(lanes: int, rows: int, T: int, D: int, KD: int,
                n_iters: int) -> int:
    """Per iteration and lane the dense ``Minv`` matvec (2 n^2), the
    banded products ``C x`` and ``C' w`` (2 K*D each per row that holds a
    weight) and the elementwise updates (21 per column, 13 per row); then
    the statistics.  ``rows`` counts the weighted rows of the lanes."""
    n = T * D
    per_iter = lanes * (2 * n * n + 21 * n) + rows * (4 * KD + 13)
    stats = lanes * (2 * n * n + 10 * n) + rows * (4 * KD + 10)
    return n_iters * per_iter + stats


def block_bytes(lanes: int, T: int, R: int, D: int, KD: int) -> int:
    """float32 inputs (Minv, P, the band Wb, 9 vectors of n, 7 of m, the
    objective constant) read once and outputs (3 of n, 2 of m, 5
    statistics) written once."""
    n, m = T * D, T * R
    return 4 * lanes * (2 * n * n + T * R * KD + 9 * n + 7 * m + 1
                        + 3 * n + 2 * m + 5)


def dense_flops(lanes: int, m: int, n: int, n_iters: int) -> int:
    """Per lane and iteration ``A'w``, ``Minv rhs`` and ``A x~`` (2 (2 m n
    + n^2)) and the elementwise updates (6 per column, 16 per row); the
    chunk's first ``A x`` (2 m n)."""
    per_iter = 2 * (2 * m * n + n * n) + 6 * n + 16 * m
    return lanes * (n_iters * per_iter + 2 * m * n)


def dense_bytes(lanes: int, m: int, n: int) -> int:
    """Every float32 input read once and every output written once."""
    return 4 * lanes * (n * n + m * n + 2 * n + 6 * m + n + 3 * m)


def bound_s(flops: int, nbytes: int) -> float:
    """The least time the chip could take: the larger of the operations at
    the float32 peak and the bytes at the HBM peak."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)
