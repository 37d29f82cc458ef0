"""The frozen copies in port_bench/ equal the port's originals at today's
shapes: the goal generators bit for bit, the chunk kernels' operation and
byte counts, the published peaks."""

import numpy as np
import pytest
import torch

import chip_smoke
from port_bench import goals, roofline, spec
from port_bench.reference.robot import Robot
from trajopt_tpu_torch.models import benchmarks as mb
from trajopt_tpu_torch.qp import fused_block, fused_dense


def _robot(name):
    return Robot(str(spec.ROOT / spec.config(name)["urdf"]))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
@pytest.mark.parametrize("hard_frac", [0.0, 0.25])
def test_pr2ish_goals_bit_for_bit(seed, hard_frac):
    cfg = spec.config("pr2ish_cast")
    r = _robot("pr2ish_cast")
    got = goals.goals(cfg["goals"], r.lower, r.upper, (seed,), 64, hard_frac)
    inits, want = mb.pr2ish_table_batch(seed, 64, 30, dtype=torch.float64,
                                        device="cpu", hard_frac=hard_frac)
    assert np.array_equal(got, want.numpy())
    assert np.allclose(goals.straight_inits(cfg["goals"]["home"], got, 30),
                       inits.numpy(), rtol=0, atol=1e-15)


@pytest.mark.parametrize("seed", [0, 3, 2**33 + 5])
def test_arm7_goals_bit_for_bit(seed):
    cfg = spec.config("arm7_dense")
    r = _robot("arm7_dense")
    got = goals.goals(cfg["goals"], r.lower, r.upper, (seed,), 32)
    inits, want = mb.arm_table_batch(seed, 32, 30, dtype=torch.float64,
                                     device="cpu")
    assert np.array_equal(got, want.numpy())
    assert np.allclose(goals.straight_inits(cfg["goals"]["home"], got, 30),
                       inits.numpy(), rtol=0, atol=1e-15)


def test_constants_are_the_ports():
    pr2, arm = spec.config("pr2ish_cast")["goals"], \
        spec.config("arm7_dense")["goals"]
    assert np.array_equal(pr2["home"], mb.PR2ISH_HOME)
    assert np.array_equal(pr2["goal"], mb.PR2ISH_GOAL)
    assert np.array_equal(pr2["goal_scale"], mb.PR2ISH_GOAL_SCALE)
    assert np.array_equal(pr2["borderline"], mb.PR2ISH_GOALS_BORDERLINE)
    assert np.array_equal(pr2["hard_scale"], mb.PR2ISH_HARD_SCALE)
    assert np.array_equal(arm["home"], mb.ARM7_HOME)
    assert np.array_equal(arm["goal"], mb.ARM7_GOAL)
    assert np.array_equal(arm["goal_scale"], mb.ARM7_GOAL_SCALE)


def test_peaks_are_the_ports():
    assert roofline.PEAK_FP32_FLOPS == chip_smoke.PEAK_FP32_FLOPS
    assert roofline.PEAK_HBM_BYTES == chip_smoke.PEAK_HBM_BYTES


@pytest.mark.parametrize("B, T, D, K, R, n_iters",
                         [(512, 30, 8, 2, 40, 150), (37, 30, 7, 2, 16, 20)])
def test_block_counts_equal_the_ports(B, T, D, K, R, n_iters):
    g = torch.Generator().manual_seed(B)
    Wb = torch.rand(B, T, R, K * D, generator=g)
    Wb[:, :, R // 2:] = 0.0                     # padded rows
    Wb[: B // 3, :, : R // 4] = 0.0
    rows = int((Wb != 0).any(-1).sum())
    assert roofline.block_flops(B, rows, T, D, K * D, n_iters) == \
        fused_block.chunk_flops(Wb, D, n_iters)
    n, m = T * D, T * R
    shapes = {"Minv": (n, n), "Wb": (T, R, K * D), "P": (n, n), "cobj": ()}
    args_per_lane = sum(int(np.prod(shapes.get(k, (n,))))
                        for k in ("Minv", "Wb", "P", "q", "lb", "ub", "bd",
                                  "Eb", "Dd", "x", "zb", "yb", "cobj")) \
        + 7 * m
    outs_per_lane = 3 * n + 2 * m + 5
    assert roofline.block_bytes(B, T, R, D, K * D) == \
        4 * B * (args_per_lane + outs_per_lane)


@pytest.mark.parametrize("B, m, n, n_iters",
                         [(256, 449, 210, 20), (128, 888, 210, 25)])
def test_dense_counts_equal_the_ports(B, m, n, n_iters):
    A = torch.zeros(B, m, n)
    assert roofline.dense_flops(B, m, n, n_iters) == \
        fused_dense.chunk_flops(A, n_iters)
    assert roofline.dense_bytes(B, m, n) == fused_dense.chunk_bytes(A)


def test_batches_are_fresh_and_warm_up_is_disjoint():
    """Batch k of a window draws from (seed, MEASURED, k), the warm-up's
    from (seed, WARM, k): the same seed gives the same batch, and no goal
    of the window is one the warm-up solved."""
    from port_bench import run
    cfg = spec.config("pr2ish_cast")
    r = _robot("pr2ish_cast")

    def batch(seed, stream, k):
        return goals.goals(cfg["goals"], r.lower, r.upper, (seed, stream, k),
                           16, 0.25)

    for seed in (1, 2**40 + 3):
        window = np.concatenate([batch(seed, run.MEASURED, k)
                                 for k in range(6)])
        warm = np.concatenate([batch(seed, run.WARM, k) for k in range(6)])
        assert np.array_equal(batch(seed, run.MEASURED, 4), window[64:80])
        assert len(np.unique(window, axis=0)) == len(window)
        assert not (window[:, None, :] == warm[None, :, :]).all(-1).any()
    assert not np.array_equal(batch(1, run.MEASURED, 0),
                              batch(2, run.MEASURED, 0))
