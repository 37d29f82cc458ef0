"""The block chunk kernel's cluster plan (``fused_block.cluster_plan``): how
many blocks of one thread-block cluster hold a problem's ``Minv`` beside
the banded weights, and the shapes no cluster takes.  Pure Python: runs
without a card and decides nothing about one."""

import pytest

from trajopt_tpu_torch import kernels
from trajopt_tpu_torch.models.benchmarks import (arm_table_problem,
                                                 pr2ish_table_problem)
from trajopt_tpu_torch.qp import block_banded as bb
from trajopt_tpu_torch.qp import fused_block as fb
from trajopt_tpu_torch.sqp import nlp as nlp_mod


def _plan_shape(prob):
    """(T, D, K, R) of the block QP that ``make_solve(structured=True)``
    builds for ``prob``."""
    nlp = prob.build()
    plan = bb.make_plan(*nlp_mod.structured_band(nlp), *nlp.block)
    return plan.T, plan.D, plan.K, plan.R


def test_flagship_takes_a_cluster_of_two():
    """n = 240: Minv (230,400 B) and the weights (81,600 B) do not fit one
    block; half of Minv does."""
    prob, _ = pr2ish_table_problem(n_steps=30, lvs_substeps=2, device="cpu")
    shape = _plan_shape(prob)
    assert shape == (30, 8, 2, 40)
    cs, smem = fb.cluster_plan(*shape)
    assert cs == 2
    assert smem <= kernels.SMEM_LIMIT
    # two mbarriers, 120 rows of Minv, the weights at stride 17, w, two
    # rhs halves, two xt buffers, the maxima of 16 warps and 8 ranks
    assert smem == 4 * (4 + 120 * 240 + 1200 * 17 + 1200 + 4 * 240
                        + 80 + 40)


@pytest.mark.parametrize("shape", [(10, 8, 2, 40), (6, 3, 2, 5)])
def test_small_shapes_take_one_block(shape):
    """The 10-step pr2ish QP and the card tests' small shape."""
    cs, smem = fb.cluster_plan(*shape)
    assert cs == 1 and smem <= kernels.SMEM_LIMIT


def test_ten_step_pr2ish_plan_shape():
    prob, _ = pr2ish_table_problem(n_steps=10, lvs_substeps=2, device="cpu")
    assert _plan_shape(prob) == (10, 8, 2, 40)


def test_arm7_block_path_takes_one_block():
    """arm7 on the block path: T 30, D 7, K 1, R 15 (n = 210, m = 450);
    Minv (176,400 B) fits whole beside its 12,600 B of weights."""
    prob, _ = arm_table_problem(n_steps=30, device="cpu")
    shape = _plan_shape(prob)
    assert shape == (30, 7, 1, 15)
    cs, smem = fb.cluster_plan(*shape)
    assert cs == 1
    # each region rounded up to 16 bytes: 450 * 7 = 3,150 -> 3,152 floats
    assert smem == 4 * (4 + 210 * 210 + 3152 + 452 + 2 * 420 + 80 + 40)


def test_cluster_size_grows_with_minv():
    """D 16, K 1, R 10: at n = 384 Minv is 589,824 B, half of it overflows
    a block and a quarter fits; at n = 480 it is 921,600 B, a quarter
    (230,400 B) overflows beside the weights and an eighth fits."""
    assert fb.cluster_plan(24, 16, 1, 10)[0] == 4
    assert fb.cluster_plan(30, 16, 1, 10)[0] == 8


@pytest.mark.parametrize("shape, match", [
    ((30, 17, 2, 68), "no cluster"),        # weights alone 285,600 B
    ((30, 18, 2, 40), "ownership"),         # n = 540 > 512
    ((30, 8, 2, 70), "ownership"),          # m = 2100 > 2048
])
def test_shapes_no_cluster_takes_raise(shape, match):
    with pytest.raises(ValueError, match=match):
        fb.cluster_plan(*shape)
