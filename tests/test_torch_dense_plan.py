"""The dense chunk kernel's cluster plan (``fused_dense.cluster_plan``): how
many blocks of one thread-block cluster hold a problem's ``A`` and
``Minv`` by rows, which shapes take the streaming kernel (cs = 0), and the
shapes the kernel does not take.  Pure Python: runs without a card and
decides nothing about one."""

import pytest

from trajopt_tpu_torch import kernels
from trajopt_tpu_torch.models.benchmarks import (arm_table_batch,
                                                 arm_table_problem)
from trajopt_tpu_torch.qp import fused_dense as fd
from trajopt_tpu_torch.sqp import nlp as nlp_mod
from trajopt_tpu_torch.sqp.solver import build_qp


def test_arm7_dense_qp_takes_a_cluster_of_three():
    """arm7's dense QP (n = 210, m = 449): A (377,160 B) and Minv
    (176,400 B) fit in no fewer than three blocks."""
    prob, _ = arm_table_problem(n_steps=30, device="cpu")
    nlp = prob.build()
    inits, goals = arm_table_batch(0, 1, 30, device="cpu")
    x = inits.reshape(1, -1)
    params = {"goal": goals}
    lb, ub = prob.bounds(x)
    model = nlp_mod.convexify(nlp, x, params,
                              nlp_mod.linear_jacobians(nlp, x, params))
    coeffs = x.new_full((1, nlp_mod.num_cnt_groups(nlp)), 10.0)
    qp = build_qp(nlp, model, coeffs, lb, ub)
    _, m, n = qp.A.shape
    assert (n, m) == (210, 449)
    cs, smem = fd.cluster_plan(n, m)
    assert cs == 3
    assert smem <= kernels.SMEM_LIMIT
    # four mbarriers; at a row stride of 212 floats (n rounded up to a
    # multiple of 4) 150 rows of A, 70 of Minv, the column sums of 16
    # warps, xt [2, 212] and rhs [212]; the state of 150 rows (8 vectors
    # of 152 floats) and the partials [2, 3, n]
    assert smem == 4 * (8 + (150 + 70 + 16 + 3) * 212 + 8 * 152
                        + 2 * 3 * 210)


def test_json_arm7_document_takes_a_cluster_of_five():
    """The JSON front end's arm7 Cartesian-reach document (30 steps,
    lvs_discrete with 3 sub-points, 8 pairs): n = 210, m = 672 collision +
    6 pose + 210 box = 888 rows.  A (745,920 B) and Minv (176,400 B) fit in
    no fewer than five blocks: 178 rows of A and 42 of Minv a rank."""
    assert fd.cluster_plan(210, 888) == (5, 216_864)
    assert 216_864 == 4 * (8 + (178 + 42 + 16 + 3) * 212 + 8 * 180
                           + 2 * 5 * 210)
    assert fd.cluster_plan(210, 888)[1] <= kernels.SMEM_LIMIT


def test_card_tests_ragged_shape_takes_one_block():
    """n = 37, m = 61 (tests/test_torch_cuda.py): everything fits one
    block."""
    assert fd.cluster_plan(37, 61) == (1, 4 * (8 + (61 + 37 + 19) * 40
                                               + 8 * 64 + 76))


def test_cluster_size_grows_with_the_matrices():
    """n = 300, m = 700: A and Minv are 1,200,000 B together; six blocks
    of 241,472 B overflow, seven of 214,432 B fit."""
    assert fd.cluster_plan(300, 700) == (7, 214_432)
    assert 4 * (8 + (117 + 50 + 19) * 300 + 8 * 120 + 2 * 6 * 300) \
        == 241_472 > kernels.SMEM_LIMIT


def test_shape_no_cluster_holds_takes_the_streaming_kernel():
    """n = 400, m = 1200: A and Minv are 2,560,000 B, past eight blocks'
    shared memory; the streaming block holds the row state, rhs, xt and
    the warps' column sums."""
    assert fd.cluster_plan(400, 1200) == (0, 4 * (7 * 1200 + 2 * 400
                                                  + 16 * 400))


@pytest.mark.parametrize("n, m, match", [
    (0, 10, "column range"),
    (513, 100, "column range"),
    (600, 3, "column range"),
    (512, 30_000, "shared memory"),   # not even the streaming row state
])
def test_shapes_the_kernel_does_not_take_raise(n, m, match):
    with pytest.raises(ValueError, match=match):
        fd.cluster_plan(n, m)
