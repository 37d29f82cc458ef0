"""Port parity: the top-level API.  Every name of the JAX package's
``__all__`` (and ``dump_failed_qps``) resolves in ``trajopt_tpu_torch``,
and the JAX test's minimal flow runs through the port's top level on the
CPU."""

import numpy as np
import torch

import trajopt_tpu as jt
import trajopt_tpu_torch as tt


def test_all_exports_resolve():
    assert set(jt.__all__) | {"dump_failed_qps"} <= set(tt.__all__)
    for name in tt.__all__:
        assert getattr(tt, name) is not None, name


def test_minimal_flow_via_top_level():
    prob = tt.TrajOptProblem(n_steps=3, n_dof=1, joint_lower=[-5],
                             joint_upper=[5], fixed_steps=[0], device="cpu")
    prob.add_term(tt.joint_vel(3, 1, is_cost=True))
    prob.add_term(tt.joint_pos(3, 1, is_cost=False, targets=np.array([2.0]),
                               first_step=2, last_step=2))
    res = prob.make_solve()(tt.stationary_init(torch.zeros(1, 1), 3))
    assert int(res.status[0]) == tt.SQPStatus.CONVERGED
    np.testing.assert_allclose(res.x[0, -1].item(), 2.0, atol=1e-4)
