"""Port parity: the collision options of the JSON front end against the
JAX package, float64 on the CPU.

* the ``lvs_discrete`` evaluator on arm7 (constraint and cost, top-k,
  fixed steps, per-step coefficients): row count, band layout and merit
  groups equal (one row per gap, sub-point and pair, shared gap ends
  repeated), rows and the dense and banded Jacobians to 1e-9;
* ``aggregate="weighted_average"`` with ``safety_margin_buffer`` on pr2ish
  (79 link pairs over 91 geometry pairs), under the discrete and LVS
  evaluators (the cast evaluator shares the LVS one's row selection), with
  and without a top-k over link pairs: the same;
* the ``cast`` evaluator's dense Jacobian (the narrowphase's analytic
  one, as the JAX term's), plain and with the link-pair aggregation: the
  same;
* ``given_init``, with and without the 1/dt column.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.models import benchmarks as jbench
from trajopt_tpu.models import robots as jrobots
from trajopt_tpu.problem import trajectory as jtraj
from trajopt_tpu.terms import collision as jcol
from trajopt_tpu_torch.problem import trajectory as ttraj
from trajopt_tpu_torch.models import robots as trobots
from trajopt_tpu_torch.terms import collision as tcol

torch.set_num_threads(2)

TOL = 1e-9
N_STEPS = 5
SCENES = {
    "arm7": (jrobots.arm7_scene, trobots.arm7_scene, jbench.ARM7_HOME,
             jbench.ARM7_GOAL),
    "pr2ish": (jrobots.pr2ish_scene, trobots.pr2ish_scene,
               jbench.PR2ISH_HOME, jbench.PR2ISH_GOAL),
}
CASES = {
    "lvs_constraint": ("arm7", dict(evaluator="lvs_discrete", is_cost=False,
                                    lvs_substeps=3, fixed_steps=[0])),
    "lvs_cost_topk": ("arm7", dict(
        evaluator="lvs_discrete", is_cost=True, lvs_substeps=2,
        max_num_cnt=3, coeff=[10.0, 20.0, 20.0, 30.0, 20.0],
        first_step=1)),
    "lvs_pair_margin": ("arm7", dict(
        evaluator="lvs_discrete", is_cost=False, lvs_substeps=4,
        pair_margins={("link_4", "post"): 0.08})),
    "wavg_discrete": ("pr2ish", dict(
        evaluator="discrete", is_cost=False, aggregate="weighted_average",
        safety_margin_buffer=0.05, fixed_steps=[0])),
    "wavg_discrete_topk_cost": ("pr2ish", dict(
        evaluator="discrete", is_cost=True, aggregate="weighted_average",
        safety_margin_buffer=0.1, max_num_cnt=6)),
    "wavg_lvs": ("pr2ish", dict(
        evaluator="lvs_discrete", is_cost=False, lvs_substeps=2,
        aggregate="weighted_average", safety_margin_buffer=0.05,
        max_num_cnt=8)),
    "cast_constraint": ("arm7", dict(evaluator="cast", is_cost=False,
                                     lvs_substeps=2, fixed_steps=[0])),
    "wavg_cast_topk_cost": ("pr2ish", dict(
        evaluator="cast", is_cost=True, lvs_substeps=2,
        aggregate="weighted_average", safety_margin_buffer=0.05,
        max_num_cnt=8)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_collision_option_matches_jax(case):
    robot, kw = CASES[case]
    jmake, tmake, home, goal = SCENES[robot]
    jscene, tscene = jmake(), tmake()
    kw = dict(dict(margin=0.05, coeff=20.0), **kw)
    jt = jcol.collision_term(jscene, N_STEPS, **kw)
    tt = tcol.collision_term(tscene, N_STEPS, **kw)
    assert (tt.kind.value, tt.n_rows, tt.band_width, tt.n_groups) == \
        (jt.kind.value, jt.n_rows, jt.band_width, jt.n_groups)
    np.testing.assert_array_equal(tt.band_starts, jt.band_starts)
    if jt.groups is not None:
        np.testing.assert_array_equal(tt.groups, jt.groups)
    rng = np.random.default_rng(7)
    w = np.linspace(0.0, 1.0, N_STEPS)[:, None]
    line = (home * (1 - w) + goal * w).reshape(-1)
    x = line + 0.05 * rng.standard_normal((2, line.size))
    # One JAX Jacobian trace per case, the dense one: its band windows are
    # the banded Jacobian.
    raw_j, (vals_j, J_j) = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda v: (jt.fn(v, {}), jt.val_jac_fn(v, {}))))(jnp.asarray(x)))
    idx = np.asarray(jt.band_starts)[:, None] + np.arange(jt.band_width)
    W_j = np.take_along_axis(J_j, np.broadcast_to(
        np.minimum(idx, J_j.shape[-1] - 1), J_j.shape[:1] + idx.shape),
        -1) * (idx < J_j.shape[-1])
    assert raw_j.max() > 0                      # some rows violated
    np.testing.assert_allclose(vals_j, raw_j, rtol=0, atol=TOL)
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(tt.fn(xt, {}).numpy(), raw_j, rtol=0,
                               atol=TOL)
    for vals, J, ref in (tt.val_banded_jac(xt, {}) + (W_j,),
                         tt.val_jac_fn(xt, {}) + (J_j,)):
        np.testing.assert_allclose(vals.numpy(), raw_j, rtol=0, atol=TOL)
        np.testing.assert_allclose(J.numpy(), ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(tt.banded_jac(xt, {}).numpy(), W_j, rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(tt.jac_fn(xt, {}).numpy(), J_j, rtol=0,
                               atol=TOL)


def test_lvs_rows_repeat_shared_gap_ends():
    """Adjacent gaps' shared configuration gives the same rows twice."""
    scene = trobots.arm7_scene()
    t = tcol.collision_term(scene, 4, margin=0.05, evaluator="lvs_discrete",
                            lvs_substeps=2, is_cost=False)
    assert t.n_rows == 3 * 3 * scene.n_pairs
    w = torch.linspace(0, 1, 4, dtype=torch.float64)[:, None]
    x = (torch.as_tensor(jbench.ARM7_HOME) * (1 - w)
         + torch.as_tensor(jbench.ARM7_GOAL) * w).reshape(1, -1)
    rows = t.fn(x, {}).reshape(3, 3, -1)
    torch.testing.assert_close(rows[0, -1], rows[1, 0], rtol=0, atol=1e-12)


def test_unknown_options_raise():
    scene = trobots.arm7_scene()
    with pytest.raises(ValueError, match="evaluator"):
        tcol.collision_term(scene, 4, margin=0.05, evaluator="continuous")
    with pytest.raises(ValueError, match="aggregate"):
        tcol.collision_term(scene, 4, margin=0.05, aggregate="mean")


@pytest.mark.parametrize("dt", [None, 0.5])
def test_given_init_matches_jax(dt):
    data = np.random.default_rng(8).standard_normal((6, 7))
    ref = np.asarray(jtraj.given_init(jnp.asarray(data), dt))
    got = ttraj.given_init(torch.as_tensor(data), dt)
    np.testing.assert_array_equal(got.numpy(), ref)
    batch = ttraj.given_init(torch.as_tensor(np.stack([data, data])), dt)
    np.testing.assert_array_equal(batch[1].numpy(), ref)
