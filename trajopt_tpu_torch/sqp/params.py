"""SQP parameters and status codes.

Counterpart of ``trajopt_tpu/sqp/params.py``: field names, defaults and
semantics mirror ``sco::BasicTrustRegionSQPParameters`` so that a JAX
``SQPParams`` converts field for field (``interop.sqp_params_from_dict``).
"""

from __future__ import annotations

import dataclasses

from trajopt_tpu_torch.qp.admm import ADMMConfig


class SQPStatus:
    """Integer status codes, matching sco::OptStatus."""

    RUNNING = 0
    CONVERGED = 1
    SCO_ITERATION_LIMIT = 2
    PENALTY_ITERATION_LIMIT = 3
    FAILED = 4
    STOPPED_BY_CALLBACK = 5
    TIME_LIMIT = 6

    NAMES = {
        0: "RUNNING",
        1: "CONVERGED",
        2: "SCO_ITERATION_LIMIT",
        3: "PENALTY_ITERATION_LIMIT",
        4: "FAILED",
        5: "STOPPED_BY_CALLBACK",
        6: "TIME_LIMIT",
    }


@dataclasses.dataclass(frozen=True)
class SQPParams:
    """Trust-region SQP settings (see the JAX counterpart for the reasoning
    behind each extension field).  ``qp_algorithm`` is ``"admm"`` or
    ``"ipm"`` (the dense path only); ``max_time`` is accepted for
    field-for-field conversion, and the solver, like the JAX one, has no
    wall-clock limit."""

    improve_ratio_threshold: float = 0.25
    min_trust_box_size: float = 1e-4
    min_approx_improve: float = 1e-4
    min_approx_improve_frac: float = -float("inf")
    max_iter: int = 50
    trust_shrink_ratio: float = 0.1
    trust_expand_ratio: float = 1.5
    cnt_tolerance: float = 1e-4
    max_merit_coeff_increases: int = 5
    max_qp_solver_failures: int = 3
    merit_coeff_increase_ratio: float = 10.0
    initial_merit_error_coeff: float = 10.0
    inflate_constraints_individually: bool = True
    initial_trust_box_size: float = 1e-1
    # Max trust-region iterations (QP solves) per convexification.
    max_trust_iter: int = 12
    # On penalty escalation, reset the box to initial_trust_box_size
    # instead of the reference's fmax(box, min/shrink*1.5).
    box_reset_to_initial: bool = False
    # Second-chance restarts of the penalty schedule from the current
    # iterate when merit increases run out with violated constraints.
    max_restarts: int = 0
    restart_merit_coeff: float = 100.0
    # Rescale the carried duals of saturated penalty rows when the merit
    # coefficients change.
    rescale_duals_on_escalation: bool = False
    max_time: float = float("inf")
    qp: ADMMConfig = ADMMConfig(eps_abs=1e-8, eps_rel=1e-8, max_iter=1500)
    qp_algorithm: str = "admm"
