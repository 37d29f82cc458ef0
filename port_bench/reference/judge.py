"""What decides ``correct``: the reference's float64 recomputation of what
the solver claims for each sampled lane, and the numbers compared.

For each lane the solver returns a trajectory and claims its joint_vel
cost, its goal residual (the joint_pos group's violation), a status, and
(through its swept check) a clearance.  The reference recomputes from the
trajectory alone, with the benchmark's URDF copy and the configuration:
the cost and the goal residual exactly; the clearance at the configurations
where the swept check's sub-segments begin and end (each gap cut into the
same ``n_sub`` pieces, from the configuration's ``verify.check_len``), a
sub-segment's swept distance being at most that of its ends; and the
configuration's guarantees: the joint limits, the goal rows, and the
collision rows ``coeff * (margin - distance)`` at the configurations the
collision constraint holds (the steps of a discrete constraint, the
sub-segment ends of a cast one).  The numbers, each a maximum over the
sampled lanes:

* ``cost_err``: |claimed cost - cost| / cost;
* ``goal_err``: |claimed goal residual - goal residual|;
* ``clearance_err``: claimed clearance - clearance at the sub-segment
  ends, both under the system's capsule-box definition (the solver's
  clearance states it);
* ``broken``: lanes that break a guarantee (a count, limit 0): a lane
  whose status is converged while its claimed violation, a recomputed goal
  row or collision row, or its excess over a joint limit reaches the
  configuration's ``cnt_tolerance``; a non-finite trajectory; or a lane
  counted verified whose least distance at a sub-segment end is not above
  0.  Collision rows and the least distance use the least capsule-box
  distance (:func:`geometry.segment_box_exact`), not the system's.

The control puts the reference in the solver's place, computed in TF32
(each product's operands rounded to 10 mantissa bits, as a TF32
tensor-core product rounds them): its claims are the same recomputations
in that precision.
"""

from __future__ import annotations

import numpy as np

from port_bench.reference import arith, geometry

NUMBERS = ("cost_err", "goal_err", "clearance_err", "broken")


def _terms(cfg, kind, is_cost):
    return [t for t in cfg["terms"] if t["type"] == kind
            and t["is_cost"] == is_cost]


def cost(cfg, x, rnd=arith.exact) -> np.ndarray:
    """[S] joint_vel cost of trajectories ``x [S, T, D]``: sum over steps
    and joints of coeff * (x[t+1] - x[t])**2."""
    out = np.zeros(x.shape[0])
    for t in _terms(cfg, "joint_vel", True):
        d = np.diff(x, axis=1)
        c = np.asarray(t["coeffs"], np.float64)
        out = out + arith.mul(rnd, arith.mul(rnd, d, d), c).sum((1, 2))
    return out


def goal_residual(cfg, x, goal, rnd=arith.exact) -> np.ndarray:
    """[S] sum over joints of |x[step] - goal| (the joint_pos equality
    constraint's violation at its step), as the product of the row that
    selects the step with ``x``, less the goal."""
    (t,) = _terms(cfg, "joint_pos", False)
    q = x[:, t["first_step"]]
    return np.abs(arith.mul(rnd, q, 1.0) - goal).sum(-1)


def samples(x, n_sub) -> tuple[np.ndarray, np.ndarray]:
    """(q [N, D], lane [N]): the configurations at which each gap of lane
    ``s`` is cut into ``n_sub[s]`` equal pieces in joint space, and the last
    waypoint."""
    S, T, D = x.shape
    qs, lanes = [], []
    for s in range(S):
        fr = np.arange(n_sub[s]) / n_sub[s]
        a, d = x[s, :-1], np.diff(x[s], axis=0)
        qs.append((a[:, None] + fr[None, :, None] * d[:, None]
                   ).reshape(-1, D))
        qs.append(x[s, -1:])
        lanes.append(np.full((T - 1) * n_sub[s] + 1, s))
    return np.concatenate(qs), np.concatenate(lanes)


def _collision_terms(cfg):
    return [t for t in cfg["terms"] if t["type"] == "collision"]


def _least_below(cfg) -> float:
    """Least distances are computed exactly below this: the largest
    collision margin, so that every row and every clearance compared is."""
    return max([0.0] + [float(t["margin"]) for t in _collision_terms(cfg)])


def least_distances(cfg, robot, q, rnd=arith.exact, block: int = 8192):
    """([N] system, [N] least) distance over the scene's pairs at the
    configurations ``q [N, D]``, in blocks of ``block``."""
    sys_out, least_out = [], []
    for lo in range(0, len(q), block):
        sd, ld = geometry.pair_distances(cfg["scene"], robot.fk(
            q[lo:lo + block], rnd), rnd, least_below=_least_below(cfg))
        sys_out.append(sd.min(-1))
        least_out.append(ld.min(-1))
    return np.concatenate(sys_out), np.concatenate(least_out)


def clearance(cfg, robot, x, n_sub, rnd=arith.exact) -> tuple:
    """([S] system, [S] least) signed distance of each lane over the
    scene's pairs at its sampled configurations."""
    q, lane = samples(x, n_sub)
    sd, ld = least_distances(cfg, robot, q, rnd)
    out = []
    for d in (sd, ld):
        low = np.full(x.shape[0], np.inf)
        np.minimum.at(low, lane, d)
        out.append(low)
    return tuple(out)


def constraint_points(term, x) -> tuple[np.ndarray, np.ndarray]:
    """(q [N, D], lane [N]): the configurations at which the collision
    constraint ``term`` holds its rows: the steps that are not fixed
    (``discrete``), or each gap's ``lvs_substeps + 1`` evenly spaced
    configurations, ends included, on the gaps that are not fixed at both
    ends (``cast``, ``lvs_discrete``)."""
    S, T, D = x.shape
    first = term.get("first_step", 0)
    last = term.get("last_step", -1)
    last = T - 1 if last <= -1 else last
    fixed = set(term.get("fixed_steps", ()))
    if term["evaluator"] == "discrete":
        steps = [t for t in range(first, last + 1) if t not in fixed]
        q = x[:, steps]
    else:
        gaps = np.asarray([t for t in range(first, last)
                           if not (t in fixed and t + 1 in fixed)])
        fr = np.linspace(0.0, 1.0, term["lvs_substeps"] + 1)
        a, b = x[:, gaps], x[:, gaps + 1]
        q = a[:, :, None] + fr[None, None, :, None] * (b - a)[:, :, None]
    q = q.reshape(S, -1, D)
    return q.reshape(-1, D), np.repeat(np.arange(S), q.shape[1])


def collision_rows(cfg, robot, x, rnd=arith.exact) -> np.ndarray:
    """[S] largest collision constraint row ``coeff * (margin - least
    distance)`` of each lane (-inf with no collision constraint)."""
    worst = np.full(x.shape[0], -np.inf)
    for t in _collision_terms(cfg):
        if t["is_cost"]:
            continue
        for key in ("pair_coeffs", "pair_margins", "aggregate"):
            if key in t:
                raise ValueError(f"collision term: {key} is not supported")
        q, lane = constraint_points(t, x)
        _, ld = least_distances(cfg, robot, q, rnd)
        rows = float(t["coeff"]) * (float(t["margin"]) - ld)
        np.maximum.at(worst, lane, rows)
    return worst


def goal_rows(cfg, x, goal) -> np.ndarray:
    """[S] largest joint_pos equality row coeff * |x[step] - goal|."""
    (t,) = _terms(cfg, "joint_pos", False)
    c = np.asarray(t.get("coeffs", np.ones(x.shape[-1])), np.float64)
    return (c * np.abs(x[:, t["first_step"]] - goal)).max(-1)


def limit_excess(robot, x) -> np.ndarray:
    """[S] largest distance of a joint value beyond its URDF limit (0
    inside the limits)."""
    return np.maximum(np.maximum(x - robot.upper, robot.lower - x),
                      0.0).max((1, 2))


def recompute(cfg, robot, x, goal, n_sub, rnd=arith.exact) -> dict:
    """The claims' recomputations (cost, goal, clearance), and with the
    exact arithmetic the guarantees (least clearance, goal rows, collision
    rows, joint-limit excess), each [S]."""
    sys_clear, least_clear = clearance(cfg, robot, x, n_sub, rnd)
    out = {"cost": cost(cfg, x, rnd),
           "goal": goal_residual(cfg, x, goal, rnd),
           "clearance": sys_clear}
    if rnd is arith.exact:
        out.update(least_clearance=least_clear,
                   goal_row=goal_rows(cfg, x, goal),
                   collision_row=collision_rows(cfg, robot, x),
                   limit_excess=limit_excess(robot, x))
    return out


def _max(v) -> float:
    """Largest entry, NaN if any is NaN (a NaN fails every limit)."""
    v = np.asarray(v, np.float64)
    return float(np.max(v)) if v.size else 0.0


def numbers(cfg, claims: dict, ref: dict) -> dict:
    """The compared numbers from the solver's ``claims`` (cost, goal,
    clearance [S]; max_viol [S]; converged, verified [S] bool; finite [S]
    bool) and the reference's recomputation ``ref``."""
    tol = float(cfg["sqp"]["cnt_tolerance"])
    unmet = ~(claims["max_viol"] < tol) | ~(ref["goal_row"] < tol) \
        | ~(ref["collision_row"] < tol) | ~(ref["limit_excess"] < tol)
    broken = (claims["converged"] & unmet) | ~claims["finite"] \
        | (claims["verified"] & ~(ref["least_clearance"] > 0.0))
    return {
        "cost_err": _max(np.abs(claims["cost"] - ref["cost"])
                         / ref["cost"]),
        "goal_err": _max(np.abs(claims["goal"] - ref["goal"])),
        "clearance_err": _max(claims["clearance"] - ref["clearance"]),
        "broken": int(broken.sum()),
    }


def control_claims(cfg, robot, x, goal, n_sub, program: dict) -> dict:
    """The control's claims: the reference in TF32, with the solver's
    statuses (the control plans nothing; it states the values)."""
    c = recompute(cfg, robot, x, goal, n_sub, arith.tf32)
    return dict(program, cost=c["cost"], goal=c["goal"],
                clearance=c["clearance"])


def passes(values: dict, limits: dict) -> bool:
    return all(values[k] <= limits[k] for k in NUMBERS)
