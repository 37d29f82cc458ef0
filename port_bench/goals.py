"""The goal generator and the straight-line inits every cell's traffic
draws from.

A frozen copy of ``pr2ish_goals``, ``arm7_goals`` and ``_table_batch`` of
``trajopt_tpu_torch/models/benchmarks.py`` at commit f253e5b, made general:
the constants (home, goal, per-joint noise, the borderline goals of the hard
mix, their noise and the clip inset) are the configuration's ``goals``
entry, and the traffic mix gives the batch, the share of hard lanes and a
factor on the noise.  With ``entropy=(seed,)`` and the factor 1 it gives
the port's ``pr2ish_table_batch(seed, ...)`` and ``arm_table_batch(seed,
...)`` goals bit for bit.  A run draws every batch afresh, batch ``k``
of its window from ``entropy=(seed, 0, k)`` (``run.py``).
"""

from __future__ import annotations

import math

import numpy as np


def goals(spec: dict, lower: np.ndarray, upper: np.ndarray, entropy,
          batch: int, hard_frac: float = 0.0, noise: float = 1.0
          ) -> np.ndarray:
    """[batch, n_dof] float64 goals: ``spec["goal"]`` plus seeded normal
    noise, the first ``ceil(hard_frac * batch)`` lanes on the borderline
    goals (cycled) plus their own noise from a second generator, all
    clipped ``clip_inset`` inside the joint limits.  ``entropy`` is a
    tuple of non-negative integers (numpy's ``SeedSequence`` entropy)."""
    entropy = tuple(int(e) for e in entropy)
    n_dof = len(spec["goal"])
    scale = np.asarray(spec["goal_scale"], np.float64)
    if noise != 1.0:
        scale = scale * noise
    out = np.asarray(spec["goal"], np.float64)[None, :] + scale * \
        np.random.default_rng(entropy).standard_normal((batch, n_dof))
    if hard_frac > 0.0:
        border = np.asarray(spec["borderline"], np.float64)
        if not len(border):
            raise ValueError("hard_frac > 0 needs borderline goals")
        n_hard = int(math.ceil(hard_frac * batch))
        hscale = np.asarray(spec["hard_scale"], np.float64)
        if noise != 1.0:
            hscale = hscale * noise
        hnoise = hscale * np.random.default_rng(
            entropy + (1,)).standard_normal((n_hard, n_dof))
        out[:n_hard] = border[np.arange(n_hard) % len(border)] + hnoise
    inset = spec["clip_inset"]
    return np.clip(out, lower + inset, upper - inset)


def straight_inits(home, goal: np.ndarray, n_steps: int) -> np.ndarray:
    """[B, n_steps, n_dof] joint-interpolated inits from ``home`` to each
    goal (InitInfo::JOINT_INTERPOLATED), in float64."""
    w = np.linspace(0.0, 1.0, n_steps)[:, None]
    home = np.asarray(home, np.float64)
    return home[None, None, :] * (1.0 - w) + goal[:, None, :] * w
