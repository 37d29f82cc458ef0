"""Joint-name set mapping utilities.

Counterpart of ``trajopt_tpu/utils/joints.py``: the reference's
superset/subset joint-value mapping (``trajopt/include/trajopt/utils.hpp:
14-69``: ``getSubset`` / ``updateFromSubset``, used by the
AvoidSingularitySubset calculators and by planners gluing
differently-ordered joint groups together), on tensors with any leading
axes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def subset_indices(superset_names: Sequence[str],
                   subset_names: Sequence[str]) -> np.ndarray:
    """Index of each subset joint within the superset (static)."""
    lookup = {n: i for i, n in enumerate(superset_names)}
    missing = [n for n in subset_names if n not in lookup]
    if missing:
        raise KeyError(f"joints {missing} not in superset")
    return np.array([lookup[n] for n in subset_names])


def get_subset(superset_names, values, subset_names) -> torch.Tensor:
    """Extract subset joint values from superset values (getSubset)."""
    idx = subset_indices(superset_names, subset_names)
    values = torch.as_tensor(values)
    return values[..., torch.as_tensor(idx, device=values.device)]


def update_from_subset(superset_names, superset_values, subset_names,
                       subset_values) -> torch.Tensor:
    """Write subset values into a copy of the superset values
    (updateFromSubset)."""
    idx = subset_indices(superset_names, subset_names)
    out = torch.as_tensor(superset_values).clone()
    out[..., torch.as_tensor(idx, device=out.device)] = torch.as_tensor(
        subset_values, dtype=out.dtype, device=out.device)
    return out


def expand_jacobian_rows(superset_names, subset_names,
                         J_subset) -> torch.Tensor:
    """Scatter a [rows, len(subset)] Jacobian into [rows, len(superset)]
    (zero elsewhere) -- the AvoidSingularitySubsetJacCalculator pattern."""
    idx = subset_indices(superset_names, subset_names)
    J_subset = torch.as_tensor(J_subset)
    out = J_subset.new_zeros(*J_subset.shape[:-1], len(superset_names))
    out[..., torch.as_tensor(idx, device=out.device)] = J_subset
    return out
