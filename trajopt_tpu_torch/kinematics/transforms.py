"""SO(3)/SE(3) helpers as (R, p) pairs on batched tensors.

Counterpart of ``trajopt_tpu/kinematics/transforms.py``.  Every function
broadcasts over leading axes: rotations are ``[..., 3, 3]``, points
``[..., 3]``.  Rotation error follows tesseract's ``calcTransformError``:
relative pose ``inv(T1) * T2`` with the rotational part as an angle-axis
vector.
"""

from __future__ import annotations

import math

import torch

from trajopt_tpu_torch.utils import device_const


def rpy_matrix(rpy: torch.Tensor) -> torch.Tensor:
    """URDF fixed-axis RPY: R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    rows = [
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ]
    return torch.stack([torch.stack(row, -1) for row in rows], -2)


def axis_angle_matrix(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation about a (unit) axis [..., 3] by angle [...]."""
    c = torch.cos(angle)
    s = torch.sin(angle)
    C = 1.0 - c
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    rows = [
        [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
    ]
    return torch.stack([torch.stack(row, -1) for row in rows], -2)


def matvec(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R @ v for R [..., 3, 3], v [..., 3]."""
    return (R * v[..., None, :]).sum(-1)


def rmatvec(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R.T @ v for R [..., 3, 3], v [..., 3]."""
    return (R * v[..., :, None]).sum(-2)


def compose(Ra, pa, Rb, pb):
    """(Ra, pa) o (Rb, pb)."""
    return Ra @ Rb, matvec(Ra, pb) + pa


def invert(R, p):
    Rt = R.transpose(-1, -2)
    return Rt, -matvec(Rt, p)


def rotvec_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Angle-axis (rotation vector) log of SO(3), safe near 0 and pi.

    Matches tesseract's calcRotationalError convention (angle in (-pi, pi]).
    """
    def const(v):
        return device_const(v, R.device, R.dtype)

    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    trace = torch.minimum(torch.maximum(trace, const(-1.0)), const(3.0))
    cos_t = (trace - 1.0) * 0.5
    cos_t = torch.minimum(torch.maximum(cos_t, const(-1.0)), const(1.0))
    # Skew part: (R - R^T)/2 = sin(theta) * [axis]_x
    w = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                           R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    # arctan2 keeps gradients finite at theta = 0 (arccos'(1) is inf).
    sin_t = torch.sqrt((w * w).sum(-1) + 1e-30)
    theta = torch.atan2(sin_t, cos_t)

    small = theta < 1e-5
    scale_small = 1.0 + theta * theta / 6.0
    scale_gen = theta / torch.where(small, torch.ones_like(sin_t), sin_t)
    rot_general = w * torch.where(small, scale_small, scale_gen)[..., None]

    # Near pi: R + I ~ 2 a a^T reveals the axis; align its sign with w.
    near_pi = theta > math.pi - 1e-4
    B = R + torch.eye(3, dtype=R.dtype, device=R.device)
    col_norms = (B * B).sum(-2)
    i_max = torch.argmax(col_norms, -1)
    col = torch.gather(B, -1, i_max[..., None, None].expand(
        *B.shape[:-1], 1))[..., 0]
    nrm = torch.linalg.vector_norm(col, dim=-1)
    axis = col / torch.maximum(nrm, const(1e-12))[..., None]
    flip = torch.where((axis * w).sum(-1) < 0.0, -1.0, 1.0).to(R.dtype)
    rot_pi = axis * (flip * theta)[..., None]
    return torch.where(near_pi[..., None], rot_pi, rot_general)


def transform_error(R_target, p_target, R_source, p_source) -> torch.Tensor:
    """6-vector [translation; angle-axis] of inv(T_target) * T_source."""
    Rt, pt = invert(R_target, p_target)
    R_rel, p_rel = compose(Rt, pt, R_source, p_source)
    return torch.cat([p_rel, rotvec_from_matrix(R_rel)], -1)


def apply_tolerances(err, lower, upper) -> torch.Tensor:
    """Shift error into the dead-band [lower, upper] (tesseract
    applyTolerances): above upper -> err-upper, below lower -> err-lower,
    inside -> 0."""
    return torch.where(err > upper, err - upper,
                       torch.where(err < lower, err - lower,
                                   torch.zeros_like(err)))
