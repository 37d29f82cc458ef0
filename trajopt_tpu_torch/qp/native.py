"""ctypes binding for the native C++ QP backend (``csrc/qp_admm.cpp``).

Counterpart of ``trajopt_tpu/qp/native.py``.  ``csrc/qp_admm.cpp`` is a
byte-identical copy of the JAX package's ``native/qp_admm.cpp``: the same
dense proximal ADMM with Ruiz equilibration in float64 on the host, behind
the same C ABI.  Backend selection mirrors ``sco::ModelType`` +
``createModel`` (``trajopt_sco/src/solver_interface.cpp:255-292``): the
batched device ADMM is the default; this host QP serves the reference
driver (``sqp/reference_solver.py``), validation and low-latency
single-problem solves.  It is not a GPU kernel.

The shared library is built at first use with ``g++ -O3 -shared -fPIC``
into ``trajopt_tpu_torch/_build/``, keyed by a hash of the source and the
flags (``kernels.build_library``), and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np

from trajopt_tpu_torch import kernels

SOURCE = kernels.CSRC / "qp_admm.cpp"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None


class NativeQPResult(NamedTuple):
    x: np.ndarray
    z: np.ndarray
    y: np.ndarray
    iters: int
    pri_res: float
    dua_res: float
    converged: bool


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(kernels.build_library(SOURCE, compiler="g++",
                                                flags=CXX_FLAGS)))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.tpu_trajopt_qp_solve.restype = ctypes.c_int
    lib.tpu_trajopt_qp_solve.argtypes = [
        ctypes.c_int, ctypes.c_int,
        dp, dp, dp, dp, dp, dp,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        dp, dp, dp,
        ctypes.POINTER(ctypes.c_int), dp, dp,
    ]
    _lib = lib
    return lib


def solve_qp_native(P, q, A, l, u, c, x0=None, z0=None, y0=None, *,
                    sigma=1e-6, alpha=1.6, rho=0.1, rho_eq_scale=1e3,
                    max_iter=4000, check_every=25,
                    eps_abs=1e-8, eps_rel=1e-8) -> NativeQPResult:
    """One QP ``min 0.5 x'Px + q'x + sum_i c_i dist(A_i x, [l_i, u_i])``
    (c_i = inf: a hard row) from numpy arrays, in float64 on the host."""
    lib = _load()
    P = np.ascontiguousarray(P, np.float64)
    q = np.ascontiguousarray(q, np.float64)
    A = np.ascontiguousarray(A, np.float64)
    l = np.ascontiguousarray(l, np.float64)
    u = np.ascontiguousarray(u, np.float64)
    c = np.ascontiguousarray(c, np.float64)
    n = q.shape[0]
    m = l.shape[0]
    x = np.zeros(n) if x0 is None else np.array(x0, np.float64)
    z = (A @ x if z0 is None else np.array(z0, np.float64)).astype(np.float64)
    y = np.zeros(m) if y0 is None else np.array(y0, np.float64)

    dp = ctypes.POINTER(ctypes.c_double)

    def p(a):
        return a.ctypes.data_as(dp)

    iters = ctypes.c_int(0)
    pri = ctypes.c_double(0.0)
    dua = ctypes.c_double(0.0)
    status = lib.tpu_trajopt_qp_solve(
        n, m, p(P), p(q), p(A), p(l), p(u), p(c),
        sigma, alpha, rho, rho_eq_scale, max_iter, check_every,
        eps_abs, eps_rel,
        p(x), p(z), p(y), ctypes.byref(iters), ctypes.byref(pri),
        ctypes.byref(dua))
    if status < 0:
        raise RuntimeError("native QP factorization failed")
    return NativeQPResult(x=x, z=z, y=y, iters=int(iters.value),
                          pri_res=float(pri.value), dua_res=float(dua.value),
                          converged=status == 0)
