"""Smoke run of the PyTorch/CUDA port (``trajopt_tpu_torch``) on one card.

Phases, each of which must pass:

1. the card: its name and power limit, the torch/CUDA versions and the
   TF32 settings (all off);
2. build the hand-written kernels ``csrc/admm_block_chunk.cu`` and
   ``csrc/admm_dense_chunk.cu`` with nvcc, both at once;
3. hold the block kernel against its plain PyTorch version at the
   flagship QP shapes (T 30, D 8, K 2, R 40, B 256, 150 iterations), on
   seeded data with hard, penalty and inert padded rows and one lane with
   a planted NaN, and on the flagship's first QP; time both versions on
   the latter and compute the bound and the cluster design's floor; print
   the cluster size, the shared memory per block and how many clusters
   the card holds at once;
4. hold the dense kernel against its plain version at the arm7 shapes
   (n 210, m 449, B 128, 20 iterations), on seeded data with hard,
   equality, penalty and box rows, a planted NaN lane and an ``active``
   mask, and on the arm7 path's first QP; time both versions on the
   latter and compute the bound and the cluster design's floor; print the
   cluster size, the shared memory per block and how many clusters the
   card holds at once; one adaptive-rho ``solve_qp`` of that QP on the
   card against float64;
5. small problems (10 steps, 3 lanes) on the card (float32, kernels)
   against the CPU (plain versions): for pr2ish one QP step (convexify,
   prepare, 450 ADMM iterations) against float64, and a whole solve of
   each path (pr2ish block, arm7 dense) against float32;
6. the flagship: the cast solve (pr2ish, 30 steps, LVS 2, B = 256 lanes)
   through ``pr2ish_table_problem`` / ``TrajOptProblem.make_solve(...,
   structured=True)``, then the independent swept check of every lane;
   the block kernel's launch count over that solve; a profiled repeat for
   the device's idle share and the chunk kernel's in-path time;
7. the arm7 discrete workload (30 steps, B = 128 lanes) through
   ``arm_table_problem`` / ``make_solve(discrete_params())`` on the dense
   QP path, the same checks with the dense kernel's launch count; then
   the same workload on the block path (``structured=True``, its cluster
   size printed), counts and rate only.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

The last line of standard output is ``{"ok": true, "device": ...}``; the
line before it lists the kernels with their launches, errors and times.
Exits non-zero, printing no result line, on any failure and when no CUDA
device is present.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from trajopt_tpu_torch.models.benchmarks import (arm_table_batch,
                                                 arm_table_problem,
                                                 pr2ish_table_batch,
                                                 pr2ish_table_problem,
                                                 swept_verify)
from trajopt_tpu_torch.qp import admm as dense
from trajopt_tpu_torch.qp import block_banded as bb
from trajopt_tpu_torch.qp import fused_block as fb
from trajopt_tpu_torch.qp import fused_dense as fd
from trajopt_tpu_torch.qp.admm import ADMMConfig
from trajopt_tpu_torch.qp.inverse import cholesky_inverse
from trajopt_tpu_torch.qp.admm_block import (chunk_operands,
                                             prepare_qp_block,
                                             solve_qp_block_prepared)
from trajopt_tpu_torch.sqp import nlp as nlp_mod
from trajopt_tpu_torch.sqp.params import SQPParams, SQPStatus
from trajopt_tpu_torch.sqp.solver import block_qp, build_qp, make_solver

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# Shared memory per SM and clock: 32 banks of 4 bytes, each serving one
# access a clock (CUDA C++ Programming Guide, "Compute Capabilities",
# shared memory of compute capability 5.x and later: "each bank has a
# bandwidth of 32 bits per clock cycle"); times the SM count and the
# maximum SM clock read from the card.  Used only for the printed design
# floors of phases 3 and 4.
SMEM_BYTES_PER_CLK = 32 * 4

T, D, K, R, B, N_ITERS = 30, 8, 2, 40, 256, 150
# Kernel vs plain version, both float32 on the same inputs: they sum in
# another order (warp shuffles and shared-memory loops against batched
# GEMM and tensor reductions), and over 150 iterations the rounding grows
# past what a fixed relative bound can state -- the dual residual is a
# difference of terms ~20x its size.  So both are held against the plain
# version in float64 on the same (float32) inputs: the kernel's distance
# to it may be at most CHUNK_NOISE times the float32 plain version's own
# distance, plus CHUNK_FLOOR of the quantity's magnitude.
CHUNK_NOISE = 4.0
CHUNK_FLOOR = 1e-6
# Card (float32, kernel) against CPU (float64, plain version) on one small
# QP step: float32 convexification (inputs rounded at ~1e-7) and 450 ADMM
# iterations of float32 rounding, which the kernel check above measures at
# ~1e-4 of the state's magnitude per 150 iterations; 1e-3 of the
# solution's magnitude allows for that and still flags any wrong update.
SMALL_XTOL = 1e-3
# Card against CPU on a whole float32 solve (10 steps, 3 lanes): equal
# status and counts, and x within the bound the CPU test holds the port's
# float32 solve to against the JAX package's (two float32 solves summing
# in another order over 2 SQP steps and up to 900 ADMM iterations, on
# trajectories of magnitude ~2).
SOLVE_XTOL = 1e-4
MIN_VERIFIED = 243          # of 256 lanes: 95 %
# The arm7 discrete workload: B = 128 lanes of 30 steps; n = 210 variables,
# m = 449 dense QP rows (232 collision, 7 goal, 210 box).
ARM_B, ARM_STEPS = 128, 30
ARM_MIN_VERIFIED = 122      # of 128 lanes: 95 %


def flagship_params() -> SQPParams:
    """The JAX flagship's ``__graft_entry__._solver_params("cast")``."""
    return dataclasses.replace(
        SQPParams(), max_restarts=1,
        qp=ADMMConfig(eps_abs=2e-5, eps_rel=2e-5, max_iter=450,
                      check_every=150, adaptive_rho=False,
                      rho_dual_scale=0.1, ruiz_iters=10, ns_refresh=True,
                      ns_tol=1e-4, ns_power_iters=4))


def discrete_params() -> SQPParams:
    """The JAX discrete workload's ``__graft_entry__._solver_params(
    "discrete")``: fixed rho, 60 iterations in chunks of 20, eps 2e-5,
    rho_dual_scale 0.1, Ruiz 10, one restart (the NS refresh acts on the
    block path only)."""
    return dataclasses.replace(
        SQPParams(), max_restarts=1,
        qp=ADMMConfig(eps_abs=2e-5, eps_rel=2e-5, max_iter=60,
                      check_every=20, adaptive_rho=False,
                      rho_dual_scale=0.1, ruiz_iters=10, ns_refresh=True,
                      ns_tol=1e-4, ns_power_iters=4))


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def phase_device() -> str:
    smi = nvidia_smi("name,power.limit")
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    print(f"TF32: matmul {tf32[0]}, cudnn {tf32[1]}, float32 matmul "
          f"precision {tf32[2]!r}")
    if tf32 != (False, False, "highest"):
        raise SystemExit("TF32 must be off")
    return smi


def phase_build():
    """Both kernels at once, one nvcc each."""
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda mod: mod.build(verbose=True), (fb, fd)))
    print(f"built {fb.SOURCE.name} and {fd.SOURCE.name} for sm_90a in "
          f"{time.time() - t0:.1f} s")


def chunk_inputs(seed: int, dev):
    """Seeded QP data at the flagship shapes, built in float64: an SPD
    P, the x-update matrix M = P + sigma I + C'R C + rho_b diag(b^2) and
    its inverse, 32 weighted rows per step (4 hard, c = inf, two of them
    equalities with rho 100; 28 finite penalty rows, half of them
    equalities) and 8 inert padded rows (W = 0, l = -inf, u = +inf,
    c = 0), no rows past step T - K.  Returns (args, kw, live rows) for
    ``fb.chunk_*`` with args in float32."""
    rng = np.random.default_rng(seed)
    n, m, KD = T * D, T * R, K * D
    f64 = dict(dtype=torch.float64, device=dev)
    slot = np.arange(R)[None, :]
    live = np.zeros((T, R), bool)
    live[:T - K + 1, :32] = True
    Wb = rng.standard_normal((B, T, R, KD)) * live[None, :, :, None]
    hard = (live & (slot < 4)).reshape(-1)
    eq = (live & (slot % 2 == 0)).reshape(-1)
    live = live.reshape(-1)
    bnd = rng.standard_normal((B, m))
    lc = np.where(eq, bnd, -np.inf)
    uc = np.where(live, bnd, np.inf)
    c = np.where(hard, np.inf,
                 np.where(live, rng.uniform(1, 50, (B, m)), 0.0))
    rho_c = np.broadcast_to(np.where(hard & eq, 100.0, 0.1), (B, m)).copy()
    cr = np.where(np.isinf(c), np.inf, c / rho_c)
    A = rng.standard_normal((B, n, n)) / np.sqrt(n)
    P = A @ A.transpose(0, 2, 1) + np.eye(n)
    bd = rng.uniform(0.5, 1.5, (B, n))
    sigma, alpha, rho_b = 1e-6, 1.6, 0.1
    Wt = torch.as_tensor(Wb, **f64)
    C = bb.BlockBanded(Wb=Wt, plan=bb.BlockPlan(
        T=T, D=D, K=K, R=R, m=0, w=KD, blk_index=np.zeros(0, np.int64),
        scatter_idx=np.zeros(0, np.int64)))
    M = (torch.as_tensor(P, **f64) + sigma * torch.eye(n, **f64)
         + bb.at_r_a(C, torch.as_tensor(rho_c, **f64))
         + torch.diag_embed(torch.as_tensor(rho_b * bd * bd, **f64)))
    Minv = torch.linalg.inv(M)
    x = torch.as_tensor(rng.standard_normal((B, n)) * 0.1, **f64)
    yc = torch.as_tensor(rng.standard_normal((B, m)) * 0.01 * live, **f64)
    q = torch.as_tensor(rng.standard_normal((B, n)), **f64)
    q[7, 5] = float("nan")                      # the planted-NaN lane
    f = [Minv, Wt, torch.as_tensor(P, **f64), q,
         torch.as_tensor(lc, **f64), torch.as_tensor(uc, **f64),
         torch.as_tensor(cr, **f64), torch.as_tensor(rho_c, **f64),
         torch.as_tensor(-rng.uniform(0.1, 1, (B, n)), **f64),
         torch.as_tensor(rng.uniform(0.1, 1, (B, n)), **f64),
         torch.as_tensor(bd, **f64),
         torch.as_tensor(rng.uniform(0.5, 2, (B, m)), **f64),
         torch.as_tensor(rng.uniform(0.5, 2, (B, n)), **f64),
         torch.as_tensor(rng.uniform(0.5, 2, (B, n)), **f64),
         torch.as_tensor(rng.uniform(0.5, 2, (B,)), **f64),
         x, bb.matvec_wb(Wt, x, D), torch.as_tensor(bd, **f64) * x, yc,
         torch.zeros(B, n, **f64)]
    args = [t.to(torch.float32).contiguous() for t in f]
    kw = dict(D=D, sigma=sigma, alpha=alpha, rho_b=rho_b, n_iters=N_ITERS)
    return args, kw, live


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def first_qp(n_steps: int, lanes: int, seed: int, dev):
    """The main path's first QP for a pr2ish problem (LVS 2) on ``lanes``
    seeded lanes: convexified at the straight-line inits with the initial
    merit coefficients, equilibrated and factored as the solver does.
    Returns (prepared QP, trust-box lb, ub (0.1 around x), x)."""
    prob, _ = pr2ish_table_problem(n_steps=n_steps, lvs_substeps=2,
                                   device=dev)
    nlp = prob.build()
    inits, goals = pr2ish_table_batch(seed, lanes, n_steps, device=dev)
    x = inits.reshape(lanes, -1)
    params = {"goal": goals}
    lb, ub = prob.bounds(x)
    model = nlp_mod.convexify_structured(
        nlp, x, params, nlp_mod.linear_jacobians(nlp, x, params))
    plan = bb.make_plan(*nlp_mod.structured_band(nlp), *nlp.block)
    coeffs = x.new_full((lanes, nlp_mod.num_cnt_groups(nlp)), 10.0)
    prep = prepare_qp_block(block_qp(nlp, plan, model, coeffs, x),
                            flagship_params().qp)
    return (prep, torch.maximum(lb, x - 0.1), torch.minimum(ub, x + 0.1),
            x)


def hold(label: str, names, got, plain, ref) -> float:
    """Kernel outputs ``got`` and the float32 plain version's ``plain``
    against the float64 plain version's ``ref`` on the same float32
    inputs; prints, per quantity, its magnitude and each one's absolute
    and relative error.  Returns max |kernel - float32 plain|."""
    max_abs = 0.0
    for name, a, b, r in zip(names, got, plain, ref):
        if not (torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.isnan(a), torch.isnan(r))):
            raise SystemExit(f"{label}: NaN pattern of {name} differs "
                             f"between kernel and plain")
        ok = ~torch.isnan(r)
        r = r[ok]
        mag = float(r.abs().max())
        err = float((a[ok] - b[ok]).abs().max())
        err_k = float((a[ok].double() - r).abs().max())
        err_p = float((b[ok].double() - r).abs().max())
        tol = CHUNK_NOISE * err_p + CHUNK_FLOOR * mag
        rel = max(mag, 1e-30)
        print(f"{label} {name:6s}: max |r| {mag:.3e}; against float64: "
              f"kernel {err_k:.3e} (rel {err_k / rel:.2e}), float32 plain "
              f"{err_p:.3e} (rel {err_p / rel:.2e}), tolerance {tol:.3e}; "
              f"max |kernel - plain| {err:.3e}")
        if not err_k <= tol:
            raise SystemExit(f"{label}: kernel disagrees with plain on "
                             f"{name}: {err_k:.3e} > {tol:.3e}")
        max_abs = max(max_abs, err)
    return max_abs


def hold_chunk(label: str, args, kw):
    """The block kernel against its plain version (see :func:`hold`).
    Returns (kernel outputs, max |kernel - float32 plain|)."""
    (st_k, stats_k) = fb.chunk_cuda(*args, **kw)
    (st_p, stats_p) = fb.chunk_plain(*args, **kw)
    (st_r, stats_r) = fb.chunk_plain(*[a.double() for a in args], **kw)
    torch.cuda.synchronize()
    names = ("x", "zc", "zb", "yc", "yb", "pri", "dua", "ax_n", "z_n",
             "pAty_n")
    max_abs = hold(label, names, (*st_k, *stats_k), (*st_p, *stats_p),
                   (*st_r, *stats_r))
    return (st_k, stats_k), max_abs


def smem_ms(nbytes: int) -> tuple[float, int, float]:
    """(ms to read ``nbytes`` from shared memory on every SM at its peak
    rate, the SM count, the maximum SM clock in Hz)."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    clk = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    return nbytes / (n_sm * SMEM_BYTES_PER_CLK * clk) * 1e3, n_sm, clk


def bound(flops: int, nbytes: int) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, ms of the operations at the fp32 peak, ms
    of the bytes at the HBM rate)."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", t_ops, t_bytes)


def phase_kernel_check(dev) -> dict:
    args, kw, live = chunk_inputs(0, dev)
    (st_k, stats_k), err_syn = hold_chunk("seeded", args, kw)
    nan_lane = 7
    if not (torch.isnan(stats_k.pri[nan_lane])
            and torch.isnan(stats_k.dua[nan_lane])):
        raise SystemExit("the planted NaN did not reach pri/dua: a blown-up "
                         "QP would read as converged")
    others = torch.arange(B, device=dev) != nan_lane
    if torch.isnan(torch.stack(stats_k)[:, others]).any():
        raise SystemExit("NaN leaked into other lanes")
    pad = torch.as_tensor(~live, device=dev)
    if (st_k[1][others][:, pad] != 0).any() or \
            (st_k[3][others][:, pad] != 0).any():
        raise SystemExit("padded inert rows moved")
    print(f"planted NaN lane {nan_lane}: pri {float(stats_k.pri[nan_lane])}, "
          f"dua {float(stats_k.dua[nan_lane])} (not converged, as in JAX); "
          f"padded rows stay 0")

    consts, state = chunk_operands(*first_qp(T, B, 0, dev))
    args = [t.contiguous() for t in (*consts, *state)]
    cfg = flagship_params().qp
    kw = dict(D=D, sigma=cfg.sigma, alpha=cfg.alpha, rho_b=cfg.rho,
              n_iters=cfg.check_every)
    _, err_main = hold_chunk("main-path", args, kw)
    ms = cuda_ms(lambda: fb.chunk_cuda(*args, **kw), 10)
    plain_ms = cuda_ms(lambda: fb.chunk_plain(*args, **kw), 3)
    flops = fb.chunk_flops(args[1], D, kw["n_iters"])
    n_out = sum(a.numel() for a in args[15:]) + 5 * B
    nbytes = sum(t.numel() * t.element_size() for t in args) + 4 * n_out
    bound_ms, bound_by, t_ops, t_bytes = bound(flops, nbytes)
    cs, smem = fb.cluster_plan(T, D, K, R)
    clusters = fb.max_active_clusters(T, D, K, R)
    # The cluster design's floor: Minv read from shared memory once per
    # iteration, plus one load of Minv and the weights from device memory.
    minv = args[0].numel() * 4
    floor_smem, n_sm, clk = smem_ms(kw["n_iters"] * minv)
    floor_load = (minv + args[1].numel() * 4) / PEAK_HBM_BYTES * 1e3
    floor_ms = floor_smem + floor_load
    print(f"block kernel: clusters of {cs} blocks, {smem} B of shared "
          f"memory per block, at most {clusters} clusters resident "
          f"(cudaOccupancyMaxActiveClusters) -> {B / clusters:.2f} waves "
          f"of {B} problems")
    print(f"chunk on the main path's first QP, B={B}, {kw['n_iters']} "
          f"iterations: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; bound "
          f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP -> "
          f"{t_ops:.4f} ms, {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms); "
          f"design floor {floor_ms:.4f} ms (Minv from shared memory "
          f"{kw['n_iters'] * minv / 1e9:.2f} GB on {n_sm} SMs x "
          f"{SMEM_BYTES_PER_CLK} B/clk at {clk / 1e6:.0f} MHz -> "
          f"{floor_smem:.4f} ms, plus one load of Minv and Wb "
          f"{floor_load:.4f} ms)")
    return {"name": "admm_block_chunk", "route": "cuda",
            "source": "trajopt_tpu_torch/csrc/admm_block_chunk.cu",
            "replaces": "trajopt_tpu/qp/pallas_block.py:182",
            "max_abs_err": max(err_syn, err_main), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes the chunk
            "library_ms": None}


def dense_chunk_inputs(seed: int, dev):
    """Seeded dense QPs at the arm7 shapes (B 128, n 210, m 449), built in
    float64: SPD P; 239 constraint rows -- 7 hard equalities (rho 100),
    then a seeded mix of hard inequalities, penalty inequalities and
    penalty equalities (c in [1, 50]) -- and 210 hard box rows; Minv of
    the matching x-update system; lane 5 with a planted NaN.  Returns
    (args in float32, kw) for ``fd.chunk_*``."""
    rng = np.random.default_rng(seed)
    n, m = 210, 449
    m_c = m - n
    f64 = dict(dtype=torch.float64, device=dev)
    A = np.concatenate([rng.standard_normal((ARM_B, m_c, n)) / np.sqrt(n),
                        np.broadcast_to(np.eye(n), (ARM_B, n, n))], 1)
    kind = rng.integers(0, 3, (ARM_B, m_c))   # hard ineq / soft ineq / soft eq
    kind[:, :7] = 3                           # hard equalities
    bnd = rng.standard_normal((ARM_B, m_c))
    l = np.concatenate([np.where(kind >= 2, bnd, -np.inf),
                        np.full((ARM_B, n), -1.0)], 1)
    u = np.concatenate([bnd, np.full((ARM_B, n), 1.0)], 1)
    c = np.concatenate([np.where((kind == 0) | (kind == 3), np.inf,
                                 rng.uniform(1, 50, (ARM_B, m_c))),
                        np.full((ARM_B, n), np.inf)], 1)
    rho = np.where(np.isinf(c) & (u - l < 1e-10), 100.0, 0.1)
    G = rng.standard_normal((ARM_B, n, n)) / np.sqrt(n)
    At = torch.as_tensor(A, **f64)
    M = (torch.as_tensor(G @ G.transpose(0, 2, 1) + np.eye(n), **f64)
         + 1e-6 * torch.eye(n, **f64)
         + At.transpose(1, 2) @ (torch.as_tensor(rho, **f64)[..., None]
                                 * At))
    x = rng.standard_normal((ARM_B, n)) * 0.1
    q = rng.standard_normal((ARM_B, n))
    q[5, 2] = np.nan                          # the planted-NaN lane
    f = [cholesky_inverse(M), At] + [torch.as_tensor(v, **f64) for v in (
        q, l, u, c / rho, rho, x, np.einsum("bmn,bn->bm", A, x),
        rng.standard_normal((ARM_B, m)) * 0.01)]
    kw = dict(sigma=1e-6, alpha=1.6, n_iters=discrete_params().qp.check_every)
    return [t.to(torch.float32).contiguous() for t in f], kw


def arm7_first_qp(n_steps: int, lanes: int, seed: int, dev):
    """The arm7 dense path's first QP on ``lanes`` seeded lanes:
    convexified at the straight-line inits with the initial merit
    coefficients, trust box 0.1 around x.  Returns (QPData, x)."""
    prob, _ = arm_table_problem(n_steps=n_steps, device=dev)
    nlp = prob.build()
    inits, goals = arm_table_batch(seed, lanes, n_steps, device=dev)
    x = inits.reshape(lanes, -1)
    params = {"goal": goals}
    lb, ub = prob.bounds(x)
    model = nlp_mod.convexify(nlp, x, params,
                              nlp_mod.linear_jacobians(nlp, x, params))
    coeffs = x.new_full((lanes, nlp_mod.num_cnt_groups(nlp)),
                        discrete_params().initial_merit_error_coeff)
    return build_qp(nlp, model, coeffs, torch.maximum(lb, x - 0.1),
                    torch.minimum(ub, x + 0.1)), x


def hold_dense(label: str, args, kw):
    """The dense kernel against its plain version (see :func:`hold`).
    Returns (kernel outputs, max |kernel - float32 plain|)."""
    got = fd.chunk_cuda(*args, **kw)
    plain = fd.chunk_plain(*args, **kw)
    ref = fd.chunk_plain(*[a.double() for a in args], **kw)
    torch.cuda.synchronize()
    return got, hold(label, ("x", "z", "y", "Ax"), got, plain, ref)


def phase_dense_kernel_check(dev) -> dict:
    args, kw = dense_chunk_inputs(0, dev)
    got, err_syn = hold_dense("dense seeded", args, kw)
    nan_lane = 5
    others = torch.arange(ARM_B, device=dev) != nan_lane
    if not all(bool(torch.isnan(t[nan_lane]).all()) for t in got):
        raise SystemExit("dense: the planted NaN did not fill its lane")
    if any(bool(torch.isnan(t[others]).any()) for t in got):
        raise SystemExit("dense: NaN leaked into other lanes")
    active = torch.arange(ARM_B, device=dev) % 3 != 0
    masked = fd.chunk(*args, **kw, active=active)

    def same(a, b):        # bit-equal, NaN where NaN
        return torch.equal(torch.nan_to_num(a, nan=7.0),
                           torch.nan_to_num(b, nan=7.0))

    for new, old, full in zip(masked[:3], args[7:], got[:3]):
        if not (same(new[~active], old[~active])
                and same(new[active], full[active])):
            raise SystemExit("dense: the active mask changed a skipped lane "
                             "or an active one")
    print(f"dense planted NaN lane {nan_lane}: all outputs NaN, none "
          f"elsewhere; active mask: skipped lanes unchanged, active lanes "
          f"bit-equal to the unmasked launch")

    cfg = discrete_params().qp
    qp, x0 = arm7_first_qp(ARM_STEPS, ARM_B, 0, dev)
    args = dense.chunk_operands(qp, x0, cfg)
    _, err_main = hold_dense("dense main-path", args, kw)
    ms = cuda_ms(lambda: fd.chunk_cuda(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: fd.chunk_plain(*args, **kw), 5)
    n_iters = kw["n_iters"]
    bound_ms, bound_by, t_ops, t_bytes = bound(
        fd.chunk_flops(args[1], n_iters), fd.chunk_bytes(args[1]))
    B, m, n = args[1].shape
    cs, smem = fd.cluster_plan(n, m)
    clusters = fd.max_active_clusters(n, m)
    # The cluster design's floor: A and Minv read from shared memory once
    # per iteration (A once more before the first), plus one load of both
    # from device memory.
    mats = fd.chunk_stream_bytes(args[1], n_iters)
    floor_smem, n_sm, clk = smem_ms(mats)
    floor_load = 4 * (args[0].numel() + args[1].numel()) / PEAK_HBM_BYTES \
        * 1e3
    floor_ms = floor_smem + floor_load
    print(f"dense kernel: clusters of {cs} blocks (0: the streaming kernel), "
          f"{smem} B of shared memory per block, at most {clusters} "
          f"clusters resident (cudaOccupancyMaxActiveClusters) -> "
          f"{B / clusters:.2f} waves of {B} problems")
    print(f"dense chunk on the arm7 path's first QP, B={B}, n={n}, m={m}, "
          f"{n_iters} iterations: kernel {ms:.4f} ms, plain {plain_ms:.3f} "
          f"ms; bound {bound_ms:.4f} ms by {bound_by} "
          f"({fd.chunk_flops(args[1], n_iters) / 1e9:.3f} GFLOP -> "
          f"{t_ops:.4f} ms, {fd.chunk_bytes(args[1]) / 1e6:.1f} MB -> "
          f"{t_bytes:.4f} ms); design floor {floor_ms:.4f} ms (A and Minv "
          f"from shared memory {mats / 1e9:.3f} GB on {n_sm} SMs x "
          f"{SMEM_BYTES_PER_CLK} B/clk at {clk / 1e6:.0f} MHz -> "
          f"{floor_smem:.4f} ms, plus one load of A and Minv "
          f"{floor_load:.4f} ms)")

    # The adaptive-rho path (a refactorization per chunk) launches the
    # kernel too: the path's 60 iterations (3 chunks, eps 0 so that all
    # run) on the card against float64 on the CPU.  Each rho step makes M
    # worse conditioned, and the float32 factorization loses digits with
    # it: the CPU's float32 plain path is 3e-4 from float64 here (1e-3 at
    # 100 iterations), within SMALL_XTOL of the magnitude.
    acfg = dataclasses.replace(cfg, adaptive_rho=True, eps_abs=0.0,
                               eps_rel=0.0)
    fd.COUNTER.reset()
    res = dense.solve_qp(qp, x0, cfg=acfg)
    torch.cuda.synchronize()
    launches = fd.COUNTER.launches
    ref = dense.solve_qp(dense.QPData(*(t.double().cpu() for t in qp)),
                         x0.double().cpu(), cfg=acfg)
    dx = float((res.x.double().cpu() - ref.x).abs().max())
    tol = SMALL_XTOL * max(1.0, float(ref.x.abs().max()))
    print(f"adaptive-rho solve_qp of that QP ({acfg.max_iter} "
          f"iterations): {launches} kernel launches; card float32 vs CPU "
          f"float64 max |dx| {dx:.3e}, tolerance {tol:.3e}")
    if launches <= 0:
        raise SystemExit("the adaptive-rho solve did not launch the kernel")
    if not dx <= tol:
        raise SystemExit(f"adaptive-rho solve: card and CPU differ by "
                         f"{dx:.3e}")
    return {"name": "admm_dense_chunk", "route": "cuda",
            "source": "trajopt_tpu_torch/csrc/admm_dense_chunk.cu",
            "replaces": "trajopt_tpu/qp/pallas_admm.py:31",
            "max_abs_err": max(err_syn, err_main), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes the chunk
            "library_ms": None}


def small_qp_step(dev) -> torch.Tensor:
    """The first QP of pr2ish (10 steps, 3 lanes) on ``dev``, run for all
    450 ADMM iterations (eps 0).  Returns the QP solutions [3, 80]."""
    prep, lb, ub, x = first_qp(10, 3, 5, dev)
    cfg = dataclasses.replace(flagship_params().qp, eps_abs=0.0, eps_rel=0.0)
    return solve_qp_block_prepared(prep, lb, ub, x, cfg=cfg).x


def small_solve(path: str, dev):
    """A whole 10-step solve on 3 lanes in float32 on ``dev``: ``"pr2ish"``
    (flagship settings, LVS 2, block path) or ``"arm7"`` (discrete
    settings, dense path) -- the inputs of the CPU tests that hold the
    port's float32 solves against the JAX package's."""
    if path == "pr2ish":
        prob, _ = pr2ish_table_problem(n_steps=10, lvs_substeps=2,
                                       device=dev)
        solve = make_solver(prob.build(), flagship_params(), structured=True)
        inits, goals = pr2ish_table_batch(0, 3, 10, dtype=torch.float32,
                                          device=dev)
    else:
        # Seed 1: its float32 decisions clear their thresholds, so two
        # float32 implementations take the same path (the CPU gives the
        # same counts at any thread count and under 3e-6 perturbations of
        # the inits, and they equal float64's).  With seed 0 a trust-region
        # test lands within rounding of min_approx_improve and the CPU's
        # own counts change with its thread count (PERF.md).
        prob, _ = arm_table_problem(n_steps=10, device=dev)
        solve = make_solver(prob.build(), discrete_params())
        inits, goals = arm_table_batch(1, 3, 10, dtype=torch.float32,
                                       device=dev)
    x0 = inits.reshape(3, -1)
    res = solve(x0, *prob.bounds(x0), {"goal": goals})
    return [t.cpu() for t in (res.status, res.n_iter, res.n_qp_solves,
                              res.x)]


def phase_small_reference():
    """The card's paths (float32, kernels) against the CPU's plain
    versions, which the CPU tests hold against the JAX package: one pr2ish
    QP step against float64, and a whole solve of each path against
    float32."""
    fb.COUNTER.reset()
    gpu = small_qp_step(torch.device("cuda")).double().cpu()
    if fb.COUNTER.launches == 0:
        raise SystemExit("the card's QP step did not launch the kernel")
    cpu = small_qp_step(torch.device("cpu"))
    dx = float((gpu - cpu).abs().max())
    tol = SMALL_XTOL * max(1.0, float(cpu.abs().max()))
    print(f"small QP step (pr2ish 10 steps, 3 lanes, 450 iterations): card "
          f"float32 vs CPU float64 max |dx| {dx:.3e}, tolerance {tol:.3e}")
    if not dx <= tol:
        raise SystemExit(f"card and CPU QP solutions differ by {dx:.3e}")

    for path, counter in (("pr2ish", fb.COUNTER), ("arm7", fd.COUNTER)):
        counter.reset()
        gpu = small_solve(path, torch.device("cuda"))
        if counter.launches == 0:
            raise SystemExit(f"small {path} solve did not launch its kernel")
        cpu = small_solve(path, torch.device("cpu"))
        dx = float((gpu[3] - cpu[3]).abs().max())
        names = ("status", "SQP iterations", "QP solves")
        print(f"small solve ({path} 10 steps, 3 lanes, float32): card vs "
              f"CPU " + ", ".join(f"{n} {g.tolist()} vs {c.tolist()}"
                                  for n, g, c in zip(names, gpu, cpu))
              + f"; max |dx| {dx:.3e}, tolerance {SOLVE_XTOL:.0e}")
        for n, g, c in zip(names, gpu, cpu):
            if not torch.equal(g, c):
                raise SystemExit(f"small {path} solve: {n} differ between "
                                 f"card and CPU")
        if not dx <= SOLVE_XTOL:
            raise SystemExit(f"small {path} solve: card and CPU x differ by "
                             f"{dx:.3e}")


# The solver's profiler ranges (torch.profiler.record_function), one per
# layer: convexification, QP preparation (Ruiz, dual-cost scale and the
# factorization; per SQP step on the block path, per QP inside "sqp.qp"
# on the dense path), the QP solves, and the model and exact evaluations
# of the trust-region test.
LAYERS = ("sqp.convexify", "qp.prepare", "sqp.qp", "sqp.evaluate")


def layer_split(prof) -> str:
    """Host time (inclusive) and device time of the kernels launched inside
    each of the solver's ranges, summed over their calls."""
    tot = {name: [0.0, 0.0, 0] for name in LAYERS}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in tot:
            t = tot[e.name]
            t[0] += e.cpu_time_total
            t[1] += e.device_time_total
            t[2] += 1
    return "; ".join(f"{n} host {h / 1e3:.1f} ms, device {d / 1e3:.1f} ms "
                     f"({c} calls)" for n, (h, d, c) in tot.items())


def device_busy_share(prof, wall_us: float) -> float | None:
    """Share of the wall time during which a kernel ran (union of the
    profiler's device intervals, the ranges' own annotations left out),
    or None when the trace has none."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name not in LAYERS)
    if not spans:
        return None
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy / wall_us


def kernel_time(prof, kernel: str) -> tuple[int, float]:
    """(launches, device ms) of the traced kernels whose name holds
    ``kernel``."""
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.name]
    return len(spans), sum(spans) / 1e3


def drive_path(label: str, solve, scene, batch, B: int, n_steps: int,
               n_dof: int, counter, kernel: str, smi: str,
               min_verified: int | None, profile: bool = True) -> int:
    """A warm-up solve, then the measured solve of ``B`` seeded lanes with
    the kernel's launch count set to 0 just before and read just after;
    the independent swept check of every lane; with ``profile`` a
    profiled repeat for the device's idle share, its top kernels and the
    in-path time of the chunk kernel ``kernel``.
    Fails below ``min_verified`` converged and swept-verified lanes or
    when the kernel never launched.  Returns the launch count."""
    inits, goals = batch(0, B, n_steps)
    t0 = time.time()
    solve(inits, {"goal": goals})
    torch.cuda.synchronize()
    print(f"{label}: warm-up solve {time.time() - t0:.2f} s")

    inits, goals = batch(1, B, n_steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter.reset()
    t0 = time.time()
    res = solve(inits, {"goal": goals})
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = counter.launches

    if tuple(res.x.shape) != (B, n_steps * n_dof) or \
            not bool(torch.isfinite(res.x).all()):
        raise SystemExit(f"{label}: trajectories not finite or of the "
                         f"wrong shape")
    traj = res.x.reshape(B, n_steps, n_dof)
    mins = swept_verify(scene, traj)
    conv = res.status == SQPStatus.CONVERGED
    verified = conv & (mins > 0)
    n_conv, n_ver = int(conv.sum()), int(verified.sum())
    goal_err = (float((traj[conv, -1] - goals[conv]).abs().max())
                if n_conv else float("nan"))
    print(f"{label}: converged {n_conv}/{B}, converged and swept-verified "
          f"{n_ver}/{B}, worst clearance {float(mins.min()):+.4f}, max goal "
          f"error {goal_err:.2e}, mean SQP iterations "
          f"{float(res.n_iter.float().mean()):.2f}, mean QP solves "
          f"{float(res.n_qp_solves.float().mean()):.2f}, statuses "
          f"{torch.bincount(res.status.cpu().long(), minlength=5).tolist()}")
    print(f"{label}: {wall:.3f} s for {B} lanes -> {n_ver / wall:.2f} "
          f"verified solves/s on {smi}; kernel launches {launches}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB")
    if launches <= 0:
        raise SystemExit(f"{label}: the solve never launched its kernel")
    if min_verified is not None and n_ver < min_verified:
        raise SystemExit(f"{label}: only {n_ver}/{B} lanes converged and "
                         f"verified (< {min_verified})")
    if not profile:
        return launches

    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.time()
        solve(inits, {"goal": goals})
        torch.cuda.synchronize()
        pwall = time.time() - t0
    share = device_busy_share(prof, pwall * 1e6)
    if share is None:
        print(f"{label}: device idle share not measured (no device events "
              f"traced)")
    else:
        print(f"{label}: profiled solve {pwall:.3f} s wall, device busy "
              f"{share:.4f}, idle share {1 - share:.4f} (under the "
              f"profiler)")
        print(f"{label}: by layer: {layer_split(prof)}")
        n_k, ms_k = kernel_time(prof, kernel)
        print(f"{label}: {kernel} in the path: {launches} launches "
              f"counted, {n_k} traced, {ms_k:.3f} ms device time "
              f"({ms_k / max(n_k, 1):.4f} ms each)")
        print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                        row_limit=12, max_name_column_width=60))
    return launches


def phase_flagship(smi: str) -> int:
    prob, scene = pr2ish_table_problem(n_steps=30, lvs_substeps=2)
    return drive_path("flagship", prob.make_solve(flagship_params(),
                                                  structured=True),
                      scene, pr2ish_table_batch, B, 30, 8, fb.COUNTER,
                      "admm_block_chunk_kernel", smi, MIN_VERIFIED)


def phase_arm7(smi: str) -> int:
    """The arm7 discrete workload on the dense path (the default entry
    point, ``make_solve`` with ``structured=False``), then on the block
    path (``bench.py``'s ``discrete_arm7`` line), counts and rate only."""
    prob, scene = arm_table_problem(n_steps=ARM_STEPS)
    launches = drive_path("arm7 dense", prob.make_solve(discrete_params()),
                          scene, arm_table_batch, ARM_B, ARM_STEPS, 7,
                          fd.COUNTER, "admm_dense_", smi,
                          ARM_MIN_VERIFIED)
    nlp = prob.build()
    plan = bb.make_plan(*nlp_mod.structured_band(nlp), *nlp.block)
    shape = (plan.T, plan.D, plan.K, plan.R)
    cs, smem = fb.cluster_plan(*shape)
    print(f"arm7 block: QP shape (T, D, K, R) {shape}, block kernel in "
          f"clusters of {cs} ({smem} B of shared memory per block)")
    drive_path("arm7 block", prob.make_solve(discrete_params(),
                                             structured=True),
               scene, arm_table_batch, ARM_B, ARM_STEPS, 7, fb.COUNTER,
               "admm_block_chunk_kernel", smi, None, profile=False)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.time()
    smi = phase_device()
    phase_build()
    block = phase_kernel_check(dev)
    dense_k = phase_dense_kernel_check(dev)
    phase_small_reference()
    block["launches"] = phase_flagship(smi)
    dense_k["launches"] = phase_arm7(smi)
    print(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": [block, dense_k]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
