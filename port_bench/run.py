"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A closed loop: one client hands the port a batch of planning problems (host
arrays of straight-line inits and goals; batch ``k`` of the window drawn
afresh by ``goals.goals`` from ``(seed, 0, k)``), waits for the solve and
the port's swept check of its result, and sends the next.  Set-up builds
the problem (and, in a fresh checkout, the port's kernels), then warms up
on batches from the disjoint stream ``(seed, 2, k)``: a solve at each
power of two of lanes, then whole batches until batches make no new
CUDA-graph capture.  The window measures ``--seconds`` and ends with the
last batch begun in it.  With ``--trace 1`` the window
runs under ``torch.profiler`` and the cell's per-layer metrics are read;
otherwise its end-to-end metrics.  Then a sample of the window's lanes is
judged by the float64 reference (``reference/judge.py``), and the last line
of standard output is the result as JSON.

Exits non-zero without printing a result when no CUDA device (or fewer than
the cell asks for) is present, and when ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``trajopt_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from port_bench import goals, roofline, spec  # noqa: E402
from port_bench.reference import judge  # noqa: E402
from port_bench.reference.robot import Robot  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "trajopt_tpu")
WARM_CLEAN = 3          # warm-up ends after this many batches without capture
WARM_MAX = 24           # ... or after this many batches
MEASURED, WARM, SAMPLE = 0, 2, 3    # seed streams: (seed, stream, ...)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What a run measured, as the metric readers (``metrics/*.py``) read
    it: per-batch lists, the window, set-up, counters and the trace."""

    def __init__(self):
        self.setup_s = None
        self.window_s = None
        self.walls, self.verify_s = [], []
        self.lanes, self.verified = [], []
        self.qp_max, self.qp_sum = [], []
        self.captures = None
        self.trace = None
        self.window_ns = None
        self.chunk_bound_s = {}

    @property
    def n_batches(self) -> int:
        return len(self.walls)


class ChunkProbe:
    """While installed, records each ADMM chunk launch's solved lanes (its
    ``active`` mask), the block kernel's weighted rows of those lanes, and
    the shapes and iterations, as device scalars read after the window."""

    def __init__(self):
        self.block, self.dense = [], []
        self._saved = None

    def install(self):
        import torch
        from trajopt_tpu_torch.qp import fused_block, fused_dense

        block_cuda, dense_cuda = fused_block.chunk_cuda, fused_dense.chunk_cuda

        def live(active, B, dev):
            return (torch.ones(B, dtype=torch.bool, device=dev)
                    if active is None else active.to(dev, torch.bool))

        def block(*args, D, n_iters, active=None, **kw):
            Wb = args[1]
            B, T, R, KD = Wb.shape
            on = live(active, B, Wb.device)
            rows = ((Wb != 0).any(-1) & on[:, None, None]).sum()
            self.block.append((on.sum(), rows, T, D, R, KD, n_iters))
            return block_cuda(*args, D=D, n_iters=n_iters, active=active,
                              **kw)

        def dense(*args, n_iters, active=None, **kw):
            A = args[1]
            B, m, n = A.shape
            on = live(active, B, A.device)
            self.dense.append((on.sum(), m, n, n_iters))
            return dense_cuda(*args, n_iters=n_iters, active=active, **kw)

        self._saved = (fused_block, block_cuda, fused_dense, dense_cuda)
        fused_block.chunk_cuda, fused_dense.chunk_cuda = block, dense

    def remove(self):
        if self._saved is not None:
            fb, bc, fd, dc = self._saved
            fb.chunk_cuda, fd.chunk_cuda = bc, dc
            self._saved = None

    def bound_s(self) -> dict:
        """{"block"/"dense": the launches' summed least time, seconds}."""
        out = {}
        if self.block:
            out["block"] = sum(roofline.bound_s(
                roofline.block_flops(int(n), int(r), T, D, KD, it),
                roofline.block_bytes(int(n), T, R, D, KD))
                for n, r, T, D, R, KD, it in self.block)
        if self.dense:
            out["dense"] = sum(roofline.bound_s(
                roofline.dense_flops(int(n), m, k, it),
                roofline.dense_bytes(int(n), m, k))
                for n, m, k, it in self.dense)
        return out


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, traffic_over: dict | None = None,
             fault=None, control: bool = False,
             keep: dict | None = None) -> dict | None:
    """One run of ``cell_name`` on ``device``; the result dict, or None
    when a forbidden module was loaded.  ``traffic_over`` replaces entries
    of the traffic mix and ``fault(solve, verify)`` wraps the solve and the
    swept check (tests: they run a small cell on the CPU and break the
    timed path).  With ``control`` the result also holds the control's
    numbers under ``"control"``, and ``keep`` (a dict) takes the judged
    lanes' arrays (``control.py``)."""
    import torch
    from torch.profiler import record_function

    import trajopt_tpu_torch.sqp.nlp as nlp_mod
    from trajopt_tpu_torch.models.benchmarks import swept_verify
    from trajopt_tpu_torch.sqp.params import SQPStatus
    from trajopt_tpu_torch.utils import aot_cache

    from port_bench import problem

    cell = spec.workload(cell_name)
    cfg = spec.config(cell["config"])
    mix = dict(spec.traffic(cell["traffic"]), **(traffic_over or {}))
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    robot = Robot(str(spec.ROOT / cfg["urdf"]))
    prob, scene, solve = problem.build(cfg, device)
    check_len = cfg["verify"]["check_len"]
    verify = (lambda s, traj: swept_verify(s, traj, check_len))
    if fault is not None:
        solve, verify = fault(solve, verify)
    nlp = prob.build()
    cost_col = [t.name for t in nlp.cost_sets].index("joint_vel")
    goal_cols = [g for t, _, g in nlp_mod.cnt_group_structure(nlp)
                 if t.name == "joint_pos"][0]
    B, T, D = mix["batch"], cfg["n_steps"], robot.n_dof
    dtype = np.float32 if device.type == "cuda" else np.float64
    entropy = (seed % 2**64,)

    def batch(stream: int, k: int, lanes: int = B):
        g = goals.goals(cfg["goals"], robot.lower, robot.upper,
                        entropy + (stream, k), B, mix["hard_frac"],
                        mix["goal_noise"])[:lanes]
        inits = goals.straight_inits(cfg["goals"]["home"], g, T)
        return inits.astype(dtype), g.astype(dtype)

    def one(inits, g):
        with record_function("bench.solve"):
            res = solve(inits, {"goal": g})
            _sync(device)
        tv = time.perf_counter()
        with record_function("bench.verify"):
            mins = verify(scene, res.x.reshape(len(g), T, D))
            ok = (res.status == SQPStatus.CONVERGED) & (mins > 0)
            n_ok = int(ok.sum())
        return res, mins, n_ok, tv

    # Warm-up: a solve of each smaller power of two of lanes (every live-lane
    # bucket the solver captures a region at), then whole batches until
    # WARM_CLEAN in a row capture nothing.  CUDA graphs are captured on the
    # card only: elsewhere one batch warms.
    k, clean = 0, 0
    if device.type == "cuda":
        for lanes in (1 << i for i in range(B.bit_length())):
            if lanes < B:
                one(*batch(WARM, k, lanes))
    warm_clean = WARM_CLEAN if device.type == "cuda" else 1
    while clean < warm_clean and k < WARM_MAX:
        before = aot_cache.STATS.captures
        one(*batch(WARM, k))
        clean = clean + 1 if aot_cache.STATS.captures == before else 0
        k += 1
    _sync(device)
    print(f"warm-up: {k} batches, {aot_cache.STATS.captures} captures",
          file=sys.stderr)

    run = Run()
    run.setup_s = time.perf_counter() - t_start
    kept = []
    probe = ChunkProbe() if trace else None
    prof = None
    if trace:
        probe.install()
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    aot_cache.STATS.reset()
    try:
        with record_function("bench.window"):
            t0 = time.perf_counter()
            k = 0
            while time.perf_counter() - t0 < seconds:
                inits, g = batch(MEASURED, k)
                tb = time.perf_counter()
                res, mins, n_ok, tv = one(inits, g)
                te = time.perf_counter()
                run.walls.append(te - tb)
                run.verify_s.append(te - tv)
                run.verified.append(n_ok)
                run.lanes.append(B)
                # copies: a result may view a larger buffer of the solver
                kept.append(tuple(t.clone() for t in (
                    res.x, res.status, res.cost_vals[:, cost_col],
                    res.cnt_viols, res.n_qp_solves, mins)))
                del res, mins
                k += 1
            run.window_s = time.perf_counter() - t0
    finally:
        if trace:
            t_trace = time.perf_counter()
            prof.__exit__(None, None, None)
            probe.remove()
    run.captures = aot_cache.STATS.captures
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return None

    nq = torch.stack([e[4] for e in kept]).cpu().numpy()
    # the swept check's sub-segments a gap in each batch, as it cuts them
    n_sub = [max(1, int(np.ceil(float(torch.linalg.vector_norm(
        torch.diff(e[0].reshape(B, T, D), dim=1), dim=-1).max())
        / check_len))) for e in kept]
    run.qp_max = nq.max(1).tolist()
    run.qp_sum = nq.sum(1).tolist()
    if trace:
        from port_bench.trace import Trace
        run.trace = Trace(prof)
        w = run.trace.ranges.get("bench.window")
        run.window_ns = w[0] if w else None
        run.chunk_bound_s = probe.bound_s()
        del prof
        print(f"trace: {len(run.trace.spans)} device spans, read in "
              f"{time.perf_counter() - t_trace:.1f} s", file=sys.stderr)

    # The sample judged: lanes drawn from the seed, and the lane that took
    # the most QP solves.
    n_all = nq.size
    rng = np.random.default_rng(entropy + (SAMPLE,))
    pick = set(rng.choice(n_all, size=min(mix["check_lanes"], n_all),
                          replace=False).tolist())
    pick.add(int(nq.argmax()))
    pick = sorted(pick)
    cols = {name: [] for name in ("x", "status", "cost", "viols", "mins")}
    inputs_g, subs = [], []
    for b in sorted({p // B for p in pick}):
        lanes = [p % B for p in pick if p // B == b]
        subs += [n_sub[b]] * len(lanes)
        idx = torch.as_tensor(lanes, device=kept[b][0].device)
        for name, t in zip(cols, kept[b][:4] + kept[b][5:]):
            cols[name].append(t.index_select(0, idx).double().cpu().numpy())
        inputs_g.append(batch(MEASURED, b)[1][lanes])
    del kept
    if device.type == "cuda":
        torch.cuda.empty_cache()
    x = np.concatenate(cols["x"]).reshape(-1, T, D)
    goal = np.concatenate(inputs_g).astype(np.float64)
    viols = np.concatenate(cols["viols"])
    status = np.concatenate(cols["status"])
    mins = np.concatenate(cols["mins"])
    claims = {"cost": np.concatenate(cols["cost"]),
              "goal": viols[:, goal_cols].sum(-1),
              "clearance": mins,
              "max_viol": viols.max(-1) if viols.shape[1] else
              np.zeros(len(x)),
              "converged": status == SQPStatus.CONVERGED,
              "verified": (status == SQPStatus.CONVERGED) & (mins > 0),
              "finite": np.isfinite(x).all((1, 2))}
    t_ref = time.perf_counter()
    ref = judge.recompute(cfg, robot, np.nan_to_num(x), goal, subs)
    values = judge.numbers(cfg, claims, ref)
    limits = cell["limits"]
    correct = judge.passes(values, limits)
    judge_s = time.perf_counter() - t_ref

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.cell_metrics(cell_name, section):
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted = int(sum(run.lanes))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": attempted - int(sum(run.verified)),
           "metrics": metrics, "device": dev}
    if trace and run.window_ns is not None:
        lo, hi = run.window_ns
        dev["busy_s"] = run.trace.busy_ns(lo, hi) / 1e9
        dev["window_s"] = (hi - lo) / 1e9
        out["breakdown"] = {"device_ops": run.trace.top_ops(10),
                            "idle_gaps": run.trace.idle_gaps(lo, hi, 10)}
    print(f"sampled lanes judged: {len(x)} of {attempted} "
          f"({run.n_batches} batches) in {judge_s:.1f} s",
          file=sys.stderr)
    for name in judge.NUMBERS:
        print(f"check {name}: {values[name]!r} (limit {limits[name]!r})",
              file=sys.stderr)
    if control:
        out["control"] = judge.numbers(cfg, judge.control_claims(
            cfg, robot, np.nan_to_num(x), goal, subs, claims), ref)
    if keep is not None:
        keep.update(x=x, goal=goal, n_sub=np.asarray(subs), lane=np.asarray(
            pick), **{f"claim_{k}": np.asarray(v) for k, v in claims.items()},
            **{f"ref_{k}": v for k, v in ref.items()})
    out["checked"] = {name: {"value": values[name], "limit": limits[name]}
                      for name in judge.NUMBERS}
    return out


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.workload(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)          # one process, few threads: steadier
    out = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0), T_START)
    if out is None:
        return 3
    sys.stdout.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
