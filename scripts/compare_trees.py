"""Run the same ``chip_smoke.py`` phases of two trees on one card, in the
order parent, change, change, parent, so that the two trees' numbers come
from one machine and one power limit.

    git archive <parent commit> | tar -x -C _work/parent
    python3 scripts/compare_trees.py _work/parent kernels flagship hard_mix arm7 unified

Each run is a process of its own in that tree's root: it imports that
tree's ``chip_smoke.py`` and calls ``phase_device``, ``phase_build`` and
then ``phase_<name>(smi)`` (``phase_<name>()`` for a phase that takes no
argument, as ``collision_scenes``) for each name given (default:
flagship, hard_mix, arm7, unified).  Phase 14 reads the trajectories the
phases before it kept: ``flagship arm7 hard_mix unified collision_scenes
external`` runs it.  Every run's output is printed between
``=== <side> <tree>`` and ``=== <side> rc=<code>`` lines; the script exits
non-zero when a run fails.

The name ``kernels`` (run first when given) holds the two narrowphase
kernels of the two trees against each other.  Each run takes its own
tree's ``chip_smoke.convex_main_inputs`` (the unified flagship's first
convexification) and ``primitive_main_inputs`` (the flagship's first
convexification and evaluation), both at B = 256 from the same seeds, and
calls its tree's ``fused_convex.select_cuda`` on every search call
(float32, and the largest in float64) and on seeded pairs of large hulls
(:data:`HULLS` queries of 200 x 200 vertices, float32 and float64: the
shapes of a mesh link's hull, outside the compile-time instantiations),
and ``fused_primitive.query_cuda`` on every primitive call (float32, and
the largest in float64); it times each kernel at its timed call (the
search's largest call and the float32 large hulls, the primitive swept
Jacobian call).  The first parent and the first change run save
their outputs in a temporary directory; then every output tensor of the
change is held against the parent's with ``torch.equal`` (NaN where NaN):
the queries that differ are counted per call, the counts are written to
``chiprun_out/compare_kernels.json``, and the script exits non-zero if
any query differs.

At the end the script prints a summary: for each timed kernel call, each
solve's wall time, verified counts, primitive kernel device time and
convex narrowphase range, the four runs' readings side by side.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

RUN = """
import os, sys, time
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as cs
from trajopt_tpu_torch.collision import fused_convex as fc
from trajopt_tpu_torch.collision import fused_primitive as fp

HULLS = 32771


def hulls(dev, dtype, n=HULLS, A=200, B=200, K=20, seed=7):
    \"\"\"Seeded search inputs of n pairs of hulls of A and B vertices (points
    of spheres of 5-20 cm, every one a hull vertex; centres 20 cm apart in
    the mean, so that some overlap), K caller axes with a mask.\"\"\"
    g = np.random.default_rng(seed)

    def sphere(v):
        u = g.normal(size=(n, v, 3))
        return u / np.linalg.norm(u, axis=-1, keepdims=True) \\
            * g.uniform(0.05, 0.2, (n, 1, 1))

    Va = sphere(A)
    Vb = sphere(B) + g.normal(scale=0.2, size=(n, 1, 3))
    axes = g.normal(size=(n, K, 3))
    valid = torch.as_tensor(g.uniform(size=(n, K)) < 0.9, device=dev)
    Va, Vb, axes = (torch.as_tensor(a, dtype=dtype, device=dev)
                    for a in (Va, Vb, axes))
    return Va, Vb, axes, valid, Va.mean(-2) - Vb.mean(-2)


def kernels(save):
    dev = torch.device("cuda")
    out = {"convex": [], "convex_tags": [], "primitive": []}
    calls = cs.convex_main_inputs(dev)
    main = max(calls, key=lambda c: c[0][..., 0, 0].numel() * c[2].shape[-2])
    f64 = tuple(t.double() if t.is_floating_point() else t for t in main)
    big = [hulls(dev, torch.float32), hulls(dev, torch.float64)]
    tags = ["float32"] * len(calls) + ["float64, largest",
                                       "float32, large hulls",
                                       "float64, large hulls"]
    for inp, tag in zip([*calls, f64, *big], tags):
        out["convex"].append([t.cpu() for t in fc.select_cuda(*inp)])
        out["convex_tags"].append(tag)
    ms = cs.cuda_ms(lambda: fc.select_cuda(*main), 20)
    print(f"kernels: convex search on the largest call "
          f"({main[0][..., 0, 0].numel()} queries): {ms:.4f} ms", flush=True)
    ms = cs.cuda_ms(lambda: fc.select_cuda(*big[0]), 10)
    print(f"kernels: convex search on large hulls ({HULLS} queries, A "
          f"{big[0][0].shape[-2]}, B {big[0][1].shape[-2]}, float32): "
          f"{ms:.4f} ms", flush=True)
    if hasattr(cs, "print_gjk_steps"):
        for inp, tag in zip(big, tags[-2:]):
            cs.print_gjk_steps(f"kernels: convex search, {tag}",
                               fc.gjk_steps(*inp[:2]))
    calls = cs.primitive_main_inputs(dev)
    big = max(calls, key=lambda c: c[4])

    def query(call, dtype=None):
        scene, kind, fks, prm, n_out = call
        if dtype is not None:
            fks = tuple(tuple(t.to(dtype) for t in f) for f in fks)
        like = fks[0][0]
        plan = fp.plan_of(scene, kind, like)
        got = tuple(o.fill_(float("nan"))
                    for o in scene._outputs(kind, like, n_out - 1))
        fp.query_cuda(plan, fks, prm, got)
        return plan, fks, got

    for call in calls:
        out["primitive"].append([t.cpu() for t in query(call)[2]])
    out["primitive"].append([t.cpu() for t in query(big, torch.float64)[2]])
    plan, fks, got = query(big)
    ms = cs.cuda_ms(lambda: fp.query_cuda(plan, fks, big[3], got), 10)
    print(f"kernels: primitive narrowphase on the swept Jacobian call "
          f"({got[0].numel()} queries): {ms:.4f} ms", flush=True)
    if save != "-":
        torch.save(out, save)


t0 = time.time()
smi = cs.phase_device()
cs.phase_build()
save, names = sys.argv[1], sys.argv[2:]
for name in names:
    t1 = time.time()
    if name == "kernels":
        out = kernels(save)
    else:
        fn = getattr(cs, "phase_" + name)
        out = fn(smi) if fn.__code__.co_argcount else fn()
    print(f"{name} result: {out} ({time.time() - t1:.1f} s)", flush=True)
print(f"tree {os.getcwd()}: {time.time() - t0:.1f} s", flush=True)
"""


def differing(parent: list, change: list, rows: bool) -> list[int]:
    """Queries that differ, per call: a query differs when any of its
    output elements does (NaN equal to NaN).  Every output's last axis
    holds one query's values, except a primitive call's first (d, one
    value a query: ``rows`` False)."""
    import torch

    counts = []
    for a_call, b_call in zip(parent, change):
        bad = None
        for j, (a, b) in enumerate(zip(a_call, b_call)):
            same = a == b
            if a.dtype.is_floating_point:
                same |= torch.isnan(a) & torch.isnan(b)
            if rows or j > 0:
                same = same.all(-1)
            bad = ~same if bad is None else bad | ~same
        counts.append(int(bad.sum()))
    return counts


def compare_kernels(parent_file: Path, change_file: Path, out: Path) -> int:
    """Hold the change's kernel outputs against the parent's, write the
    counts to ``out``; returns the number of differing queries."""
    import torch

    par, chg = torch.load(parent_file), torch.load(change_file)
    report, total = {}, 0
    for what in ("convex", "primitive"):
        if len(par[what]) != len(chg[what]):
            raise SystemExit(f"kernels: {what}: {len(par[what])} parent "
                             f"calls against {len(chg[what])}")
        counts = differing(par[what], chg[what], what == "convex")
        shapes = [tuple(c[0].shape) for c in chg[what]]
        tags = chg.get(what + "_tags") or [
            "float64, largest" if i == len(counts) - 1 else "float32"
            for i in range(len(counts))]
        report[what] = [{"call": i, "tag": t, "shape": s,
                         "differing_queries": n}
                        for i, (t, s, n) in enumerate(zip(tags, shapes,
                                                          counts))]
        for i, (tag, s, n) in enumerate(zip(tags, shapes, counts)):
            print(f"kernels: {what} call {i} ({tag}, first output "
                  f"{s}): {n} queries differ from the parent's")
        total += sum(counts)
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return total


# (regex, name): the summary's readings, one a matching output line; the
# name may take the line's first group, the reading is the last group
SUMMARY = [
    (r"^kernels: (.+?) \(\d+ queries.*\): ([\d.]+) ms$", "{} ms"),
    (r"^(.+?): ([\d.]+) s for \d+ lanes -> ", "{}: s a solve"),
    (r"^(.+?): converged (\d+/\d+)", "{}: converged"),
    (r"^(.+?): primitive_narrowphase_kernel: \d+ launches traced in the "
     r"solve.*?, ([\d.]+) ms device time", "{}: primitive kernel ms"),
    (r"^(.+?): convex narrowphase \(collision\.convex\): ([\d.]+) ms",
     "{}: collision.convex range ms"),
    (r"^(.+?): swept check - tight sampled clearance .*; ([\d.]+) s$",
     "{}: external check s"),
]


def readings(text: str) -> dict[str, list[str]]:
    """The summary's readings in one run's output, by name."""
    got: dict[str, list[str]] = {}
    for line in text.splitlines():
        for pat, name in SUMMARY:
            m = re.match(pat, line)
            if m:
                got.setdefault(name.format(m.group(1)), []).append(
                    m.group(m.lastindex))
    return got


def run(tree: Path, save: str, phases: list[str]) -> tuple[int, str]:
    """One tree's process; its output is printed as it comes and
    returned."""
    proc = subprocess.Popen([sys.executable, "-c", RUN, save, *phases],
                            cwd=tree, stdout=subprocess.PIPE, text=True)
    lines = []
    for line in proc.stdout:
        print(line, end="", flush=True)
        lines.append(line)
    return proc.wait(), "".join(lines)


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    change = Path(__file__).resolve().parent.parent
    parent = Path(sys.argv[1]).resolve()
    phases = sys.argv[2:] or ["flagship", "hard_mix", "arm7", "unified"]
    if "kernels" in phases:
        phases = ["kernels"] + [p for p in phases if p != "kernels"]
    tmp = Path(tempfile.mkdtemp())
    saves = {"parent": tmp / "parent.pt", "change": tmp / "change.pt"}
    rc = 0
    runs = []
    try:
        for side, tree in (("parent", parent), ("change", change),
                           ("change", change), ("parent", parent)):
            save = saves[side]
            print(f"=== {side} {tree}", flush=True)
            code, text = run(tree, "-" if save.exists() else str(save),
                             phases)
            print(f"=== {side} rc={code}", flush=True)
            rc = rc or code
            runs.append((side, readings(text)))
        print("summary (parent, change, change, parent):")
        for name in dict.fromkeys(k for _, got in runs for k in got):
            print(f"summary: {name}: " + " | ".join(
                ", ".join(got.get(name, ["-"])) for _, got in runs))
        if "kernels" in phases and not rc:
            n = compare_kernels(saves["parent"], saves["change"],
                                change / "chiprun_out" / "compare_kernels.json")
            print(f"kernels: {n} queries differ in all")
            rc = 1 if n else 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
