"""Readings that the limits of ``correct`` are set from, on the card, at a
cell's own size: for each seed a short window of the cell, the program's
numbers against the float64 reference, and the control's (the reference in
the program's place, computed in TF32: ``reference/judge.py``).  All seeds
in one process, so set-up (kernel builds, captures) is paid once.

    python3 -m port_bench.control --workload <cell> --seconds 3 \
        --seeds <n> <n> ...

Prints one JSON line a seed, then the largest program reading and the
smallest control reading of each number.  The benchmark's own runs never
run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from port_bench import run
from port_bench.reference import judge


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dump", default=None,
                    help="a directory for each seed's judged lanes (.npz)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    program, control = [], []
    for seed in args.seeds:
        lanes = {}
        out = run.run_cell(args.workload, seed, args.seconds, False, dev,
                           time.perf_counter(), control=True, keep=lanes)
        if out is None:
            return 3
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
            np.savez_compressed(os.path.join(
                args.dump, f"{args.workload}.{seed}.npz"), **lanes)
        got = {k: v["value"] for k, v in out["checked"].items()}
        program.append(got)
        control.append(out["control"])
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "failed": out["failed"], "program": got,
                          "control": out["control"]}), flush=True)
    print(json.dumps({
        "workload": args.workload, "seeds": len(args.seeds),
        "program_max": {k: max(p[k] for p in program)
                        for k in judge.NUMBERS},
        "control_min": {k: min(c[k] for c in control)
                        for k in judge.NUMBERS}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
