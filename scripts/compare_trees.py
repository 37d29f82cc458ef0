"""Run the same ``chip_smoke.py`` phases of two trees on one card, in the
order parent, change, change, parent, so that the two trees' numbers come
from one machine and one power limit.

    git archive <parent commit> | tar -x -C _work/parent
    python3 scripts/compare_trees.py _work/parent flagship hard_mix arm7 unified

Each run is a process of its own in that tree's root: it imports that
tree's ``chip_smoke.py`` and calls ``phase_device``, ``phase_build`` and
then ``phase_<name>(smi)`` for each name given (default: flagship,
hard_mix, arm7, unified).  Every run's output is printed between
``=== <side> <tree>`` and ``=== <side> rc=<code>`` lines; the script exits
non-zero when a run fails.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

RUN = """
import os, sys, time
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
t0 = time.time()
smi = cs.phase_device()
cs.phase_build()
for name in sys.argv[1:]:
    t1 = time.time()
    out = getattr(cs, "phase_" + name)(smi)
    print(f"{name} result: {out} ({time.time() - t1:.1f} s)", flush=True)
print(f"tree {os.getcwd()}: {time.time() - t0:.1f} s", flush=True)
"""


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    change = Path(__file__).resolve().parent.parent
    parent = Path(sys.argv[1]).resolve()
    phases = sys.argv[2:] or ["flagship", "hard_mix", "arm7", "unified"]
    rc = 0
    for side, tree in (("parent", parent), ("change", change),
                       ("change", change), ("parent", parent)):
        print(f"=== {side} {tree}", flush=True)
        code = subprocess.call([sys.executable, "-c", RUN, *phases],
                               cwd=tree)
        print(f"=== {side} rc={code}", flush=True)
        rc = rc or code
    return rc


if __name__ == "__main__":
    sys.exit(main())
