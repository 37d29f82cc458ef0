"""What the port's own instrumentation leaves for the per-layer readers:
its counter registry, and the spans inside its captured CUDA graphs.

The port (``trajopt_tpu_torch/utils/profiling.py``) counts kernel
launches, queries, ADMM lane iterations and host syncs in one registry.
The run marks its window's start only by ``aot_cache.STATS.reset()``, so
the window's counts are the registry less its snapshot at that reset
(``STATS.since_reset()``).

A replayed graph runs no Python, so the spans inside a captured region
(``collision.fk``, ``collision.primitive``, ...) leave no host range on
replay.  Each capture records its graph's node map instead
(``aot_cache.node_maps()``: each traced node's kind and the stack of spans
it was launched under, in the order a replay runs them), and each replay
runs inside the range ``<region>.replay.<n>`` that names its map.  The
device spans launched by one replay, in start order, are that map's
nodes.  A port without these (an older commit) gives None throughout.
"""

from __future__ import annotations

import bisect
import re

REPLAY = re.compile(r"\.replay\.\d+$")


def counters() -> dict | None:
    """The port's counter registry over the window (since the run's
    ``STATS.reset()``), or None where the port keeps none."""
    from trajopt_tpu_torch.utils import aot_cache
    read = getattr(aot_cache.STATS, "since_reset", None)
    return None if read is None else read()


def _node_maps() -> dict | None:
    from trajopt_tpu_torch.utils import aot_cache
    read = getattr(aot_cache, "node_maps", None)
    return None if read is None else read()


class Subspans:
    """Each replayed device span's stack of spans inside its region, from
    the replay's node map.

    A replay's spans are those the trace launches inside its range, in
    device order.  The trace's launch times can also put a few eager spans
    there (a host op's id that another event shares), so a replay's spans
    are taken as the one run of as many spans as its map holds that runs
    back to back on the device (no other span starts among them) and whose
    kinds match the map.  ``mapped`` counts the spans handed a stack,
    ``unmapped`` those of replays with no such run, and ``foreign`` the
    eager spans set apart from a mapped run."""

    def __init__(self, trace, maps: dict):
        self.trace = trace
        reps = sorted((a, b, name) for name, rs in trace.ranges.items()
                      if REPLAY.search(name) for a, b in rs)
        begins = [a for a, _, _ in reps]
        runs: dict = {}
        for k, t in enumerate(trace.launch):
            i = bisect.bisect_right(begins, t) - 1 if t is not None else -1
            if i >= 0 and t <= reps[i][1]:
                runs.setdefault(i, []).append(k)
        starts = sorted(sp[1] for sp in trace.spans)
        self.path: dict = {}            # device span index -> span stack
        self.unmapped = self.foreign = 0
        for i, ks in runs.items():
            ks.sort(key=lambda k: trace.spans[k][1])
            m = maps.get(reps[i][2])
            n = 0 if m is None else len(m.kinds)
            found = [ks[w:w + n] for w in range(len(ks) - n + 1) if n
                     and self._block(ks[w:w + n], m.kinds, starts)]
            if len(found) != 1:
                self.unmapped += len(ks)
                continue
            self.foreign += len(ks) - n
            self.path.update(zip(found[0], m.paths))
        self.mapped = len(self.path)

    def _block(self, ks, kinds, starts) -> bool:
        """Whether spans ``ks`` ran back to back and have ``kinds``."""
        spans = self.trace.spans
        lo, hi = spans[ks[0]][1], spans[ks[-1]][1]
        if bisect.bisect_right(starts, hi) - bisect.bisect_left(starts, lo) \
                != len(ks):
            return False
        return all(("Memcpy" in spans[k][0], "Memset" in spans[k][0])
                   == (kind == "memcpy", kind == "memset")
                   for k, kind in zip(ks, kinds))

    def device_ns(self, name: str, within: str | None = None) -> int:
        """Device ns of the spans launched under span ``name``: eagerly
        inside its host range, or by a replay from one of its nodes; with
        ``within``, only those whose launch lies in that host range too."""
        ks = set(self.trace.inside(name))
        ks |= {k for k, p in self.path.items() if name in p}
        if within is not None:
            ks &= set(self.trace.inside(within))
        return sum(self.trace.spans[k][2] - self.trace.spans[k][1]
                   for k in ks)


def of(run) -> Subspans | None:
    """The run's :class:`Subspans` (built once a run), or None without a
    trace or node maps."""
    if run.trace is None:
        return None
    if not hasattr(run.trace, "_subspans"):
        maps = _node_maps()
        run.trace._subspans = (None if maps is None
                               else Subspans(run.trace, maps))
    return run.trace._subspans


def sync_names(trace) -> list[str]:
    """The names of the port's host-sync spans (``<layer>.sync.<site>``)
    the trace holds."""
    return [name for name in trace.ranges if ".sync." in name]
