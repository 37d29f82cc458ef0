"""A profile's raw events reduced to what the per-layer metrics read.

A frozen copy of ``chip_smoke.Trace`` (range attribution, device busy
time, kernel time by name) at commit f253e5b, plus the idle gaps of the
device timeline by the host range that was open when each began.  Ranges
are ``record_function`` names: the solver's (``sqp.*``, ``qp.prepare``,
``collision.*``) and the benchmark's own (``bench.*``).
"""

from __future__ import annotations

import bisect
import functools

import torch


class Trace:
    """The device spans (kernels and copies; the ranges' own device
    annotations left out), the host ranges, and for each device span the
    host start of the op that launched it (its linked correlation).

    The kernels of a CUDA graph replay are traced one by one, but their
    linked correlation names no host op; their own correlation id is their
    ``cudaGraphLaunch`` call's, whose host start stands for their launch.
    A hand kernel launched through ctypes has no linked op either: its own
    correlation id is its ``cudaLaunchKernel`` call's."""

    def __init__(self, prof, range_prefixes=("sqp.", "qp.", "collision.",
                                             "bench.")):
        cuda = torch.autograd.DeviceType.CUDA
        self.ranges = {}                # name -> [(start, end)]
        self.spans = []                 # (name, start, end, linked id)
        starts = {}                     # correlation id -> host start
        own = []                        # each span's own correlation id
        graph_at = {}                   # cudaGraphLaunch id -> host start
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            ranged = name.startswith(range_prefixes)
            if e.device_type() == cuda:
                if not ranged:
                    self.spans.append((name, e.start_ns(), e.end_ns(),
                                       e.linked_correlation_id()))
                    own.append(e.correlation_id())
                continue
            if ranged:
                self.ranges.setdefault(name, []).append(
                    (e.start_ns(), e.end_ns()))
            if name.startswith("cudaGraphLaunch"):
                graph_at[e.correlation_id()] = e.start_ns()
            if e.correlation_id():
                starts.setdefault(e.correlation_id(), e.start_ns())
        self.launch = [starts.get(c) if c in starts else starts.get(o)
                       for (_, _, _, c), o in zip(self.spans, own)]
        for k, c in enumerate(own):
            if c in graph_at:
                self.launch[k] = graph_at[c]

    def inside(self, name: str) -> list[int]:
        """Indices of the device spans launched inside range ``name``."""
        rs = sorted(self.ranges.get(name, []))
        begins = [a for a, _ in rs]
        out = []
        for k, t in enumerate(self.launch):
            i = bisect.bisect_right(begins, t) - 1 if t is not None else -1
            if i >= 0 and t <= rs[i][1]:
                out.append(k)
        return out

    def range_device_ns(self, name: str) -> int | None:
        """Device ns of the spans launched inside range ``name``; None when
        the run never entered it."""
        if not self.ranges.get(name):
            return None
        return sum(self.spans[k][2] - self.spans[k][1]
                   for k in self.inside(name))

    @functools.cached_property
    def busy(self) -> list[tuple[int, int]]:
        """The union of the device spans, as sorted (start, end)."""
        out = []
        for s, e in sorted((s, e) for _, s, e, _ in self.spans):
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_ns(self, lo: int, hi: int) -> int:
        """Device busy ns within [lo, hi]."""
        return sum(max(0, min(e, hi) - max(s, lo)) for s, e in self.busy)

    def kernel_ns(self, kernel: str) -> tuple[int, int]:
        """(launches, device ns) of the spans whose name holds ``kernel``."""
        spans = [e - s for name, s, e, _ in self.spans if kernel in name]
        return len(spans), sum(spans)

    def top_ops(self, k: int = 10) -> list[list]:
        """The ``k`` device span names with the most time, in seconds."""
        tot = {}
        for name, s, e, _ in self.spans:
            tot[name] = tot.get(name, 0) + e - s
        rows = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[name, t / 1e9] for name, t in rows]

    def idle_gaps(self, lo: int, hi: int, k: int = 10) -> list[list]:
        """Idle device time within [lo, hi], summed by the innermost host
        range open at each gap's start ("host" where none is), in seconds:
        the ``k`` largest."""
        flat = sorted(((a, b, name) for name, rs in self.ranges.items()
                       for a, b in rs), key=lambda r: (r[0], -r[1]))
        tot, stack, j, prev = {}, [], 0, lo
        for s, e in self.busy + [(hi, hi)]:
            s, e = max(s, lo), min(e, hi)
            if s > prev:
                # ranges nest on the host thread: the open one begun last
                while j < len(flat) and flat[j][0] <= prev:
                    while stack and stack[-1][1] < flat[j][0]:
                        stack.pop()
                    stack.append(flat[j])
                    j += 1
                while stack and stack[-1][1] < prev:
                    stack.pop()
                who = stack[-1][2] if stack else "host"
                tot[who] = tot.get(who, 0) + s - prev
            prev = max(prev, e)
        rows = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[name, t / 1e9] for name, t in rows]
