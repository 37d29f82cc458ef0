"""The port's spans and counters (``trajopt_tpu_torch/utils/profiling.py``)
on the CPU: a span records only under a profiler, the counter registry's
snapshot and reset, the replay bookkeeping of a capture (driven through
``aot_cache._Graphed`` with a fake capture, as a CUDA graph cannot be
made here), and a small flagship solve whose host syncs, spans and ADMM
lane iterations the counters must match.

The captured path's node maps are held against a profiled replay on the
card in ``tests/test_torch_cuda.py``.
"""

import threading
import time

import pytest
import torch

from trajopt_tpu_torch.models.benchmarks import (flagship_params,
                                                 pr2ish_table_batch,
                                                 pr2ish_table_problem,
                                                 swept_verify)
from trajopt_tpu_torch.qp import fused_block
from trajopt_tpu_torch.qp.admm import ADMMConfig, QPData, prepare_qp, \
    solve_qp_prepared
from trajopt_tpu_torch.utils import aot_cache, profiling

CPU = [torch.profiler.ProfilerActivity.CPU]


def _ranges(prof) -> list[str]:
    """The names of the host ranges a profile recorded, in order."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() != cuda]


@pytest.fixture(autouse=True)
def clean_registry():
    profiling.reset()
    yield
    profiling.reset()


def test_span_records_only_under_a_profiler():
    assert profiling.span("sqp.a") is profiling.span("qp.b")   # a no-op
    with profiling.span("sqp.a"):
        pass
    with torch.profiler.profile(activities=CPU) as prof:
        with profiling.span("sqp.outer"):
            with profiling.span("qp.inner"):
                torch.ones(3).sum()
    names = _ranges(prof)
    assert "sqp.outer" in names and "qp.inner" in names
    assert profiling.span("sqp.a") is profiling.span("qp.b")


def test_registry_snapshot_and_reset():
    profiling.count("a")
    profiling.count("a", 2)
    profiling.count("b", 0.5)
    snap = profiling.counters()
    profiling.count("a")
    assert snap == {"a": 3, "b": 0.5}
    assert profiling.counters() == {"a": 4, "b": 0.5}
    profiling.reset()
    assert profiling.counters() == {}


def test_host_read_counts_and_names_its_span():
    with torch.profiler.profile(activities=CPU) as prof:
        n = profiling.host_read("qp", "test", int, torch.ones(4).sum())
        profiling.host_read("qp", "test", bool, torch.ones(2).any())
    assert n == 4
    assert profiling.counters() == {"host.syncs": 2,
                                    "host.syncs.qp.test": 2}
    assert _ranges(prof).count("qp.sync.test") == 2


def test_recording_maps_nodes_to_spans():
    """A fake graph's node count grows as the captured function launches;
    each node gets the stack of spans open when it was made."""
    made = [3]                        # nodes made before the pass began

    def launch(n):
        made[0] += n

    with profiling.recording(lambda: made[0]) as rec:
        launch(2)
        with profiling.span("collision.primitive"):
            launch(1)
            with profiling.span("collision.fk"):
                launch(3)
            launch(1)
        with profiling.span("sqp.empty"):
            pass
        launch(2)
    prim, fk = ("collision.primitive",), ("collision.primitive",
                                          "collision.fk")
    assert rec.paths(made[0]) == [(), (), prim, fk, fk, fk, prim, (), ()]
    assert profiling.span("sqp.a") is profiling.span("qp.b")
    with pytest.raises(RuntimeError, match="already"):
        with profiling.recording(lambda: 0):
            with profiling.recording(lambda: 0):
                pass
    assert profiling.recording(lambda: None).__enter__().paths(5) is None


def test_replays_add_the_captured_pass(monkeypatch):
    """Through ``_Graphed`` with a fake capture: the warm-up pass counts as
    it runs, the captured pass counts nothing itself, each replay (the
    capture's own first one too) adds what the pass counted, an eager call
    counts as it runs, and ``STATS`` reads captures and replays from the
    registry since its reset, which leaves the registry as it is."""
    class FakeGraph:
        def replay(self):
            pass

    def fake_capture(self, leaves):
        self.static_in = [t.clone() for t in leaves]
        args = aot_cache.unflatten(self.spec, self.static_in)
        self.fn(*args)                                    # the warm-up
        with profiling.recording(lambda: None) as rec:
            out = self.fn(*args)
        self.static_out, self.out_spec = aot_cache.flatten(out)
        self.graph, self.delta = FakeGraph(), rec.delta
        profiling.count("capture.captures")

    monkeypatch.setattr(aot_cache._Graphed, "_capture", fake_capture)

    def fn(x):
        profiling.count("k.launches")
        profiling.count("k.queries", 5)
        return x * 2

    x = torch.ones(3)
    leaves, spec = aot_cache.flatten((x,))
    g = aot_cache._Graphed(fn, leaves, spec, "sqp.test|shapes", None, False)
    assert g.replay_span.startswith("sqp.test.replay.")
    aot_cache.STATS.reset()
    g(x)
    assert g.delta == {"k.launches": 1, "k.queries": 5}
    assert profiling.counters() == {"k.launches": 2, "k.queries": 10,
                                    "capture.captures": 1,
                                    "capture.replays": 1}
    for _ in range(3):
        g(x + 1)
    with aot_cache.eager():
        g(x)
    assert profiling.counters()["k.launches"] == 2 + 3 + 1
    assert profiling.counters()["k.queries"] == 5 * (2 + 3 + 1)
    assert (aot_cache.STATS.captures, aot_cache.STATS.replays) == (1, 4)
    before = profiling.counters()
    aot_cache.STATS.reset()                     # clears nothing
    assert profiling.counters() == before
    assert aot_cache.STATS.replays == aot_cache.STATS.captures == 0
    g(x)
    assert aot_cache.STATS.since_reset() == {
        "k.launches": 1, "k.queries": 5, "capture.captures": 0,
        "capture.replays": 1}
    profiling.reset()                           # a later registry reset
    g(x)
    assert aot_cache.STATS.since_reset() == profiling.counters() == {
        "k.launches": 1, "k.queries": 5, "capture.replays": 1}


def test_threads_record_their_own_captures():
    """Two threads capture at once, as the sharded solve's threads (one a
    device) do: each recording holds only its own thread's spans and
    counts, and a third thread's counts meanwhile reach the registry."""
    opened = threading.Barrier(3, timeout=20)
    closed = threading.Barrier(3, timeout=20)
    recs = {}

    def capture(tag, width):
        made = [0]
        with profiling.recording(lambda: made[0]) as rec:
            opened.wait()
            for _ in range(200):
                with profiling.span(f"collision.{tag}"):
                    profiling.count(f"{tag}.launches")
                    made[0] += width
                made[0] += 1
                time.sleep(0)
            closed.wait()
        recs[tag] = rec

    threads = [threading.Thread(target=capture, args=a)
               for a in (("fk", 1), ("convex", 2))]
    for t in threads:
        t.start()
    opened.wait()
    for _ in range(200):
        profiling.count("host.syncs")
        assert profiling.span("sqp.a") is profiling.span("qp.b")
        time.sleep(0)
    closed.wait()
    for t in threads:
        t.join()
    assert recs["fk"].delta == {"fk.launches": 200}
    assert recs["convex"].delta == {"convex.launches": 200}
    assert recs["fk"].paths(400) == [("collision.fk",), ()] * 200
    assert recs["convex"].paths(600) == \
        [("collision.convex",), ("collision.convex",), ()] * 200
    assert profiling.counters() == {"host.syncs": 200}


def test_dense_qp_counts_lane_iterations():
    """The dense chunk loop counts the lanes entering the solve and, each
    chunk, its live lanes times ``check_every``: their sum is the lanes'
    reported iterations."""
    g = torch.Generator().manual_seed(3)
    B, n, m = 5, 6, 4
    L = torch.randn(B, n, n, generator=g, dtype=torch.float64)
    qp = QPData(P=L @ L.transpose(1, 2) + torch.eye(n, dtype=torch.float64),
                q=torch.randn(B, n, generator=g, dtype=torch.float64),
                A=torch.randn(B, m, n, generator=g, dtype=torch.float64),
                l=-torch.rand(B, m, generator=g, dtype=torch.float64),
                u=torch.rand(B, m, generator=g, dtype=torch.float64),
                c=torch.full((B, m), float("inf"), dtype=torch.float64))
    cfg = ADMMConfig(check_every=5, max_iter=200)
    res = solve_qp_prepared(prepare_qp(qp, torch.zeros(B, n,
                                                       dtype=torch.float64),
                                       cfg=cfg), cfg)
    got = profiling.counters()
    assert got["qp.admm.lane_solves"] == B
    assert got["qp.admm.lane_iters"] == int(res.iters.sum())
    assert int(res.iters.min()) < int(res.iters.max())   # lanes stop apart
    assert got["host.syncs.qp.dense_chunk"] == int(res.iters.max()) // 5 + 1


def test_small_solve_counts_match_its_profile(monkeypatch):
    """A 6-step flagship solve on 3 lanes (CPU, float64, the block path):
    ``host.syncs`` equals the ``*.sync.*`` ranges of its profile, site by
    site; ``qp.admm.lane_iters`` equals the live lanes times iterations of
    the chunk calls; every SQP pass and FK prologue has its span."""
    prob, scene = pr2ish_table_problem(n_steps=6, lvs_substeps=2,
                                       device="cpu")
    solve = prob.make_solve(flagship_params(), structured=True)
    inits, goals = pr2ish_table_batch(0, 3, 6, dtype=torch.float64,
                                      device="cpu", hard_frac=0.4)
    chunk, launched = fused_block.chunk, []

    def probe(*args, n_iters, active=None, **kw):
        launched.append(int(active.sum()) * n_iters)
        return chunk(*args, n_iters=n_iters, active=active, **kw)

    monkeypatch.setattr(fused_block, "chunk", probe)
    profiling.reset()
    with torch.profiler.profile(activities=CPU) as prof:
        res = solve(inits, {"goal": goals})
        swept_verify(scene, res.x.reshape(3, 6, 8))
    got = profiling.counters()
    names = _ranges(prof)
    syncs = [n for n in names if ".sync." in n]
    assert got["host.syncs"] == len(syncs) > 0
    for site in ("sqp.live", "qp.block_chunk", "qp.ns", "collision.verify"):
        layer, name = site.split(".")
        assert got[f"host.syncs.{site}"] == \
            syncs.count(f"{layer}.sync.{name}") > 0, site
    assert got["qp.admm.lane_iters"] == sum(launched) > 0
    assert got["qp.admm.lane_solves"] == int(res.n_qp_solves.sum())
    assert names.count("sqp.pass") == int(res.n_iter.max())
    assert names.count("collision.fk") > 0
    assert got.get("qp.block_chunk.launches", 0) == 0      # plain on the CPU
