"""The readers of the port's own spans and counters on a hand-made
timeline: replayed kernels handed to their sub-spans by a node map, idle
time at host syncs, host time of SQP passes, and the counter readers; and
each reader's None where the port (an older commit) has none of these."""

import pytest

from port_bench import spec, subspans
from port_bench.run import Run
from port_bench.trace import Trace
from trajopt_tpu_torch.utils import aot_cache, profiling

FK, PRIM = ("collision.fk",), ("collision.primitive",)
MAPS = {"sqp.convexify.replay.7": aot_cache.NodeMap(
            ("kernel", "memset", "kernel", "kernel"), (FK, (), PRIM, ())),
        "sqp.evaluate.replay.8": aot_cache.NodeMap(("kernel",), ((),))}
NEW = ("host.syncs_per_batch", "device.idle_at_sync_pct",
       "sqp.host_ms_per_pass", "convexify.fk_device_ms_per_batch",
       "primitive.queries_per_batch", "qp.admm_iters_per_qp")


def _trace():
    """Two SQP passes: the first replays a convexify graph (four nodes)
    and blocks in the chunk loop's sync; the second convexifies eagerly,
    its FK under ``collision.fk``; an evaluate replay whose map does not
    match what it traced; and an eager span whose launch time the trace
    put inside the convexify replay."""
    t = object.__new__(Trace)
    t.ranges = {"bench.window": [(0, 200)], "bench.solve": [(0, 180)],
                "sqp.sync.live": [(5, 9), (100, 104)],
                "sqp.pass": [(10, 100), (105, 170)],
                "sqp.convexify": [(12, 40), (110, 140)],
                "sqp.convexify.replay.7": [(14, 16)],
                "qp.sync.block_chunk": [(50, 60)],
                "collision.fk": [(120, 130)],
                "sqp.evaluate": [(150, 160)],
                "sqp.evaluate.replay.8": [(151, 152)]}
    t.spans = [("fk_kernel", 20, 25, 0), ("Memset (Device)", 25, 26, 0),
               ("primitive_narrowphase_kernel<1>", 26, 36, 0),
               ("mul_kernel", 36, 38, 0),
               ("admm_block_chunk_kernel", 45, 55, 0),
               ("fk_kernel", 121, 125, 0),
               ("eval_a", 153, 154, 0), ("eval_b", 154, 155, 0),
               ("foreign", 46, 47, 0)]
    t.launch = [15, 15, 15, 15, 44, 121, 151, 151, 15]
    return t


@pytest.fixture
def run(monkeypatch):
    monkeypatch.setattr(aot_cache, "node_maps", lambda: dict(MAPS))
    profiling.reset()
    r = Run()
    r.trace, r.window_ns, r.walls = _trace(), (0, 200), [0.1, 0.1]
    yield r
    profiling.reset()


def test_replays_are_handed_to_their_sub_spans(run):
    sub = subspans.of(run)
    assert subspans.of(run) is sub
    assert sub.path == {0: FK, 1: (), 2: PRIM, 3: ()}
    assert (sub.mapped, sub.unmapped, sub.foreign) == (4, 2, 1)
    assert sub.device_ns("collision.fk") == 5 + 4
    assert sub.device_ns("collision.fk", within="sqp.convexify") == 5 + 4
    assert sub.device_ns("collision.fk", within="sqp.evaluate") == 0
    # every primitive kernel falls in its sub-span, as its own reader sees
    n, ns = run.trace.kernel_ns("primitive_narrowphase_kernel")
    assert sub.device_ns("collision.primitive") == ns == 10
    # sub-spans of convexify hold no more than convexify's device time
    assert sub.device_ns("collision.fk", "sqp.convexify") + \
        sub.device_ns("collision.primitive", "sqp.convexify") <= \
        run.trace.range_device_ns("sqp.convexify")


def test_readers_of_spans_and_counters(run):
    profiling.count("host.syncs", 50)           # the warm-up, not read
    profiling.count("qp.admm.lane_solves", 9)
    aot_cache.STATS.reset()                     # the window's start
    profiling.count("host.syncs", 7)
    profiling.count("collision.primitive.queries", 3000)
    profiling.count("qp.admm.lane_iters", 900)
    profiling.count("qp.admm.lane_solves", 4)
    read = {name: spec.reader(name)(run) for name in NEW}
    assert read["host.syncs_per_batch"] == 3.5
    # idle 20-38 under sqp.convexify ... 55-121 begins in the chunk sync
    assert abs(read["device.idle_at_sync_pct"] - 33.0) < 1e-9
    assert abs(read["sqp.host_ms_per_pass"] - (80 + 65) / 2 / 1e6) < 1e-15
    assert read["convexify.fk_device_ms_per_batch"] == 9 / 1e6 / 2
    assert read["primitive.queries_per_batch"] == 1500
    assert read["qp.admm_iters_per_qp"] == 225
    assert read["device.idle_at_sync_pct"] <= \
        spec.reader("device.idle_pct")(run)


def test_readers_without_the_ports_instrumentation(monkeypatch):
    """An older port: no registry, no node maps, no sync or pass spans."""
    monkeypatch.delattr(aot_cache, "node_maps")
    monkeypatch.delattr(aot_cache.CaptureStats, "since_reset")
    t = _trace()
    t.ranges = {k: v for k, v in t.ranges.items()
                if ".sync." not in k and k != "sqp.pass"}
    r = Run()
    r.trace, r.window_ns, r.walls = t, (0, 200), [0.1, 0.1]
    assert all(spec.reader(name)(r) is None for name in NEW)
    untraced = Run()
    untraced.walls = [0.1]
    assert all(spec.reader(name)(untraced) is None for name in NEW)


def test_the_new_metrics_are_the_cells():
    bench = spec.benchmark()
    names = [m["name"] for m in bench["per_layer"]]
    assert names[-len(NEW):] == list(NEW)
    for name in NEW:
        assert name in [m["name"] for m in spec.cell_metrics(
            "pr2ish_cast.uniform_b512", "per_layer")]
