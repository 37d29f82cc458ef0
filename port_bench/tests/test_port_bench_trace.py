"""The trace reductions on a hand-made timeline: busy union, range
attribution, idle gaps by open host range, and the metric readers."""

from port_bench import spec
from port_bench.run import Run
from port_bench.trace import Trace


def _trace():
    t = object.__new__(Trace)
    # host ranges (ns): a window holding a solve that holds convexify
    t.ranges = {"bench.window": [(0, 100)], "bench.solve": [(0, 80)],
                "sqp.convexify": [(10, 40)], "bench.verify": [(80, 100)]}
    # device spans: (name, start, end, linked id); launches at host times
    t.spans = [("k_a", 12, 20, 0), ("k_b", 18, 30, 0),
               ("primitive_narrowphase_kernel<1>", 50, 60, 0),
               ("admm_block_chunk_kernel", 85, 95, 0)]
    t.launch = [11, 15, 45, 82]
    return t


def test_busy_union_and_idle_gaps():
    t = _trace()
    assert t.busy == [(12, 30), (50, 60), (85, 95)]
    assert t.busy_ns(0, 100) == 18 + 10 + 10
    gaps = {k: round(v * 1e9) for k, v in t.idle_gaps(0, 100)}
    # a gap goes to the innermost range open at its start
    assert gaps == {"bench.solve": 12 + 25, "sqp.convexify": 20,
                    "bench.verify": 5}


def test_range_attribution_and_kernels():
    t = _trace()
    assert t.inside("sqp.convexify") == [0, 1]
    assert t.range_device_ns("sqp.convexify") == 8 + 12
    assert t.range_device_ns("qp.prepare") is None
    assert t.kernel_ns("primitive_narrowphase_kernel") == (1, 10)
    assert t.top_ops(2)[0] == ["k_b", 12e-9]


def test_readers_on_the_timeline():
    run = Run()
    run.trace, run.window_ns = _trace(), (0, 100)
    run.walls = [0.05, 0.05]
    run.chunk_bound_s = {"block": 5e-9}
    read = {name: spec.reader(name)(run) for name in (
        "device.idle_pct", "convexify.device_ms_per_batch",
        "primitive.kernel_ms_per_batch", "block_chunk_roofline",
        "dense_chunk_roofline", "qp_prepare.device_ms_per_batch")}
    assert abs(read["device.idle_pct"] - 62.0) < 1e-9
    assert read["convexify.device_ms_per_batch"] == 20 / 1e6 / 2
    assert read["primitive.kernel_ms_per_batch"] == 10 / 1e6 / 2
    assert abs(read["block_chunk_roofline"] - 50.0) < 1e-9
    assert read["dense_chunk_roofline"] is None
    assert read["qp_prepare.device_ms_per_batch"] is None
