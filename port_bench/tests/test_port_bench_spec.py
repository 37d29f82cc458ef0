"""Every cell, configuration, traffic mix and metric of BENCHMARK.json has
its file under port_bench/ and loads by its name."""

import json

import pytest

from port_bench import spec
from port_bench.reference import judge

BENCH = spec.benchmark()


def test_benchmark_json_holds_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_loads_by_name(entry):
    cfg = spec.config(entry["name"])
    assert cfg["name"] == entry["name"]
    assert entry["file"] == f"port_bench/configs/{entry['name']}.json"
    assert cfg["dtype"] == "float32" and cfg["tf32"] is False
    assert (spec.ROOT / cfg["urdf"]).is_file()
    assert cfg["reduced"] == entry["reduced"]


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_and_traffic_load_by_name(entry):
    cell = spec.workload(entry["name"])
    for key in ("config", "traffic", "chips", "why"):
        assert cell[key] == entry[key]
    assert entry["name"] == f"{entry['config']}.{entry['traffic']}"
    mix = spec.traffic(entry["traffic"])
    assert {"batch", "hard_frac", "goal_noise", "check_lanes", "why",
            "assumed"} <= set(mix)
    assert set(cell["limits"]) == set(judge.NUMBERS)
    e2e = {m["name"] for m in spec.cell_metrics(entry["name"], "end_to_end")}
    assert {"setup_s", "verified_solves_per_s", "batch_p90_ms"} <= e2e
    assert spec.cell_metrics(entry["name"], "per_layer")


@pytest.mark.parametrize(
    "metric", BENCH["end_to_end"] + BENCH["per_layer"],
    ids=lambda m: m["name"])
def test_metric_reader_loads_by_name(metric):
    read = spec.reader(metric["name"])
    assert callable(read)
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "moves" in metric:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_unknown_names_raise():
    with pytest.raises(FileNotFoundError):
        spec.workload("no_such_cell")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric")


def test_files_are_json():
    for kind in ("configs", "traffic", "workloads"):
        for path in (spec.HERE / kind).glob("*.json"):
            json.loads(path.read_text())
