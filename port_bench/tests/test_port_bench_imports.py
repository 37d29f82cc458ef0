"""Nothing the benchmark runs imports JAX or the JAX package, compared by
top-level module name; the reference imports the port neither."""

import ast
import os
import subprocess
import sys

import pytest

from port_bench import spec

JAX = {"jax", "jaxlib", "flax", "trajopt_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            out.add(node.module.split(".")[0])
    return out


HARNESS = sorted(p for p in spec.HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: p.name)
def test_no_jax_in_the_harness_sources(path):
    assert not _imports(path) & JAX


@pytest.mark.parametrize(
    "path", sorted((spec.HERE / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert not _imports(path) & (JAX | {"trajopt_tpu_torch", "torch"})


def test_loaded_modules_after_a_run():
    code = (
        "import sys, time, torch\n"
        "from port_bench import run\n"
        "out = run.run_cell('pr2ish_cast.uniform_b512', 1, 0.1, False, "
        "torch.device('cpu'), time.perf_counter(), "
        "traffic_over={'batch': 2, 'check_lanes': 2})\n"
        "import port_bench.reference.judge\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'trajopt_tpu'}))\n"
        "print(out is not None)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(spec.ROOT)))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split("\n")[-3:-1] == ["[]", "True"]


def test_reference_alone_loads_no_program():
    code = ("import sys\n"
            "import port_bench.reference.judge\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'trajopt_tpu', 'trajopt_tpu_torch', "
            "'torch'}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"
