"""Building the hand-written CUDA kernels of ``csrc/``.

Each kernel is one ``.cu`` file with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` into a shared library at first use (one build per
source and flag hash, into ``trajopt_tpu_torch/_build/``) and loaded with
``ctypes`` by its wrapper module (``qp/fused_block.py``,
``qp/fused_dense.py``, ``collision/fused_convex.py``,
``collision/fused_primitive.py``: the fourth kernel, the primitive
narrowphase of ``csrc/primitive_narrowphase.cu``, whose per-query
functions live in ``csrc/primitive_narrowphase.cuh``).  The host C++ QP
(``csrc/qp_admm.cpp``, ``qp/native.py``) and the host build of the
primitive narrowphase's functions for the CPU tests
(``csrc/primitive_host.cpp``) are built the same way with ``g++``.  A
build is keyed by its source and the local headers it includes.  Nothing
here runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
SMEM_LIMIT = 232_448       # bytes of shared memory a Hopper block may use


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _with_headers(source: Path) -> bytes:
    """The source's bytes followed by those of the local headers it
    includes (``#include "name"``, recursively), so that a header's edit
    changes the build's hash."""
    out, seen, todo = [], set(), [source]
    while todo:
        path = todo.pop(0)
        if path in seen or not path.exists():
            continue
        seen.add(path)
        data = path.read_bytes()
        out.append(data)
        for line in data.decode(errors="replace").splitlines():
            line = line.strip()
            if line.startswith("#include") and '"' in line:
                todo.append(path.parent / line.split('"')[1])
    return b"".join(out)


def build_library(source: Path, verbose: bool = False,
                  compiler: str | None = None,
                  flags: list[str] | None = None) -> Path:
    """Compile ``source`` (once per source, compiler and flag hash) and
    return the library path: with ``nvcc`` and :data:`NVCC_FLAGS` unless
    ``compiler`` and ``flags`` name others (the host C++ QP takes ``g++``).
    ``verbose`` rebuilds with ``-Xptxas -v`` and prints its report, one
    line an entry function (:func:`ptxas_summary`: registers, shared
    memory, spills)."""
    flags = NVCC_FLAGS if flags is None else flags
    name = "nvcc" if compiler is None else compiler
    src = _with_headers(source)
    tag = hashlib.sha256(src + " ".join([name, *flags]).encode()
                         ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler or _nvcc(), *flags,
           *(["-Xptxas", "-v"] if verbose else []), "-o", str(tmp),
           str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{name} failed on {source.name} "
                           f"({res.returncode}):\n{res.stderr}")
    if verbose:
        print("\n".join(ptxas_summary(res.stderr)))
    os.replace(tmp, out)
    return out


def _demangle(names: list[str]) -> list[str]:
    """C++ names of mangled symbols (as given where ``c++filt`` is
    missing)."""
    tool = shutil.which("c++filt")
    if not tool or not names:
        return names
    res = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True)
    out = res.stdout.splitlines()
    return out if res.returncode == 0 and len(out) == len(names) else names


def ptxas_summary(report: str) -> list[str]:
    """One line an entry function of an ``-Xptxas -v`` report: its name,
    registers, shared memory, stack frame and spill bytes."""
    entries, cur = [], None
    for line in report.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            cur = {"name": line.split("'")[1]}
            entries.append(cur)
        elif cur is None:
            continue
        elif "bytes stack frame" in line:
            cur["frame"] = line
        elif line.startswith("ptxas info") and "Used" in line:
            cur["used"] = line.split(":", 1)[1].strip()
    names = _demangle([e["name"] for e in entries])
    return [f"{n}: {e.get('used', '?')}; {e.get('frame', '?')}"
            for n, e in zip(names, entries)]
