"""Port parity: the ``arm_table.json`` document under ``convex_solver:
native`` through both packages' JSON front ends (the host reference driver
with the native C++ QP, ``sqp/reference_solver.py``), float64 on the CPU:
equal status and counts, x within 1e-6.
"""

import copy

import numpy as np
import torch

from tests.test_torch_json_io import _arm_table_doc, _construct
from trajopt_tpu_torch.sqp import reference_solver as tref

torch.set_num_threads(2)


def _ref_fields(r):
    return (int(r.status), int(r.n_iter), int(r.n_qp_solves))


def test_arm_table_document_native_backend_matches_jax():
    doc = _arm_table_doc()
    doc["basic_info"]["convex_solver"] = "native"
    jp = _construct("jax", "arm_table", copy.deepcopy(doc))
    tp = _construct("torch", "arm_table", doc)
    assert jp.backend == tp.backend == "native"
    ref, got = jp.solve(), tp.solve()
    assert isinstance(got, tref.RefResult)
    assert ref.status == 1
    assert _ref_fields(got) == _ref_fields(ref)
    np.testing.assert_allclose(got.x, ref.x, rtol=0, atol=1e-6)
