"""A run's last line, the refusal without a card, and the control and the
faults that the judge must call not correct (small cells on the CPU,
where the port runs float64)."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from port_bench import problem, run, spec
from port_bench.reference import judge
from port_bench.reference.robot import Robot

CPU = torch.device("cpu")
SMALL = {"batch": 4, "check_lanes": 4}
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checked"]


CELL = "pr2ish_cast.uniform_b512"


def _run(cell=CELL, fault=None, seed=11, **kw):
    return run.run_cell(cell, seed, 0.1, False, CPU, time.perf_counter(),
                        traffic_over=SMALL, fault=fault, **kw)


@pytest.fixture(scope="module")
def sound():
    return _run(control=True)


def test_last_line_keys(sound):
    sound = {k: v for k, v in sound.items() if k != "control"}
    assert list(sound) == KEYS          # the checked numbers come last
    assert sound["correct"] is True
    assert sound["attempted"] == 4 * (sound["attempted"] // 4) > 0
    assert set(sound["metrics"]) == {"verified_solves_per_s",
                                     "batch_p90_ms", "setup_s"}
    for m in sound["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(sound["device"]) == {"platform", "kind", "count",
                                    "memory_peak_bytes"}
    assert list(sound["checked"]) == list(judge.NUMBERS)
    json.dumps(sound)


def test_no_card_exits_non_zero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         CELL, "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_control_is_not_correct(sound):
    """The reference in the program's place, in TF32, fails the limits of
    every cell file on a run whose own numbers pass them."""
    out = sound
    assert out["correct"] is True
    for path in sorted((spec.HERE / "workloads").glob("*.json")):
        limits = spec.workload(path.stem)["limits"]
        assert not judge.passes(out["control"], limits)


def _altered(solve, verify):
    """The answer altered where it is produced: the returned trajectories
    moved by 1e-3 rad on every step but the first."""
    def broken(inits, params):
        res = solve(inits, params)
        x = res.x.reshape(len(inits), -1, inits.shape[-1]).clone()
        x[:, 1:] += 1e-3
        return res._replace(x=x.reshape(len(inits), -1))
    return broken, verify


def _half_batch(solve, verify):
    """Half of the batch left out: the first half solved, its results
    standing in for the second half's."""
    def broken(inits, params):
        h = len(inits) // 2
        res = solve(inits[:h], {k: v[:h] for k, v in params.items()})
        return type(res)(*(torch.cat([t, t]) for t in res))
    return broken, verify


def _unchanged(solve, verify):
    """A step that returns its state unchanged: the inits come back as the
    solution, with the solve's statuses and claims."""
    def broken(inits, params):
        res = solve(inits, params)
        x0 = torch.as_tensor(inits, dtype=res.x.dtype)
        return res._replace(x=x0.reshape(len(inits), -1))
    return broken, verify


def _overstated(solve, verify):
    """The clearance overstated where it is produced: the swept check's
    values 1 mm high."""
    return solve, (lambda scene, traj: verify(scene, traj) + 1e-3)


def _beyond_limits(solve, verify):
    """A trajectory outside its joint limits, with the solve's claims: one
    joint of one step put 0.01 beyond its upper limit."""
    def broken(inits, params):
        res = solve(inits, params)
        x = res.x.reshape(len(inits), -1, inits.shape[-1]).clone()
        cfg = spec.config(spec.workload(CELL)["config"])
        robot = Robot(str(spec.ROOT / cfg["urdf"]))
        x[:, 10, 1] = float(robot.upper[1]) + 0.01
        return res._replace(x=x.reshape(len(inits), -1))
    return broken, verify


@pytest.mark.parametrize("fault", [_altered, _half_batch, _unchanged,
                                   _overstated, _beyond_limits],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault):
    out = _run(fault=fault)
    assert out["correct"] is False, out["checked"]
    if fault is _beyond_limits:
        assert out["checked"]["broken"]["value"] > 0


def test_stopping_inside_the_margin_is_not_correct(monkeypatch):
    """A solver that stops inside the collision margin (it solves the
    problem with the margin cut to 0.0, and claims convergence) breaks the
    configuration's collision rows."""
    build = problem.build

    def cut(cfg, device):
        cfg = json.loads(json.dumps(cfg))
        for t in cfg["terms"]:
            if t["type"] == "collision":
                t["margin"] = 0.0
        return build(cfg, device)

    monkeypatch.setattr(problem, "build", cut)
    out = _run()
    assert out["checked"]["broken"]["value"] > 0, out["checked"]
    assert out["correct"] is False
