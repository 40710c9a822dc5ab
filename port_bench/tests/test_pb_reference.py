"""The check at a size a test run holds, on the CPU (the program's plain
step, ``engine.kernel`` off there) and, marked ``cuda``, on the card.

* The reference agrees with the port: a run comes out ``correct`` under
  the cell's own limits.
* Each fault a one-chip training cell can have, planted under the timed
  path, makes ``correct`` come out false, and so does the physics
  control (the step's state rounded to bf16).
* On the card, each control (the program in TF32; the physics in bf16)
  fails one of the cell's numbers.
"""

import pytest
import torch

from port_bench import check, control, faults, run, spec

WORKLOADS = [w["name"] for w in spec.benchmark()["workloads"]]
TINY = {"set": {"engine.num_envs": 8, "agent.steps_per_iter": 4, "agent.batch_size": 2},
        "check": {"iterations": 2, "control_steps": 2}}


def _tiny(name, **traffic):
    cell = spec.workload(name)
    cell["traffic"] = dict(TINY, **traffic)
    return cell


def _correct(cell, seed, device="cpu", plant=None):
    ctx = run.measure(cell, seed, 0.0, False, device, plant=plant)
    return run.result(ctx, ["env_steps_per_s", "setup_s"])


@pytest.mark.parametrize("name", WORKLOADS)
def test_reference_agrees_with_the_port(name):
    out = _correct(_tiny(name), 2**31 + 11)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", WORKLOADS)
def test_a_fault_fails_the_check(name, fault):
    out = _correct(_tiny(name), 2**31 + 12, plant=faults.FAULTS[fault])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", WORKLOADS)
def test_physics_control_fails_the_check(name):
    out = _correct(_tiny(name), 2**31 + 14, plant=control.physics_bf16)
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("what", sorted(control.CONTROLS))
@pytest.mark.parametrize("name", WORKLOADS)
def test_control_fails_on_the_card(name, what):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = _tiny(name, set={"engine.num_envs": 1024, "agent.steps_per_iter": 8,
                            "agent.batch_size": 2})
    numbers = control.reading(cell, 2**31 + 13, what, "cuda")
    ok, checks = check.judge(numbers, cell["limits"])
    assert not ok, checks
