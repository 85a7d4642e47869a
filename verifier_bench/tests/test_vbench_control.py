"""The control and the planted faults come out not correct; the sound
program comes out correct, on the same small traffic."""

import pytest

from verifier_bench import control

SMALL = {"batch": 10, "tampered_lanes": 7, "batches_cycled": 2}


@pytest.mark.parametrize("fault,correct", [("control", False),
                                           ("flip", False), ("half", False),
                                           ("stale", False)])
def test_fault_makes_the_run_incorrect(fault, correct):
    rows = control.readings("fib_gl.n32.bulk", [21], 0.01, fault, "cpu",
                            SMALL)
    (_, nums, got), = rows
    assert got is correct
    assert nums["failed_lanes"] > 0
