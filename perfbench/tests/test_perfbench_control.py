"""The control, at a size a test run holds: the reference in float8 put
in the program's place comes out not correct under the cells' limits,
while the program on the same prompts comes out correct.  (At the
cells' own size it runs on the card: ``perfbench/control.py``.)"""

import pytest
from conftest import CELLS, small_cell

torch = pytest.importorskip("torch")

from perfbench import harness  # noqa: E402


@pytest.mark.parametrize("seed", [424242, 13])
@pytest.mark.parametrize("workload", CELLS)
def test_fp8_control_fails_the_limits(workload, seed, fixed_clock):
    cell = small_cell(workload)
    result, _, _, _, numbers = harness.run(
        cell, seed, 0.32, False, "cpu", 0.0, quant="fp8")
    assert result["correct"], result["checks"]
    control = numbers["control"]
    assert not harness.judge(control, cell.limits["numbers"]), control
