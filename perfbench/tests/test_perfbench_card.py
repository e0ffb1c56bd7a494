"""Each cell through ``perfbench/run.py`` on the card, briefly: the result
line is whole and correct.  Skips without a card."""

import json
import subprocess
import sys

import pytest
from conftest import CELLS, ROOT


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", "2147483999", "--seconds", "3", "--trace", "1"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
