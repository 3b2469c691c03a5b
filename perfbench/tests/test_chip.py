"""On a card (``chip`` marker; each test skips inside without one): a short
run of every cell through the command BENCHMARK.json names is correct, and
the check's control, the window's outputs rounded to bfloat16, is not."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return [w["name"] for w in json.load(fh)["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", _cells())
def test_short_run_is_correct_and_its_control_is_not(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell,
         "--seed", str(2 ** 31 + 17), "--seconds", "3", "--trace", "0",
         "--control", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    control = json.loads(out.stderr.split("control (outputs in bfloat16): ")
                         [1].splitlines()[0])
    assert any(c["value"] > c["limit"] for c in control.values())
