"""The output check's controls, on the card at the cells' own sizes: the
reference put in the program's place in TF32 (float32 with TF32 off is
what the configuration states), and for the data-parallel cell the
faults planted in that reference (half of each rank's rows left out, the
exchange between ranks left out). Each must come out not correct.

    python -m pytest perfbench/tests -q -m chip

One card; a few minutes. Each run prints the numbers it compared. The
``chip`` marker is this file's own (no pytest configuration registers
it; pytest warns of it and selects by it all the same).
"""

import json
import subprocess
import sys

import pytest

from perfbench import run as bench

SEEDS = (2147485001, 2147485002, 2147485003)


@pytest.fixture
def card():
    """Skip unless a CUDA card is here (decided in the test, not at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _control(workload, seed, variant):
    res = subprocess.run(
        [sys.executable, str(bench.HERE / "run.py"), "--workload", workload,
         "--seed", str(seed), "--seconds", "3", "--control", variant],
        cwd=bench.ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    steps = [l for l in res.stderr.splitlines() if "each step" in l]
    print(workload, seed, variant, json.dumps(out["checks"]), *steps[-1:])
    return out


@pytest.mark.chip
@pytest.mark.parametrize("seed", SEEDS)
def test_serving_control_fails(card, seed):
    out = _control("pointpillars_kitti_f32.serve", seed, "tf32")
    assert out["correct"] is False


@pytest.mark.chip
@pytest.mark.parametrize("variant", ["tf32", "half_batch", "no_exchange"])
@pytest.mark.parametrize("seed", SEEDS)
def test_training_controls_fail(card, seed, variant):
    out = _control("pointpillars_kitti_f32.train_dp4", seed, variant)
    assert out["correct"] is False
