"""On the card: each cell runs end to end for a few seconds and prints the
contract's last line. Skips without an NVIDIA card."""

import json
import subprocess
import sys

import pytest

from benchmark.lib import spec


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in spec.load_json(
    spec.ROOT / "BENCHMARK.json")["workloads"]])
def test_cell_prints_its_result(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the CUDA kernels")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", str(2 ** 31 + 3), "--seconds", "3", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["check"]
    assert list(result)[-1] == "check"
    assert result["device"]["platform"] == "gpu"


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "base-train-b64", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
