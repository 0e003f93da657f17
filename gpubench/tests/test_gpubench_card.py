"""The command itself on a card: every cell, a short window, traced and
not.  Run on a machine with a CUDA device:
``python -m pytest -m gpu gpubench/tests/test_gpubench_card.py``."""

import json
import subprocess
import sys

import pytest

from gpubench.harness import load_bench
from gpubench.tests.tiny import REPO


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in load_bench(REPO)["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_command_on_the_card(card, workload, trace):
    out = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload", workload, "--seed", "2147483999",
         "--seconds", "2", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace:
        assert r["device"]["busy_s"] > 0
        assert all(m["value"] <= 105 for k, m in r["metrics"].items() if k.endswith("_roofline"))
