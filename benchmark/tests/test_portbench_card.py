"""One short run of each cell on the card, as the benchmark's command makes
it; skips without a CUDA device.

    python -m pytest --noconftest -m cuda benchmark/tests/test_portbench_card.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
from portbench_testkit import BENCH_DIR, ROOT, real_spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload",
                         [w["name"] for w in real_spec()["workloads"]])
@pytest.mark.parametrize("trace", (0, 1))
def test_a_short_run_on_the_card_is_correct(card, workload, trace):
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload",
         workload, "--seed", str(2 ** 31 + 101), "--seconds", "2",
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
