"""``run.py`` without a CUDA card: a clear message, a non-zero exit and no
result line."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_run_fails_without_a_card(no_card):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "train.chat_lm.b8x3072", "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(ROOT))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr
