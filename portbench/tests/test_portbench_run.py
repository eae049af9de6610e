"""The command itself: without a CUDA device it fails and prints no result."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def run(*args):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = run("--workload", "train.gibbs12p5_fast.b16", "--seed", str(2 ** 31 + 3), "--seconds", "1",
            "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_unknown_cell():
    p = run("--workload", "no.such.cell", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""
