"""The benchmark's command on a card: one short run of a one-chip cell
through the command line gives a correct result line. Skips without a
card (``card`` marker)."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with python -m pytest joinbench")
    return torch.cuda.get_device_name(0)


@pytest.mark.card
def test_one_short_run_on_the_card(card):
    p = subprocess.run([sys.executable, "joinbench/run.py", "--workload", "int64-100m.join",
                        "--seed", "3000000003", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["kind"] == card
    assert res["metrics"]["input_gb_per_s"]["value"] > 0
