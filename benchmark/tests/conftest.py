"""Fixtures of the benchmark's own tests: run with
``python -m pytest benchmark/tests -q`` from the checkout's root."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def shrink(cfg: dict, traffic: dict) -> None:
    """A cell cut to a size the CPU runs in seconds: a coarse building, a
    90-wide scan, an 8-pose loop, 512 particles."""
    cfg["map"]["subdiv"] = 2
    cfg["sensor"]["width"] = 90
    traffic["loop"]["poses"] = 8
    traffic["noise_slots"] = 4
    traffic["check"] = dict(traffic["check"])
    if "particles" in traffic:
        traffic["particles"] = 512
        traffic["warmup_cycles"] = 1
        traffic["check"].update(particles=16, sample_before=3)
    else:
        traffic["warmup_corrections"] = 2
        traffic["check"]["corrections"] = 6


@pytest.fixture(autouse=True, scope="session")
def one_thread():
    """One intra-op thread a test process, as in a run: parallel test
    workers that each take every core slow a window's corrections to a
    handful."""
    import torch

    torch.set_num_threads(1)


@pytest.fixture
def card():
    """Skip without a CUDA card (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
