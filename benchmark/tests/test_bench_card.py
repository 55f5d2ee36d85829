"""On the card only (marked ``cuda``; each test looks for a card itself
and skips without one): the control comes out as not correct at a size a
test run holds, and a short run of each cell comes out as correct."""
from __future__ import annotations

import pytest

CELLS = ("song.heavy_fresh", "note.heavy_fresh")


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    need_card()
    from benchmark import control

    r = control.control(workload, 2**31 + 77, compared=3)
    assert r["correct"] is False, r


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_is_correct(workload):
    need_card()
    from benchmark import harness

    r = harness.run_cell(workload, 2**31 + 78, 2.0, False)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu"
