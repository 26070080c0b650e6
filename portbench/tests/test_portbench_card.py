"""Every cell's driver against its plain reference on the card, at small
sizes (Maxwell N=32, 200,000 banded rows): the port's CUDA kernels, not
their plain versions.  Skips without a card; on the card:
`python -m pytest portbench/tests -m cuda -q`."""

from __future__ import annotations

import time

import pytest

from portbench.run import run_cell
from portbench.tests.cells import tiny_cell


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["maxwell160-block-expm", "maxwell160-fdtd",
                                  "banded10m-block-eigsh"])
def test_cell_on_the_card_is_correct(card, name):
    cell = tiny_cell(name, n_grid=32, rows=200_000)
    res = run_cell(cell, 2**33 + 29, 1.0, False, device=card, t0=time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
