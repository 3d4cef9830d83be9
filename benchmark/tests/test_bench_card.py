"""On the card: a tiny run of each cell through the CUDA kernels, traced,
is correct and reads every per-layer metric from its trace."""

import time

import pytest

import tiny
from kbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("bulk-pe100", "sc-10xv2"))
def test_a_traced_run_on_the_card(name, card, tmp_path):
    cell = tiny.cell(name, sample_size=300000)
    out = harness.run_cell(cell, 2**31 + 99, 0.5, True, card, time.time(),
                           str(tmp_path))
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert set(out["metrics"]) == {m for m, _, _ in cell.metrics(True)}
    for m, v in out["metrics"].items():
        if "roofline" in m:
            assert 0 < v["value"] <= 100, (m, v)
    assert out["breakdown"]["device_ops"]
