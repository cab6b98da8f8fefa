"""On a card: the tiny cells through the whole harness, graphs captured,
the trace read. Skips inside the fixture without a CUDA card.

Run on the card: python3 -m pytest gpubench/tests -q -m cuda
"""
import pytest
import torch

from gpubench.harness import run_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tiny.fused", "tiny.twopass"])
def test_tiny_cell_on_the_card(card, tiny_root, workload):
    line = run_cell(tiny_root, workload, 2**31 + 41, 3.0, False)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["memory_peak_bytes"] > 0
    traced = run_cell(tiny_root, workload, 2**31 + 42, 3.0, True)
    assert traced["correct"], traced["checks"]
    m = traced["metrics"]
    assert 0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
    assert 0 < m["k2.roofline_share"]["value"] <= 105
    assert 0 <= m["device.idle_share"]["value"] < 100
    assert ("graphs.pool_mb" in m) == (workload == "tiny.fused")
