"""The harness on the card at a tiny size (marker ``cuda``; skips without
a card): every cell correct, its metrics and its traced run's device
numbers present. The full-size runs are the benchmark's own.

    python -m pytest benchmark/tests/test_bench_card.py -m cuda
"""

import pytest

from benchmark import harness
from benchmark.tests.test_bench_harness import CELLS, shrink


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, tmp_path, monkeypatch, cell):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    shrink(str(tmp_path))
    r = harness.run_cell(str(tmp_path), cell, 2**31 + 99, 2.0, False, card,
                         0.0, lambda m: None)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"filter_mbp_s", "peak_device_gb",
                                 "setup_s"}
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    t = harness.run_cell(str(tmp_path), cell, 2**31 + 98, 4.0, True, card,
                         0.0, lambda m: None)
    assert t["correct"] is True
    assert 0 < t["device"]["busy_s"] <= t["device"]["window_s"]
    for name in ("device_idle_share", "k1_roofline", "k2_roofline"):
        assert name in t["metrics"]
    assert t["breakdown"]["device_ops"]
