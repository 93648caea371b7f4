"""The harness on the card at small sizes: the served path through the
CUDA kernels agrees with the reference, the profiler slice sees the
card's work, and the control fails the limits. Run on the chip with
``python3 -m pytest gbench/tests -m card``; skipped without a card."""

import time

import pytest

from gbench import control, harness, registry

CELLS = ("g500-s25.bfs-k16", "g500-s22.pagerank-engine")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_small_traced_run_on_the_card(card, cell):
    bench = registry.benchmark()
    c = registry.cell(bench, cell)
    cfg = dict(registry.config(bench, c["config"]), scale=16)
    mix = dict(registry.traffic(c["traffic"]), profile_after_s=0.5,
               profile_seconds=1.0)
    result, _, notes = harness.run(cell, cfg, mix,
                                   registry.cell_metrics(bench, cell, True),
                                   2**31 + 17, 3.0, True, str(card),
                                   time.time())
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"], \
        notes
    assert result["breakdown"]["device_ops"]
    for m in ("device.idle_share.bfs", "device.idle_share.pagerank"):
        if m in result["metrics"]:
            assert 0 <= result["metrics"][m]["value"] < 1


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_the_card(card, cell):
    bench = registry.benchmark()
    c = registry.cell(bench, cell)
    cfg = dict(registry.config(bench, c["config"]), scale=16)
    mix = registry.traffic(c["traffic"])
    numbers = control.control_numbers(cfg, mix, 2**31 + 19, str(card))
    assert any(v > mix["limits"][k] for k, v in numbers.items()), numbers
