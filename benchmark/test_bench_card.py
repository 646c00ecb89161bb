"""The harness on the card at a tiny size: a run and a traced run of each
tiny cell come out correct, name the card, and read every per-layer metric
that the cell's step reaches, no roofline share above 100%.  Skips without
a CUDA device (``python -m pytest benchmark -m cuda`` on the card)."""

import pytest

from benchmark import run

SEED = 2**31 + 29


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.fri", "tiny.fciqmc"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_on_the_card(card, tiny_root, cell, trace):
    r = run.run(cell, SEED, 1.0, trace, root=tiny_root, device="cuda", log=lambda *a: None)
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["device"]["kind"] == card and r["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        for name in ("idle_pct", "syncs_per_step", "merge_roofline", "build_s"):
            assert name in r["metrics"]
        for name, m in r["metrics"].items():
            if name.endswith("roofline"):
                assert 0 < m["value"] <= 100
