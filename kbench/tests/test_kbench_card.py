"""A cell at a small size on the card: the run on CUDA is correct and its
traced run reads the kernels. Skips without a card."""

import pytest

from kbench import harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_small_index_cell_on_the_card(card, tmp_path):
    cfg = dict(harness.data_file("configs", "plants-k15"), genome_bp=40_000_000,
               n_bases=2_000_000)
    wl = dict(harness.data_file("workloads", "plants-k15.index"), warm_bp=4_000_000)
    result = harness.execute("plants-k15.index", 5, 1.0, True, card, config=cfg, workload=wl,
                             say=lambda s: None, directory=str(tmp_path / "run"))
    assert result["correct"] and result["device"]["busy_s"] > 0
    for name in ("encode_roofline", "sweep_roofline", "device_idle_share"):
        assert 0 < result["metrics"][name]["value"] <= 100
