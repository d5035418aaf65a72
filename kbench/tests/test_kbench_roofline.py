"""The work the roofline shares count, at small K, and the shares."""

import pytest

from kbench import roofline


def test_encode_bytes_are_packed_bases_and_one_code_a_valid_window():
    assert roofline.encode_bytes(bases=1000, valid_windows=990, kmer_len=5) == 250 + 990 * 4
    assert roofline.encode_bytes(bases=1000, valid_windows=980, kmer_len=17) == 250 + 980 * 8


def test_sweep_bytes_are_codes_and_each_distinct_cell_both_ways():
    assert roofline.sweep_bytes(valid_windows=990, distinct_cells=300, kmer_len=5) \
        == 990 * 4 + 600


def test_least_time_is_the_bytes_over_the_bandwidth_and_share_needs_a_time():
    assert roofline.least_seconds(3.35e12) == pytest.approx(1.0)
    assert roofline.share(1e-3, 2e-3) == pytest.approx(50.0)
    assert roofline.share(1e-3, None) is None and roofline.share(1e-3, 0.0) is None
