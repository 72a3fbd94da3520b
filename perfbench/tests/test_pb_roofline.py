"""The frozen bound rule against numbers worked by hand."""

import pytest

from perfbench import roofline


def test_peaks():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.INT32_OPS_PER_S == pytest.approx(16.72704e12)


def test_k4_bytes_and_operations():
    # 2 reads of 100 and 50 symbols, 1 launch, 1,000 rounds, 300 table
    # rows, 200 text rows, 5,000 compared symbols, 7 emissions
    nbytes, ops = roofline.k4_bytes_ops(150, 2, 1, 1000, 300, 200, 5000, 7)
    assert nbytes == 150 + 2 * 17 + 300 * 16 + 200 * 64 + 7 * 8 == 17840
    assert ops == 1000 * 60 + 5000 * 4 == 80000
    # each launch reads at most the whole table and text
    nb2, _ = roofline.k4_bytes_ops(150, 2, 1, 1000, 300, 200, 5000, 7,
                                   table_bytes=1000, text_bytes=2000)
    assert nb2 == 150 + 34 + 1000 + 2000 + 56
    nb3, _ = roofline.k4_bytes_ops(150, 2, 3, 1000, 300, 200, 5000, 7,
                                   table_bytes=1000, text_bytes=2000)
    assert nb3 == 150 + 34 + min(4800, 3000) + min(12800, 6000) + 56


def test_k3_bytes_and_operations():
    # 2 reads of 100 and 50 symbols padded to 256 lanes (254 one-symbol
    # reads), 2 launches, 1,000 rounds, 300 table rows, 200 text rows,
    # 5,000 compared symbols, 7 emissions
    lane_symbols = 101 + 51 + 254 * 2
    nbytes, ops = roofline.k3_bytes_ops(lane_symbols, 256, 2, 1000, 300,
                                        200, 5000, 7)
    assert nbytes == (660 + 256 * (4 + 4 + 1 + 1) + 2 * 4 + 300 * 16
                      + 200 * 64 + 7 * 8) == 20884
    assert ops == 1000 * 60 + 5000 * 4 == 80000
    # each launch reads at most the whole table and text
    nb2, _ = roofline.k3_bytes_ops(lane_symbols, 256, 2, 1000, 300, 200,
                                   5000, 7, table_bytes=1000,
                                   text_bytes=2000)
    assert nb2 == 660 + 2560 + 8 + min(4800, 2000) + min(12800, 4000) + 56


def test_bound_names_its_peak():
    t, by = roofline.bound_s(3.35e12, 1.0)
    assert (t, by) == (1.0, "bytes")
    t, by = roofline.bound_s(1.0, 2 * roofline.INT32_OPS_PER_S)
    assert by == "operations" and t == pytest.approx(2.0)
