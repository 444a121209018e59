"""The byte bound and the table of peaks."""

import pytest

from knnbench import roofline


def test_bytes_of_the_two_cells():
    assert roofline.solve_bytes(900_000, 50, 3) == 370_800_000
    assert roofline.solve_bytes(10_000_000, 10, 3) == 920_000_000


def test_bound_on_the_h100():
    kind = "NVIDIA H100 80GB HBM3"
    assert roofline.peak_bytes_per_s(kind) == 3.35e12
    assert roofline.bound_s(900_000, 50, 3, kind) == pytest.approx(
        370.8e6 / 3.35e12)
    assert roofline.bound_s(10_000_000, 10, 3, kind) * 1e3 == pytest.approx(
        0.274627, rel=1e-5)


def test_no_peak_no_bound():
    assert roofline.peak_bytes_per_s("cpu") is None
    assert roofline.bound_s(10, 2, 3, "NVIDIA H100 PCIe") is None
