"""The frozen operation and byte counts (benchlib/roofline.py) against
counts made by hand at small shapes."""

import pytest

from benchlib import roofline


def test_gram_counts():
    # n = 2: three distinct entries of the symmetric K, 9 operations each per component
    assert roofline.gram_flops(2, 1) == 27
    assert roofline.gram_flops(2, 5) == 135
    # backward: every entry of dK, 20 operations per component
    assert roofline.gram_bwd_flops(2, 1) == 80


def test_factorization_counts():
    # n = 3: n^3 / 3 = 9 for the factor, 4 n^2 = 36 for the two solves
    assert roofline.chol_solve_flops(3) == 45
    # bytes: K in and L out (2 n^2), noise, y, alpha and a diagonal (4 n),
    # the 32 x 32 inverse diagonal blocks (32 n), 4 bytes each
    assert roofline.chol_solve_bytes(3) == 4 * (18 + 12 + 96)
    assert roofline.tri_inv_flops(3) == 9
    assert roofline.tri_inv_bytes(3) == 4 * (18 + 96)
    assert roofline.qmat_flops(3) == 18


def test_objective_is_its_kernels():
    n, Q = 4, 2
    assert roofline.objective_grad_flops(n, Q) == pytest.approx(
        9 * Q * 10 + (64 / 3 + 64) + 2 * 64 / 3 + 20 * Q * 16)
    assert roofline.value_flops(n, Q) == pytest.approx(9 * Q * 10 + 64 / 3 + 64)


def test_bound_takes_the_slower_of_the_two_peaks():
    assert roofline.bound_s(67e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(67e12, 2 * 3.35e12) == pytest.approx(2.0)
