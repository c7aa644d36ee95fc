"""Raster kernel against the plain-XLA executor: fill classes, stroke
joints, caps and dash modes.  The kernel runs in Pallas interpret mode
here; see kernel_cases for the comparison limits."""

import numpy as np
import pytest

from kernel_cases import assert_matches, kernel_and_reference

COVERAGE_CASES = [
    "fill_solid",
    "fill_quadratic",
    "fill_cubic",
    "stroke_miter_butt",
    "stroke_bevel_square_round",
    "stroke_round_out_in",
    "stroke_dash_single",
    "stroke_dash_multi",
]


@pytest.mark.parametrize("case", COVERAGE_CASES)
def test_kernel_matches_plain_executor(case):
    got, want = kernel_and_reference(case)
    assert got.shape == want.shape == (64, 64, 4)
    assert np.isfinite(got).all()
    assert_matches(got, want)
    assert got[..., 3].max() > 0.5  # the scene drew


def test_batched_walk_matches_plain_executor():
    """Fill and stroke batches wider than one entry mask their tails."""
    got, want = kernel_and_reference(
        "stroke_dash_multi", fill_batch=4, stroke_batch=3
    )
    assert_matches(got, want)
    assert got[..., 3].max() > 0.5
