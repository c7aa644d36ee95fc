"""Stroke tessellation correctness vs analytic ground truth.

The reference has no tests; these validate the stroke geometry + the
per-sample cap/join/dash predicates against closed-form coverage masks
(rectangles, discs, annuli) — the shapes the reference's documentation
defines (path.rs:69-118).
"""

import math

import numpy as np
import pytest

from contrast_renderer import oracle
from contrast_renderer.dynamic_stroke import StrokeDescriptorTable
from contrast_renderer.path import (
    Cap,
    CurveApproximation,
    DashInterval,
    DynamicStrokeOptions,
    Join,
    LineSegment,
    Path,
    StrokeOptions,
)
from contrast_renderer.stroke import StrokeBuilder

SIZE = 96


def stroke_coverage(paths, options_groups, size=SIZE):
    builder = StrokeBuilder()
    hull = []
    for p in paths:
        builder.add_path(hull, p)
    table = builder.build()
    assert len(table) > 0
    descriptors = StrokeDescriptorTable.from_options(options_groups)
    winding = oracle.rasterize_table(table, size, size, descriptors)
    return oracle.coverage_from_winding(winding), hull


def sample_xy(size=SIZE):
    """Model-space coordinates of every sample (y-up model == pixel with
    y flip).  Returns (H, W, S, 2)."""
    pos = oracle.sample_positions(size, size)
    out = pos.copy()
    out[..., 1] = size - pos[..., 1]
    return out


def solid(join=Join.MITER, start=Cap.BUTT, end=Cap.BUTT):
    return DynamicStrokeOptions.make_solid(join, start, end)


def check(mask, expected, budget=3e-3):
    mismatch = np.mean(mask != expected)
    assert mismatch <= budget, f"coverage mismatch {mismatch:.5f}"


class TestLineStrokes:
    def test_horizontal_butt(self):
        p = Path(start=(20, 48), stroke_options=StrokeOptions(width=10.0))
        p.push_line(LineSegment([(76, 48)]))
        mask, _ = stroke_coverage([p], [solid()])
        xy = sample_xy()
        expected = (
            (xy[..., 0] >= 20) & (xy[..., 0] <= 76)
            & (np.abs(xy[..., 1] - 48) <= 5)
        )
        check(mask, expected)

    def test_horizontal_square_caps(self):
        p = Path(start=(20, 48), stroke_options=StrokeOptions(width=10.0))
        p.push_line(LineSegment([(76, 48)]))
        mask, _ = stroke_coverage([p], [solid(start=Cap.SQUARE, end=Cap.SQUARE)])
        xy = sample_xy()
        expected = (
            (xy[..., 0] >= 15) & (xy[..., 0] <= 81)
            & (np.abs(xy[..., 1] - 48) <= 5)
        )
        check(mask, expected)

    def test_horizontal_round_caps(self):
        p = Path(start=(20, 48), stroke_options=StrokeOptions(width=10.0))
        p.push_line(LineSegment([(76, 48)]))
        mask, _ = stroke_coverage([p], [solid(start=Cap.ROUND, end=Cap.ROUND)])
        xy = sample_xy()
        body = (
            (xy[..., 0] >= 20) & (xy[..., 0] <= 76)
            & (np.abs(xy[..., 1] - 48) <= 5)
        )
        discs = (
            np.hypot(xy[..., 0] - 20, xy[..., 1] - 48) <= 5
        ) | (np.hypot(xy[..., 0] - 76, xy[..., 1] - 48) <= 5)
        check(mask, body | discs)

    def test_offset_shifts_stroke(self):
        p = Path(
            start=(20, 48),
            stroke_options=StrokeOptions(width=10.0, offset=0.5),
        )
        p.push_line(LineSegment([(76, 48)]))
        mask, _ = stroke_coverage([p], [solid()])
        xy = sample_xy()
        # offset +0.5 shifts by half a width along the left normal of the
        # direction (+x): left normal is +y.
        expected = (
            (xy[..., 0] >= 20) & (xy[..., 0] <= 76)
            & (xy[..., 1] - 48 >= 0) & (xy[..., 1] - 48 <= 10)
        )
        check(mask, expected)


class TestJoins:
    def path_corner(self, join):
        p = Path(
            start=(20, 20),
            stroke_options=StrokeOptions(width=10.0, miter_clip=2.0),
        )
        p.push_line(LineSegment([(70, 20)]))
        p.push_line(LineSegment([(70, 70)]))
        return p, [solid(join=join)]

    def expected_rects(self, xy):
        horizontal = (
            (xy[..., 0] >= 20) & (xy[..., 0] <= 70)
            & (np.abs(xy[..., 1] - 20) <= 5)
        )
        vertical = (
            (np.abs(xy[..., 0] - 70) <= 5)
            & (xy[..., 1] >= 20) & (xy[..., 1] <= 70)
        )
        return horizontal, vertical

    def test_miter_join(self):
        p, groups = self.path_corner(Join.MITER)
        mask, _ = stroke_coverage([p], groups)
        xy = sample_xy()
        h, v = self.expected_rects(xy)
        # 90° miter: corner square filled.
        corner = (
            (xy[..., 0] >= 70) & (xy[..., 0] <= 75)
            & (xy[..., 1] >= 15) & (xy[..., 1] <= 20)
        )
        check(mask, h | v | corner)

    def test_round_join(self):
        p, groups = self.path_corner(Join.ROUND)
        mask, _ = stroke_coverage([p], groups)
        xy = sample_xy()
        h, v = self.expected_rects(xy)
        corner = np.hypot(xy[..., 0] - 70, xy[..., 1] - 20) <= 5
        check(mask, h | v | corner)

    def test_bevel_join(self):
        p, groups = self.path_corner(Join.BEVEL)
        mask, _ = stroke_coverage([p], groups)
        xy = sample_xy()
        h, v = self.expected_rects(xy)
        # Bevel: triangle between the two edge endpoints and the corner.
        # Edge vertices at (75, 20) and (70, 15); corner (70, 20).
        dx = xy[..., 0] - 70
        dy = 20 - xy[..., 1]
        corner = (dx >= 0) & (dy >= 0) & (dx + dy <= 5)
        check(mask, h | v | corner)

    def test_miter_clip(self):
        # Sharp angle exceeding the miter clip: tip clipped flat.
        p = Path(
            start=(15, 30),
            stroke_options=StrokeOptions(width=10.0, miter_clip=0.8),
        )
        p.push_line(LineSegment([(70, 30)]))
        p.push_line(LineSegment([(15, 44)]))
        mask, _ = stroke_coverage([p], [solid(join=Join.MITER)])
        xy = sample_xy()
        # The miter tip would extend far right of x=70+; clipped at
        # distance 8 from the corner: nothing beyond x ≈ 70+8.
        beyond = xy[..., 0] > 79.0
        assert not (mask & beyond).any()
        # But some joint geometry exists right of the corner.
        near = (xy[..., 0] > 71.0) & (xy[..., 0] < 76.0)
        assert (mask & near).any()


class TestCircleStroke:
    @pytest.mark.parametrize(
        "approx",
        [
            CurveApproximation.uniformly_spaced_parameters(24),
            CurveApproximation.uniform_tangent_angle(0.1),
        ],
        ids=["uniform_params", "uniform_angle"],
    )
    def test_circle_annulus(self, approx):
        p = Path.from_circle((48, 48), 30)
        p.stroke_options = StrokeOptions(
            width=8.0, closed=True, curve_approximation=approx
        )
        mask, _ = stroke_coverage([p], [solid(join=Join.ROUND)])
        xy = sample_xy()
        r = np.hypot(xy[..., 0] - 48, xy[..., 1] - 48)
        expected = np.abs(r - 30) <= 4
        check(mask, expected, budget=4e-3)


class TestDashes:
    def test_dashed_horizontal(self):
        p = Path(start=(8, 48), stroke_options=StrokeOptions(width=8.0))
        p.push_line(LineSegment([(88, 48)]))
        groups = [
            DynamicStrokeOptions.make_dashed(
                Join.MITER,
                [DashInterval(gap_start=2.0, gap_end=3.0)],
                phase=0.0,
            )
        ]
        mask, _ = stroke_coverage([p], groups)
        xy = sample_xy()
        along = (xy[..., 0] - 8) / 8.0  # pattern position in width units
        pattern = np.remainder(along, 3.0) <= 2.0
        # Dashed strokes extend through the half-width cap extension quads
        # at both path ends, with the pattern continuing (the reference's
        # shader checks `dashed` before the cap flags, shaders.wgsl:275-283).
        expected = (
            (xy[..., 0] >= 4) & (xy[..., 0] <= 92)
            & (np.abs(xy[..., 1] - 48) <= 4) & pattern
        )
        check(mask, expected)

    def test_dash_phase_shifts(self):
        def mask_with_phase(phase):
            p = Path(start=(8, 48), stroke_options=StrokeOptions(width=8.0))
            p.push_line(LineSegment([(88, 48)]))
            groups = [
                DynamicStrokeOptions.make_dashed(
                    Join.MITER,
                    [DashInterval(gap_start=2.0, gap_end=3.0)],
                    phase=phase,
                )
            ]
            return stroke_coverage([p], groups)[0]

        m0 = mask_with_phase(0.0)
        m1 = mask_with_phase(1.0)
        xy = sample_xy()
        along = (xy[..., 0] - 8) / 8.0
        body = (
            (xy[..., 0] >= 4) & (xy[..., 0] <= 92)
            & (np.abs(xy[..., 1] - 48) <= 4)
        )
        check(m1, body & (np.remainder(along - 1.0, 3.0) <= 2.0))
        assert (m0 != m1).mean() > 0.005  # phase visibly moved the dashes

    def test_dashed_round_dash_caps(self):
        p = Path(start=(8, 48), stroke_options=StrokeOptions(width=8.0))
        p.push_line(LineSegment([(88, 48)]))
        groups = [
            DynamicStrokeOptions.make_dashed(
                Join.MITER,
                [
                    DashInterval(
                        gap_start=2.0,
                        gap_end=4.0,
                        dash_start=Cap.ROUND,
                        dash_end=Cap.ROUND,
                    )
                ],
                phase=0.0,
            )
        ]
        mask, _ = stroke_coverage([p], groups)
        xy = sample_xy()
        along = (xy[..., 0] - 8) / 8.0
        in_pattern = np.remainder(along, 4.0)
        body = (
            (xy[..., 0] >= 4) & (xy[..., 0] <= 92)
            & (np.abs(xy[..., 1] - 48) <= 4)
        )
        dash = in_pattern <= 2.0
        # Round caps: half-discs protruding into the gap at both ends.
        dy = (xy[..., 1] - 48) / 8.0
        cap_a = np.hypot(in_pattern - 2.0, dy) < 0.5
        cap_b = np.hypot(4.0 - in_pattern, dy) < 0.5
        check(mask, body & (dash | cap_a | cap_b), budget=4e-3)


class TestClosedStroke:
    def test_closed_square_outline(self):
        p = Path.from_rect((48, 48), (25, 25))
        p.stroke_options = StrokeOptions(width=6.0, closed=True)
        mask, _ = stroke_coverage([p], [solid(join=Join.MITER)])
        xy = sample_xy()
        dx = np.abs(xy[..., 0] - 48)
        dy = np.abs(xy[..., 1] - 48)
        outer = np.maximum(dx, dy) <= 28
        inner = np.maximum(dx, dy) < 22
        check(mask, outer & ~inner)
