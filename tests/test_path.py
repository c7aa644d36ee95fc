"""Unit tests for the path model (parity with reference src/path.rs)."""

import math

import numpy as np
import pytest

from contrast_renderer import path as pathmod
from contrast_renderer.path import (
    CurveApproximation,
    IntegralCubicCurveSegment,
    IntegralQuadraticCurveSegment,
    LineSegment,
    Path,
    RationalCubicCurveSegment,
    RationalQuadraticCurveSegment,
    SegmentType,
    StrokeOptions,
)
from contrast_renderer.utils import ga2d


def rational_quadratic_eval(p0, p1, p2, w, t):
    """Direct rational quadratic evaluation for golden checks."""
    b = np.array([(1 - t) ** 2, 2 * t * (1 - t), t * t])
    weights = np.array([1.0, w, 1.0])
    num = b * weights
    pts = np.stack([p0, p1, p2])
    return (num @ pts) / num.sum()


class TestBasics:
    def test_push_and_end(self):
        p = Path(start=(1.0, 2.0))
        assert np.allclose(p.get_end(), [1.0, 2.0])
        p.push_line(LineSegment([(3.0, 4.0)]))
        assert np.allclose(p.get_end(), [3.0, 4.0])
        p.push_integral_quadratic_curve(
            IntegralQuadraticCurveSegment([(4.0, 4.0), (5.0, 2.0)])
        )
        assert np.allclose(p.get_end(), [5.0, 2.0])
        assert p.segment_types == [
            SegmentType.LINE,
            SegmentType.INTEGRAL_QUADRATIC_CURVE,
        ]

    def test_tangents(self):
        p = Path(start=(0.0, 0.0))
        p.push_line(LineSegment([(2.0, 0.0)]))
        p.push_line(LineSegment([(2.0, 3.0)]))
        st = p.get_start_tangent()
        et = p.get_end_tangent()
        assert np.allclose([st[2], -st[1]], [1.0, 0.0])  # direction +x
        assert np.allclose([et[2], -et[1]], [0.0, 1.0])  # direction +y

    def test_empty_tangent_zero(self):
        p = Path()
        assert np.allclose(p.get_start_tangent(), 0.0)
        assert np.allclose(p.get_end_tangent(), 0.0)

    def test_nonfinite_rejected(self):
        with pytest.raises(ValueError):
            Path(start=(float("nan"), 0.0))
        with pytest.raises(ValueError):
            LineSegment([(float("inf"), 0.0)])

    def test_append(self):
        a = Path(start=(0, 0))
        a.push_line(LineSegment([(1, 0)]))
        b = Path(start=(1, 0))
        b.push_line(LineSegment([(1, 1)]))
        a.append(b)
        assert len(a) == 2
        assert len(b) == 0

    def test_close(self):
        p = Path.from_polygon([(0, 0), (1, 0), (1, 1)])
        n = len(p)
        p.close()
        assert len(p) == n + 1
        assert np.allclose(p.get_end(), [0, 0])
        p.close()  # already closed: no-op
        assert len(p) == n + 1

    def test_legalize(self):
        opts = StrokeOptions(width=-2.0, offset=0.9, miter_clip=-1.5)
        opts.legalize()
        assert opts.width == 2.0
        assert opts.offset == 0.5
        assert opts.miter_clip == 1.5


class TestTransformReverse:
    def test_transform_scale_translate(self):
        p = Path.from_rect((0, 0), (1, 1))
        p.transform(2.0, ga2d.translate2d([10.0, 5.0]))
        assert np.allclose(p.start, [8.0, 3.0])  # (-1,-1)*2 + (10,5)
        assert np.allclose(p.get_end(), [12.0, 3.0])

    def test_transform_rotation(self):
        p = Path(start=(1.0, 0.0))
        p.push_line(LineSegment([(2.0, 0.0)]))
        p.transform(1.0, ga2d.rotate2d(math.pi / 2))
        assert np.allclose(p.start, [0.0, 1.0], atol=1e-12)
        assert np.allclose(p.get_end(), [0.0, 2.0], atol=1e-12)

    def test_reverse_roundtrip(self):
        p = Path(start=(0.0, 0.0))
        p.push_line(LineSegment([(1.0, 0.0)]))
        p.push_integral_cubic_curve(
            IntegralCubicCurveSegment([(2.0, 1.0), (3.0, -1.0), (4.0, 0.0)])
        )
        p.push_rational_cubic_curve(
            RationalCubicCurveSegment([1.0, 2.0, 3.0, 4.0], [(5, 1), (6, -1), (7, 0)])
        )
        start, end = p.start.copy(), p.get_end().copy()
        q = Path(start=p.start)
        # Deep copy via reverse twice: reverse, check swap, reverse again.
        p.reverse()
        assert np.allclose(p.start, end)
        assert np.allclose(p.get_end(), start)
        assert np.allclose(p.rational_cubic_curve_segments[0].weights, [4.0, 3.0, 2.0, 1.0])
        p.reverse()
        assert np.allclose(p.start, start)
        assert np.allclose(p.get_end(), end)
        assert np.allclose(p.rational_cubic_curve_segments[0].weights, [1.0, 2.0, 3.0, 4.0])
        assert np.allclose(
            p.integral_cubic_curve_segments[0].control_points,
            [(2.0, 1.0), (3.0, -1.0), (4.0, 0.0)],
        )


class TestConversions:
    def test_integral_to_rational(self):
        p = Path(start=(0, 0))
        p.push_integral_quadratic_curve(IntegralQuadraticCurveSegment([(1, 1), (2, 0)]))
        p.push_integral_cubic_curve(IntegralCubicCurveSegment([(3, 1), (4, -1), (5, 0)]))
        p.convert_integral_curves_to_rational_curves()
        assert p.segment_types == [
            SegmentType.RATIONAL_QUADRATIC_CURVE,
            SegmentType.RATIONAL_CUBIC_CURVE,
        ]
        assert p.rational_quadratic_curve_segments[0].weight == 1.0
        assert np.allclose(p.rational_cubic_curve_segments[0].weights, 1.0)

    def test_quadratic_to_cubic_integral(self):
        # Degree elevation must preserve the traced curve.
        p0, a, b = np.array([0.0, 0.0]), np.array([1.0, 2.0]), np.array([2.0, 0.0])
        p = Path(start=p0)
        p.push_integral_quadratic_curve(IntegralQuadraticCurveSegment([a, b]))
        p.convert_quadratic_curves_to_cubic_curves()
        (seg,) = p.integral_cubic_curve_segments
        for t in np.linspace(0, 1, 7):
            quad = (1 - t) ** 2 * p0 + 2 * t * (1 - t) * a + t * t * b
            c0, c1, c2 = seg.control_points
            cubic = (
                (1 - t) ** 3 * p0
                + 3 * t * (1 - t) ** 2 * c0
                + 3 * t * t * (1 - t) * c1
                + t**3 * c2
            )
            assert np.allclose(quad, cubic)

    def test_quadratic_to_cubic_rational(self):
        p0, a, b, w = np.array([1.0, 0.0]), np.array([1.0, 1.0]), np.array([0.0, 1.0]), math.sqrt(0.5)
        p = Path(start=p0)
        p.push_rational_quadratic_curve(RationalQuadraticCurveSegment(w, [a, b]))
        p.convert_quadratic_curves_to_cubic_curves()
        (seg,) = p.rational_cubic_curve_segments
        ws = seg.weights
        cps = [p0] + [c for c in seg.control_points]
        for t in np.linspace(0, 1, 7):
            quad = rational_quadratic_eval(p0, a, b, w, t)
            basis = np.array(
                [(1 - t) ** 3, 3 * t * (1 - t) ** 2, 3 * t * t * (1 - t), t**3]
            )
            num = basis * ws
            cubic = (num @ np.stack(cps)) / num.sum()
            assert np.allclose(quad, cubic)


class TestConstructors:
    def test_from_polygon(self):
        p = Path.from_polygon([(0, 0), (1, 0), (1, 1), (0, 1)])
        assert len(p) == 3
        assert np.allclose(p.start, [0, 0])
        assert np.allclose(p.get_end(), [0, 1])

    def test_from_regular_polygon(self):
        p = Path.from_regular_polygon((0, 0), 1.0, 0.0, 6)
        assert len(p) == 5
        assert np.allclose(p.start, [1, 0])

    def test_circle_points_on_circle(self):
        center, radius = np.array([2.0, -1.0]), 3.0
        p = Path.from_circle(center, radius)
        assert len(p) == 4
        assert all(
            t is SegmentType.RATIONAL_QUADRATIC_CURVE for t in p.segment_types
        )
        prev = p.start
        for seg in p.rational_quadratic_curve_segments:
            assert np.isclose(seg.weight, math.sqrt(0.5))
            for t in np.linspace(0, 1, 9):
                pt = rational_quadratic_eval(
                    prev, seg.control_points[0], seg.control_points[1], seg.weight, t
                )
                assert np.isclose(np.linalg.norm(pt - center), radius, atol=1e-12)
            prev = seg.control_points[1]

    def test_rounded_rect_structure(self):
        p = Path.from_rounded_rect((0, 0), (2, 1), 0.25)
        assert len(p) == 8  # 4 lines + 4 arcs
        assert np.allclose(p.get_end(), p.start)


class TestEllipticalArc:
    @pytest.mark.parametrize("large_arc", [False, True])
    @pytest.mark.parametrize("sweep", [False, True])
    def test_endpoint_and_on_ellipse(self, large_arc, sweep):
        rx, ry, rot = 2.0, 1.0, 0.3
        src = np.array([rx * math.cos(0.2), ry * math.sin(0.2)])
        dst = np.array([rx * math.cos(2.1), ry * math.sin(2.1)])

        def rotate(v):
            c, s = math.cos(rot), math.sin(rot)
            return np.array([c * v[0] - s * v[1], s * v[0] + c * v[1]])

        p = Path(start=rotate(src))
        p.push_elliptical_arc((rx, ry), rot, large_arc, sweep, rotate(dst))
        assert len(p) >= 1
        assert np.allclose(p.get_end(), rotate(dst), atol=1e-9)
        # All segment endpoints must lie on an ellipse with the given radii
        # (center is arc-dependent); verify via sampled curve points being
        # consistent with radii: transform into centered frame.
        # Reconstruct center from first and last points + radii via fitting:
        pts = []
        prev = p.start
        for seg in p.rational_quadratic_curve_segments:
            for t in np.linspace(0, 1, 5):
                pts.append(
                    rational_quadratic_eval(
                        prev, seg.control_points[0], seg.control_points[1], seg.weight, t
                    )
                )
            prev = seg.control_points[1]
        pts = np.array(pts)
        # Un-rotate, then fit circle-like constraint: ((x-cx)/rx)² + ((y-cy)/ry)² = 1.
        c, s = math.cos(rot), math.sin(rot)
        un = pts @ np.array([[c, -s], [s, c]])  # rotate by -rot
        # Linear least squares for cx, cy given unit-normalized ellipse.
        A = np.stack(
            [2 * un[:, 0] / rx**2, 2 * un[:, 1] / ry**2, np.ones(len(un))], axis=1
        )
        b = un[:, 0] ** 2 / rx**2 + un[:, 1] ** 2 / ry**2
        sol, *_ = np.linalg.lstsq(A, b, rcond=None)
        cx, cy = sol[0], sol[1]
        r = (un[:, 0] - cx) ** 2 / rx**2 + (un[:, 1] - cy) ** 2 / ry**2
        assert np.allclose(r, 1.0, atol=1e-6)

    def test_sweep_direction(self):
        # SVG semantics: sweep=1 is the positive-angle direction in SVG's
        # y-down frame, i.e. CLOCKWISE in y-up math coordinates.
        # Unit circle from (1,0) to (0,1), sweep=True → CW short arc around
        # center (1,1), bulging toward the origin side of the chord.
        p = Path(start=(1.0, 0.0))
        p.push_elliptical_arc((1.0, 1.0), 0.0, False, True, (0.0, 1.0))
        prev = p.start
        seg = p.rational_quadratic_curve_segments[0]
        mid = rational_quadratic_eval(
            prev, seg.control_points[0], seg.control_points[1], seg.weight, 0.5
        )
        assert np.allclose(mid, [1 - math.sqrt(0.5), 1 - math.sqrt(0.5)], atol=1e-9)
        # sweep=False → CCW short arc around center (0,0) through (.707,.707).
        q = Path(start=(1.0, 0.0))
        q.push_elliptical_arc((1.0, 1.0), 0.0, False, False, (0.0, 1.0))
        prev = q.start
        seg = q.rational_quadratic_curve_segments[0]
        mid = rational_quadratic_eval(
            prev, seg.control_points[0], seg.control_points[1], seg.weight, 0.5
        )
        assert np.allclose(mid, [math.sqrt(0.5), math.sqrt(0.5)], atol=1e-9)

    def test_large_arc_segment_count(self):
        p = Path(start=(1.0, 0.0))
        p.push_elliptical_arc((1.0, 1.0), 0.0, True, True, (0.0, 1.0))
        # 270° arc → ceil(270/120) = 3 segments.
        assert len(p.rational_quadratic_curve_segments) == 3

    def test_zero_radius_degrades_to_line(self):
        p = Path(start=(0.0, 0.0))
        p.push_elliptical_arc((0.0, 1.0), 0.0, False, True, (1.0, 1.0))
        assert p.segment_types == [SegmentType.LINE]

    def test_radii_scaled_up_when_too_small(self):
        p = Path(start=(0.0, 0.0))
        p.push_elliptical_arc((0.1, 0.1), 0.0, False, True, (10.0, 0.0))
        assert np.allclose(p.get_end(), [10.0, 0.0], atol=1e-6)
