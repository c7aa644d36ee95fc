"""Unit tests for curve math (parity with reference src/curve.rs)."""

import math

import numpy as np
import pytest

from contrast_renderer import curve
from contrast_renderer.utils import ga2d


def cps(*pts):
    """Unweighted homogeneous control points from (x, y) pairs."""
    return np.array([[1.0, x, y] for x, y in pts])


def bezier_eval(points, t):
    """De Casteljau on homogeneous points, for golden checks."""
    pts = np.asarray(points, dtype=np.float64)
    while len(pts) > 1:
        pts = pts[:-1] * (1 - t) + pts[1:] * t
    return pts[0]


class TestPowerBasis:
    def test_quadratic_matches_bezier(self):
        control = cps((0, 0), (1, 2), (3, 1))
        pb = curve.rational_quadratic_control_points_to_power_basis(control)
        for t in np.linspace(0, 1, 7):
            assert np.allclose(
                curve.rational_quadratic_point(pb, t), bezier_eval(control, t)
            )

    def test_cubic_matches_bezier(self):
        control = cps((0, 0), (1, 3), (2, -1), (4, 1))
        pb = curve.rational_cubic_control_points_to_power_basis(control)
        for t in np.linspace(0, 1, 7):
            assert np.allclose(
                curve.rational_cubic_point(pb, t), bezier_eval(control, t)
            )

    def test_weighted_cubic(self):
        control = np.array(
            [[1.0, 0, 0], [2.0, 2.0, 4.0], [0.5, 0.5, -0.25], [1.0, 3, 1]]
        )
        pb = curve.rational_cubic_control_points_to_power_basis(control)
        for t in np.linspace(0, 1, 5):
            assert np.allclose(
                curve.rational_cubic_point(pb, t), bezier_eval(control, t)
            )


class TestReparametrize:
    def test_quadratic_split(self):
        control = cps((0, 0), (1, 2), (3, 1))
        pb = curve.rational_quadratic_control_points_to_power_basis(control)
        sub = curve.reparametrize_rational_quadratic(pb, 0.25, 0.75)
        for s in np.linspace(0, 1, 5):
            expected = curve.rational_quadratic_point(pb, 0.25 + 0.5 * s)
            got = curve.rational_quadratic_point(sub, s)
            assert np.allclose(ga2d.point_to_vec(got), ga2d.point_to_vec(expected))

    def test_cubic_split(self):
        control = cps((0, 0), (1, 3), (2, -1), (4, 1))
        pb = curve.rational_cubic_control_points_to_power_basis(control)
        sub = curve.reparametrize_rational_cubic(pb, 0.2, 0.9)
        for s in np.linspace(0, 1, 5):
            expected = curve.rational_cubic_point(pb, 0.2 + 0.7 * s)
            got = curve.rational_cubic_point(sub, s)
            assert np.allclose(ga2d.point_to_vec(got), ga2d.point_to_vec(expected))


class TestDerivatives:
    def test_quadratic_tangent_direction(self):
        control = cps((0, 0), (1, 2), (3, 1))
        pb = curve.rational_quadratic_control_points_to_power_basis(control)
        for t in [0.1, 0.5, 0.9]:
            line = curve.rational_quadratic_first_order_derivative(pb, t)
            # Finite-difference direction.
            h = 1e-6
            p0 = ga2d.point_to_vec(curve.rational_quadratic_point(pb, t - h))
            p1 = ga2d.point_to_vec(curve.rational_quadratic_point(pb, t + h))
            fd = (p1 - p0) / np.linalg.norm(p1 - p0)
            direction = np.array([line[2], -line[1]])
            direction /= np.linalg.norm(direction)
            assert np.allclose(direction, fd, atol=1e-5)

    def test_cubic_tangent_direction(self):
        control = cps((0, 0), (1, 3), (2, -1), (4, 1))
        pb = curve.rational_cubic_control_points_to_power_basis(control)
        for t in [0.15, 0.5, 0.85]:
            line = curve.rational_cubic_first_order_derivative(pb, t)
            h = 1e-6
            p0 = ga2d.point_to_vec(curve.rational_cubic_point(pb, t - h))
            p1 = ga2d.point_to_vec(curve.rational_cubic_point(pb, t + h))
            fd = (p1 - p0) / np.linalg.norm(p1 - p0)
            direction = np.array([line[2], -line[1]])
            direction /= np.linalg.norm(direction)
            assert np.allclose(direction, fd, atol=1e-5)

    def test_tangent_incident_to_point(self):
        control = cps((0, 0), (1, 3), (2, -1), (4, 1))
        pb = curve.rational_cubic_control_points_to_power_basis(control)
        for t in [0.2, 0.7]:
            line = curve.rational_cubic_first_order_derivative(pb, t)
            p = curve.rational_cubic_point(pb, t)
            assert abs(ga2d.point_line(p, line)) < 1e-9


# Canonical Loop-Blinn classification examples.
SERPENTINE = cps((0, 0), (2, 3), (4, -1), (5, 0))  # positive discriminant
SYMMETRIC_S = cps((0, 0), (1, 2), (2, -2), (3, 0))  # inflection at 0.5, one at ∞
LOOP = cps((0, 0), (3, 2), (-1, 2), (2, 0))  # self-intersecting


class TestInflectionClassification:
    @pytest.mark.parametrize("control", [SERPENTINE, SYMMETRIC_S])
    def test_serpentine_roots_are_inflections(self, control):
        pb = curve.rational_cubic_control_points_to_power_basis(control)
        ippc = curve.inflection_point_polynomial_coefficients(pb, True)
        disc, roots = curve.integral_inflection_points(ippc, False)
        assert disc > 0
        params = sorted(
            r.numerator.real / r.denominator for r in roots if r.is_finite
        )
        assert len(params) >= 1
        # Verify each finite root is a true inflection: second derivative
        # parallel to the first (zero curvature).
        for t in params:
            d1 = curve.rational_cubic_first_order_derivative(pb, t)
            d2 = curve.rational_cubic_second_order_derivative(pb, t)
            cross = d1[1] * d2[2] - d1[2] * d2[1]
            scale = max(1.0, abs(d1[1] * d2[2]), abs(d1[2] * d2[1]))
            assert abs(cross) / scale < 1e-6

    def test_symmetric_s_single_finite_inflection(self):
        pb = curve.rational_cubic_control_points_to_power_basis(SYMMETRIC_S)
        ippc = curve.inflection_point_polynomial_coefficients(pb, True)
        disc, roots = curve.integral_inflection_points(ippc, False)
        params = [r.numerator.real / r.denominator for r in roots if r.is_finite]
        assert np.allclose(params, [0.5], atol=1e-6)

    def test_loop(self):
        pb = curve.rational_cubic_control_points_to_power_basis(LOOP)
        ippc = curve.inflection_point_polynomial_coefficients(pb, True)
        disc, roots = curve.integral_inflection_points(ippc, True)
        assert disc < 0
        params = [
            r.numerator.real / r.denominator for r in roots[:2] if r.is_finite
        ]
        # The two roots are the self-intersection parameters: same point.
        p0 = ga2d.point_to_vec(curve.rational_cubic_point(pb, params[0]))
        p1 = ga2d.point_to_vec(curve.rational_cubic_point(pb, params[1]))
        assert not np.isclose(params[0], params[1])
        assert np.allclose(p0, p1, atol=1e-5)

    def test_rational_matches_integral_for_unit_weights(self):
        pb = curve.rational_cubic_control_points_to_power_basis(SERPENTINE)
        ippc = curve.inflection_point_polynomial_coefficients(pb, False)
        disc, roots = curve.rational_inflection_points(ippc, False)
        assert disc > 0
        params = sorted(
            r.numerator.real / r.denominator
            for r in roots
            if r.is_finite and abs(r.numerator.imag) < 1e-6
        )
        ippc_i = curve.inflection_point_polynomial_coefficients(pb, True)
        _, roots_i = curve.integral_inflection_points(ippc_i, False)
        params_i = sorted(
            r.numerator.real / r.denominator for r in roots_i if r.is_finite
        )
        # The rational solve finds the same finite inflections (it may
        # additionally report the third root of the full cubic).
        for t in params_i:
            assert any(abs(t - p) < 1e-4 for p in params)

    def test_rational_loop_double_point(self):
        # A rational cubic with a genuine loop and non-unit weights.
        control = np.array(
            [[1.0, 0, 0], [1.5, 4.5, 3.0], [0.8, -0.8, 1.6], [1.0, 2, 0]]
        )
        pb = curve.rational_cubic_control_points_to_power_basis(control)
        ippc = curve.inflection_point_polynomial_coefficients(pb, False)
        disc, roots = curve.rational_inflection_points(ippc, True)
        if disc < 0:  # loop detected
            params = [
                r.numerator.real / r.denominator
                for r in roots[:2]
                if r.is_finite and abs(r.numerator.imag) < 1e-9
            ]
            if len(params) == 2:
                p0 = ga2d.point_to_vec(curve.rational_cubic_point(pb, params[0]))
                p1 = ga2d.point_to_vec(curve.rational_cubic_point(pb, params[1]))
                assert np.allclose(p0, p1, atol=1e-4)


class TestUniformTangentAngle:
    def test_integral_quadratic_angles_uniform(self):
        control = cps((0, 0), (2, 2), (4, 0))
        pb = curve.rational_quadratic_control_points_to_power_basis(control)
        start = ga2d.signum(curve.rational_quadratic_first_order_derivative(pb, 0.0))
        end = ga2d.signum(curve.rational_quadratic_first_order_derivative(pb, 1.0))
        step = 0.2
        params = curve.integral_quadratic_uniform_tangent_angle(pb, start, end, step)
        assert params[-1] == 1.0
        # Total turn is 90°; number of interior params ≈ round(τ/4 / 0.2) - 1.
        total_turn = math.pi / 2
        expected = int(total_turn / step + 0.5) - 1
        assert len(params) == expected + 1
        # Tangent angles at consecutive params differ by ~step.
        full = [0.0] + list(params)
        angles = []
        for t in full:
            d = curve.rational_quadratic_first_order_derivative(pb, t)
            angles.append(math.atan2(d[2], d[1]))
        diffs = np.abs(np.diff(np.unwrap(angles)))
        assert np.allclose(diffs, diffs[0], atol=1e-2)

    def test_rational_quadratic_circle_arc(self):
        # Quarter circle as rational quadratic: perfectly uniform angles.
        w = math.sqrt(0.5)
        control = np.array([[1.0, 1.0, 0.0], [w, w, w], [1.0, 0.0, 1.0]])
        pb = curve.rational_quadratic_control_points_to_power_basis(control)
        start = ga2d.signum(curve.rational_quadratic_first_order_derivative(pb, 0.0))
        end = ga2d.signum(curve.rational_quadratic_first_order_derivative(pb, 1.0))
        params = curve.rational_quadratic_uniform_tangent_angle(pb, start, end, 0.1)
        full = [0.0] + list(params)
        pts = np.array(
            [ga2d.point_to_vec(curve.rational_quadratic_point(pb, t)) for t in full]
        )
        # All on the unit circle.
        assert np.allclose(np.linalg.norm(pts, axis=1), 1.0, atol=1e-9)
        # Polar angles uniformly spaced.
        angles = np.unwrap(np.arctan2(pts[:, 1], pts[:, 0]))
        diffs = np.diff(angles)
        assert np.allclose(diffs, diffs[0], atol=1e-6)
        assert np.isclose(abs(diffs[0]), (math.pi / 2) / (len(full) - 1), atol=1e-6)

    def test_integral_cubic_splits_at_inflections(self):
        pb = curve.rational_cubic_control_points_to_power_basis(SERPENTINE)
        params = curve.integral_cubic_uniform_tangent_angle(pb, 0.1)
        assert params[-1] == 1.0
        assert all(0 <= t <= 1 for t in params)
        # Inflection parameters appear in the list (as interval ends).
        ippc = curve.inflection_point_polynomial_coefficients(pb, True)
        _, roots = curve.integral_inflection_points(ippc, False)
        for r in roots:
            if r.is_finite:
                t = r.numerator.real / r.denominator
                if 0.0 <= t <= 1.0:
                    assert any(abs(t - p) < 1e-5 for p in params)
        # Monotone non-decreasing.
        assert all(b >= a - 1e-12 for a, b in zip(params, params[1:]))

    def test_rational_cubic_sampling(self):
        control = np.array(
            [[1.0, 0, 0], [1.2, 1.2, 3.6], [0.9, 1.8, -0.9], [1.0, 4, 1]]
        )
        pb = curve.rational_cubic_control_points_to_power_basis(control)
        params = curve.rational_cubic_uniform_tangent_angle(pb, 0.15)
        assert params[-1] == 1.0
        assert all(0 <= t <= 1 for t in params)
        assert all(b >= a - 1e-12 for a, b in zip(params, params[1:]))
        # Sampling should be dense enough: consecutive tangent angle deltas
        # bounded by ~2x the step except across splits.
        full = [0.0] + list(params)
        angles = []
        for t in full:
            d = curve.rational_cubic_first_order_derivative(pb, t)
            angles.append(math.atan2(d[2], d[1]))
        diffs = np.abs(np.diff(np.unwrap(angles)))
        assert np.max(diffs) < 0.45

    def test_straight_line_cubic_no_samples(self):
        # Degenerate: collinear control points → tangent never turns.
        control = cps((0, 0), (1, 0), (2, 0), (3, 0))
        pb = curve.rational_cubic_control_points_to_power_basis(control)
        params = curve.integral_cubic_uniform_tangent_angle(pb, 0.1)
        assert params[-1] == 1.0


class TestUniformArcLength:
    def test_quarter_circle_spacing(self):
        """Samples of a rational-quadratic quarter circle are evenly
        spaced in arc length (the approximation the reference plans at
        path.rs:162-166)."""
        from contrast_renderer.curve import (
            rational_quadratic_control_points_to_power_basis,
            rational_quadratic_point,
            uniform_arc_length_parameters,
        )
        from contrast_renderer.utils import ga2d

        w = 1.0 / math.sqrt(2.0)
        cps = np.stack([
            ga2d.vec_to_point((1.0, 0.0)),
            ga2d.weighted_vec_to_point(w, (1.0, 1.0)),
            ga2d.vec_to_point((0.0, 1.0)),
        ])
        pb = rational_quadratic_control_points_to_power_basis(cps)
        step = 0.1
        params = uniform_arc_length_parameters(pb, rational_quadratic_point, step)
        assert params[-1] == 1.0
        pts = [np.array([1.0, 0.0])]
        pts += [
            ga2d.point_to_vec(rational_quadratic_point(pb, t)) for t in params
        ]
        dists = [np.linalg.norm(b - a) for a, b in zip(pts, pts[1:])]
        arc = math.pi / 2
        n = len(params)
        assert abs(n - round(arc / step)) <= 1
        # Chord lengths all within 5% of each other.
        assert max(dists) / min(dists) < 1.05
        # All samples on the unit circle.
        for p in pts:
            assert abs(np.linalg.norm(p) - 1.0) < 1e-3

    def test_short_curve_single_parameter(self):
        from contrast_renderer.curve import (
            rational_quadratic_control_points_to_power_basis,
            rational_quadratic_point,
            uniform_arc_length_parameters,
        )
        from contrast_renderer.utils import ga2d

        cps = np.stack([
            ga2d.vec_to_point((0.0, 0.0)),
            ga2d.vec_to_point((0.1, 0.1)),
            ga2d.vec_to_point((0.2, 0.0)),
        ])
        pb = rational_quadratic_control_points_to_power_basis(cps)
        assert uniform_arc_length_parameters(
            pb, rational_quadratic_point, 10.0
        ) == [1.0]

    def test_stroke_builder_accepts_arc_length(self):
        from contrast_renderer.path import (
            CurveApproximation, Path, StrokeOptions)
        from contrast_renderer.stroke import StrokeBuilder

        p = Path.from_circle((0.0, 0.0), 5.0)
        p.stroke_options = StrokeOptions(
            width=0.5,
            closed=True,
            curve_approximation=CurveApproximation.uniform_arc_length(0.5),
        )
        b = StrokeBuilder()
        hull = []
        b.add_path(hull, p)
        t = b.build()
        assert len(t) > 40  # circumference ~31.4 / 0.5 step -> ~63 samples
