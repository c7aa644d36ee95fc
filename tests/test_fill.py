"""Fill tessellation correctness: scalar-oracle rasterization of the
triangle tables must reproduce ground-truth polyline winding for a
battery of shapes in BOTH path orientations (the reference's cubic
classification cases fill.rs:51-68: serpentine, loop, cusp)."""

import math

import numpy as np
import pytest

from contrast_renderer import oracle
from contrast_renderer.fill import FillBuilder
from contrast_renderer.path import (
    IntegralCubicCurveSegment,
    IntegralQuadraticCurveSegment,
    LineSegment,
    Path,
    RationalCubicCurveSegment,
)

SIZE = 96  # raster resolution for tests (model space = pixel space here)


def check_fill(paths, mismatch_budget=1e-3, size=SIZE):
    builder = FillBuilder()
    hull = []
    for p in paths:
        builder.add_path(hull, p)
    table = builder.build()
    assert len(table) > 0
    positions = oracle.sample_positions(size, size)

    def model_to_pixel(pts):
        # identity in x; pixel y-down flip to mirror the oracle's viewport
        out = pts.copy()
        out[:, 1] = size - out[:, 1]
        return out

    truth = oracle.ground_truth_winding(
        paths, positions, model_to_pixel, steps_per_curve=512
    )
    got = oracle.rasterize_fill_table(table, size, size)
    mismatch = np.mean(got != truth)
    assert mismatch <= mismatch_budget, (
        f"winding mismatch fraction {mismatch:.5f} "
        f"(max |diff| {np.max(np.abs(got - truth))})"
    )
    return got, truth


def both_orientations(make_path):
    forward = make_path()
    reverse = make_path()
    reverse.reverse()
    return [("forward", forward), ("reverse", reverse)]


class TestSolidPolygons:
    @pytest.mark.parametrize("orient", ["forward", "reverse"])
    def test_rect(self, orient):
        p = Path.from_rect((48, 48), (30, 20))
        if orient == "reverse":
            p.reverse()
        check_fill([p])

    @pytest.mark.parametrize("orient", ["forward", "reverse"])
    def test_concave_polygon(self, orient):
        p = Path.from_polygon(
            [(10, 10), (86, 10), (86, 86), (48, 40), (10, 86)]
        )
        if orient == "reverse":
            p.reverse()
        check_fill([p])

    def test_self_intersecting_star_nonzero(self):
        # 5-pointed star drawn as a pentagram: winding 2 in the core.
        pts = []
        for i in range(5):
            a = math.pi / 2 + i * 4 * math.pi / 5
            pts.append((48 + 36 * math.cos(a), 48 + 36 * math.sin(a)))
        p = Path.from_polygon(pts)
        check_fill([p])


class TestQuadratics:
    @pytest.mark.parametrize("orient", ["forward", "reverse"])
    def test_quadratic_blob(self, orient):
        p = Path(start=(20, 30))
        p.push_integral_quadratic_curve(
            IntegralQuadraticCurveSegment([(48, 90), (80, 30)])
        )
        p.push_line(LineSegment([(20, 30)]))
        if orient == "reverse":
            p.reverse()
        check_fill([p])

    @pytest.mark.parametrize("orient", ["forward", "reverse"])
    def test_circle(self, orient):
        p = Path.from_circle((48, 48), 35)
        if orient == "reverse":
            p.reverse()
        check_fill([p])

    @pytest.mark.parametrize("orient", ["forward", "reverse"])
    def test_ring_with_hole(self, orient):
        outer = Path.from_circle((48, 48), 40)
        inner = Path.from_circle((48, 48), 20)
        inner.reverse()
        if orient == "reverse":
            outer.reverse()
            inner.reverse()
        got, truth = check_fill([outer, inner])
        # Center must be a hole.
        assert truth[48, 48].sum() == 0
        assert got[48, 48].sum() == 0


class TestCubics:
    @pytest.mark.parametrize("orient", ["forward", "reverse"])
    def test_cubic_arch(self, orient):
        p = Path(start=(12, 30))
        p.push_integral_cubic_curve(
            IntegralCubicCurveSegment([(30, 88), (66, 88), (84, 30)])
        )
        p.push_line(LineSegment([(12, 30)]))
        if orient == "reverse":
            p.reverse()
        check_fill([p])

    @pytest.mark.parametrize("orient", ["forward", "reverse"])
    def test_cubic_s_curve(self, orient):
        # Serpentine whose curve crosses its chord.
        p = Path(start=(10, 48))
        p.push_integral_cubic_curve(
            IntegralCubicCurveSegment([(40, 95), (56, 1), (86, 48)])
        )
        p.push_line(LineSegment([(86, 80)]))
        p.push_line(LineSegment([(10, 80)]))
        if orient == "reverse":
            p.reverse()
        check_fill([p])

    @pytest.mark.parametrize("orient", ["forward", "reverse"])
    def test_cubic_loop(self, orient):
        # Self-intersecting loop cubic.
        p = Path(start=(20, 25))
        p.push_integral_cubic_curve(
            IntegralCubicCurveSegment([(85, 80), (5, 80), (76, 25)])
        )
        p.push_line(LineSegment([(20, 25)]))
        if orient == "reverse":
            p.reverse()
        check_fill([p])

    @pytest.mark.parametrize("orient", ["forward", "reverse"])
    def test_cubic_cusp(self, orient):
        # Near-cusp: control points arranged symmetrically.
        p = Path(start=(15, 30))
        p.push_integral_cubic_curve(
            IntegralCubicCurveSegment([(80, 85), (16, 85), (81, 30)])
        )
        p.push_line(LineSegment([(15, 30)]))
        if orient == "reverse":
            p.reverse()
        check_fill([p])

    @pytest.mark.parametrize("orient", ["forward", "reverse"])
    def test_rational_cubic(self, orient):
        p = Path(start=(15, 35))
        p.push_rational_cubic_curve(
            RationalCubicCurveSegment(
                [1.0, 1.6, 1.6, 1.0], [(30, 90), (66, 90), (81, 35)]
            )
        )
        p.push_line(LineSegment([(15, 35)]))
        if orient == "reverse":
            p.reverse()
        check_fill([p])

    @pytest.mark.parametrize("orient", ["forward", "reverse"])
    def test_mixed_segments(self, orient):
        p = Path(start=(15, 20))
        p.push_integral_cubic_curve(
            IntegralCubicCurveSegment([(35, 70), (60, 75), (80, 40)])
        )
        p.push_integral_quadratic_curve(
            IntegralQuadraticCurveSegment([(88, 70), (60, 88)])
        )
        p.push_line(LineSegment([(30, 88)]))
        if orient == "reverse":
            p.reverse()
        check_fill([p])


class TestDegenerateCubic:
    @pytest.mark.parametrize("orient", ["forward", "reverse"])
    def test_near_linear_cubic_infinite_planes(self, orient):
        """Regression: BASELINE config-2 corpus path #167 (rng seed 0).

        A numerically near-linear cubic whose Loop-Blinn implicit
        weights land at the classification boundary: weight_planes
        returns ±inf/NaN rows, so the side-normalization decision
        variable is NaN for every probe.  The build must stay
        warning-clean (the NaN arithmetic is explicitly masked in
        normalize_implicit_curve_side), keep the no-flip fallback, and
        emit finite tables — the r06 sweep's un-silenced
        "invalid value encountered in add" came from this curve."""
        import warnings

        p = Path(start=(402.6970202792566, 413.9183782437625))
        p.push_integral_cubic_curve(
            IntegralCubicCurveSegment([
                (417.58446498, 413.78440366),
                (416.41297074, 419.16903586),
                (404.24044664, 408.67806945),
            ])
        )
        p.push_line(LineSegment([(402.6970202792566, 413.9183782437625)]))
        if orient == "reverse":
            p.reverse()
        builder = FillBuilder()
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            builder.add_path([], p)
            table = builder.build()
        assert len(table) > 0
        assert np.all(np.isfinite(table.xy))
        assert np.all(np.isfinite(table.aux))


class TestRoundedRect:
    @pytest.mark.parametrize("orient", ["forward", "reverse"])
    def test_rounded_rect(self, orient):
        p = Path.from_rounded_rect((48, 48), (35, 25), 10)
        if orient == "reverse":
            p.reverse()
        check_fill([p])


class TestOuterPolygon:
    def test_containment_and_area_bound(self):
        """The decimated cover polygon contains the hull with bounded
        area overshoot (cover regions may be supersets — painting is
        winding-gated)."""
        from contrast_renderer.convex_hull import andrew, outer_polygon

        rng = np.random.default_rng(0)

        def area(p):
            x, y = p[:, 0], p[:, 1]
            return 0.5 * abs(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))

        for _ in range(50):
            pts = rng.normal(size=(50, 2)) * rng.uniform(0.1, 100)
            hull = andrew(pts)
            poly = outer_polygon(hull, 16)
            assert len(poly) <= 16
            n = len(poly)
            for j in range(n):
                a, b = poly[j], poly[(j + 1) % n]
                e = (b[0] - a[0]) * (hull[:, 1] - a[1]) - (
                    b[1] - a[1]
                ) * (hull[:, 0] - a[0])
                assert (e >= -1e-6 * max(1, np.abs(poly).max())).all()
            if len(hull) >= 3 and area(hull) > 1e-9:
                assert area(poly) <= area(hull) * 1.30

    def test_small_hulls_unchanged(self):
        from contrast_renderer.convex_hull import outer_polygon

        tri = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
        assert np.array_equal(outer_polygon(tri, 16), tri)


class TestHullPrefilter:
    def test_large_input_prune_matches_unpruned_chain(self):
        """The >1024-point interior prune must not change the hull."""
        from contrast_renderer.convex_hull import andrew

        rng = np.random.default_rng(7)
        for scale in (1.0, 300.0):
            pts = rng.normal(size=(5000, 2)) * scale
            # Duplicate some extremes to stress dedup.
            pts = np.concatenate([pts, pts[np.argmax(pts, axis=0)]])
            hull = andrew(pts)
            small = andrew(hull)  # hull of a hull is itself
            assert len(hull) >= 3
            assert np.allclose(hull, small)
            # Every input point is inside (or on) the hull.
            a = hull
            b = np.roll(hull, -1, axis=0)
            e = (b[:, 0] - a[:, 0])[None, :] * (
                pts[:, 1:2] - a[:, 1][None, :]
            ) - (b[:, 1] - a[:, 1])[None, :] * (
                pts[:, 0:1] - a[:, 0][None, :]
            )
            assert (e >= -1e-6 * scale * scale).all()
