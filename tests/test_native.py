"""Native (C++) geometry kernels match the pure-Python implementations."""

import numpy as np
import pytest

from contrast_renderer import curve as curvemod
from contrast_renderer import native
from contrast_renderer.convex_hull import andrew
from contrast_renderer.utils import ga2d

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no C++ toolchain"
)


def test_eval_rational_quadratic_matches_python():
    rng = np.random.default_rng(0)
    cps = rng.normal(size=(5, 3, 2)) * 10
    weights = rng.uniform(0.5, 2.0, size=(5, 3))
    weights[:, 0] = 1.0
    weights[:, 2] = 1.0
    pbs = []
    for i in range(5):
        h = np.concatenate([weights[i][:, None], cps[i] * weights[i][:, None]], axis=1)
        pbs.append(curvemod.rational_quadratic_control_points_to_power_basis(h))
    pbs = np.stack(pbs)
    ts = np.linspace(0, 1, 9)
    got = native.eval_rational_quadratic(pbs, ts)
    for i in range(5):
        want = ga2d.point_to_vec(curvemod.rational_quadratic_point(pbs[i], ts))
        assert np.allclose(got[i], want)


def test_eval_rational_cubic_matches_python():
    rng = np.random.default_rng(1)
    cps = rng.normal(size=(4, 4, 2)) * 10
    pbs = []
    for i in range(4):
        h = np.concatenate([np.ones((4, 1)), cps[i]], axis=1)
        pbs.append(curvemod.rational_cubic_control_points_to_power_basis(h))
    pbs = np.stack(pbs)
    ts = np.linspace(0, 1, 7)
    got = native.eval_rational_cubic(pbs, ts)
    for i in range(4):
        want = ga2d.point_to_vec(curvemod.rational_cubic_point(pbs[i], ts))
        assert np.allclose(got[i], want)


def test_polyline_arc_length():
    pts = np.array([[0, 0], [3, 4], [3, 4], [6, 8]], dtype=float)
    got = native.polyline_arc_length(pts)
    assert np.allclose(got, [0, 5, 5, 10])


def test_convex_hull_matches_python():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(200, 2)) * 50
    got = native.convex_hull(pts)
    want = andrew(pts)
    assert len(got) == len(want)
    # Same cyclic order (both CCW from lexicographic minimum).
    assert np.allclose(got, want)


def test_tessellate_quadratic_paths_matches_fill_builder():
    from contrast_renderer.fill import FillBuilder
    from contrast_renderer.path import (
        IntegralQuadraticCurveSegment,
        LineSegment,
        Path,
    )

    def make_path():
        p = Path(start=(0.0, 0.0))
        p.push_line(LineSegment([(10.0, 0.0)]))
        p.push_integral_quadratic_curve(
            IntegralQuadraticCurveSegment([(12.0, 5.0), (10.0, 10.0)])
        )
        p.push_line(LineSegment([(0.0, 10.0)]))
        return p

    paths = [make_path(), make_path().transform(1.0, ga2d.translate2d([20.0, 0.0]))]
    # Native packing.
    offsets = [0]
    starts, kinds, points = [], [], []
    for p in paths:
        starts.append(p.start)
        for segment_type, segment in p.iter_segments():
            cps = segment.control_points
            if len(cps) == 1:
                kinds.append(0)
                points.append([cps[0][0], cps[0][1], 0.0, 0.0])
            else:
                kinds.append(1)
                points.append([cps[0][0], cps[0][1], cps[1][0], cps[1][1]])
        offsets.append(len(kinds))
    solid_xy, curve_xy, curve_aux, hull_pts = native.tessellate_quadratic_paths(
        np.array(offsets), np.array(starts), np.array(kinds), np.array(points)
    )
    builder = FillBuilder()
    hull = []
    for p in paths:
        builder.add_path(hull, p)
    table = builder.build()
    want_solid = table.xy[table.kind == 0]
    want_curve = table.xy[table.kind == 1]
    want_aux = table.aux[table.kind == 1][:, :, :3]
    assert solid_xy.shape == want_solid.shape
    assert np.allclose(np.sort(solid_xy.reshape(-1)), np.sort(want_solid.reshape(-1)))
    assert np.allclose(curve_xy, want_curve)
    assert np.allclose(curve_aux, want_aux)
    assert len(hull_pts) == len(hull)
