"""Unit tests for the geometric algebra foundation (utils.ga2d/ga3d/matrix).

Golden values are closed-form geometry facts, mirroring behaviors the
reference relies on (src/utils.rs, src/safe_float.rs conventions).
"""

import numpy as np
import pytest

from contrast_renderer.utils import ga2d, ga3d, matrix


class TestPointsLines:
    def test_point_roundtrip(self):
        p = ga2d.vec_to_point([3.0, -2.0])
        assert np.allclose(p, [1.0, 3.0, -2.0])
        assert np.allclose(ga2d.point_to_vec(p), [3.0, -2.0])

    def test_weighted_point(self):
        p = ga2d.weighted_vec_to_point(2.0, [3.0, -2.0])
        assert np.allclose(p, [2.0, 6.0, -4.0])
        assert np.allclose(ga2d.point_to_vec(p), [3.0, -2.0])

    def test_join_line_through_points(self):
        a = ga2d.vec_to_point([0.0, 0.0])
        b = ga2d.vec_to_point([1.0, 0.0])
        l = ga2d.join(a, b)
        # Line y=0: both points incident.
        assert abs(ga2d.point_line(a, l)) < 1e-12
        assert abs(ga2d.point_line(b, l)) < 1e-12
        # Direction (b_dir, -a_dir) = +x; normal (a, b) = +y.
        ln = ga2d.signum(l)
        assert np.allclose([ln[2], -ln[1]], [1.0, 0.0])
        assert np.allclose([ln[1], ln[2]], [0.0, 1.0])

    def test_triple_ccw_positive(self):
        a = ga2d.vec_to_point([0.0, 0.0])
        b = ga2d.vec_to_point([1.0, 0.0])
        c = ga2d.vec_to_point([0.0, 1.0])
        assert ga2d.triple(a, b, c) > 0  # counterclockwise
        assert ga2d.triple(a, c, b) < 0  # clockwise
        # Twice the signed area.
        assert np.isclose(ga2d.triple(a, b, c), 1.0)

    def test_join_magnitude_is_distance(self):
        a = ga2d.vec_to_point([1.0, 2.0])
        b = ga2d.vec_to_point([4.0, 6.0])
        assert np.isclose(ga2d.magnitude(ga2d.join(a, b)), 5.0)
        assert np.isclose(ga2d.squared_magnitude(ga2d.join(a, b)), 25.0)

    def test_line_line_intersection(self):
        a = ga2d.join(ga2d.vec_to_point([0, 0]), ga2d.vec_to_point([2, 2]))
        b = ga2d.join(ga2d.vec_to_point([0, 2]), ga2d.vec_to_point([2, 0]))
        p = ga2d.line_line_intersection(a, b)
        assert np.allclose(ga2d.point_to_vec(p), [1.0, 1.0])

    def test_inner_outer_angles(self):
        t0 = ga2d.signum(ga2d.join(ga2d.vec_to_point([0, 0]), ga2d.vec_to_point([1, 0])))
        t90 = ga2d.signum(ga2d.join(ga2d.vec_to_point([0, 0]), ga2d.vec_to_point([0, 1])))
        t45 = ga2d.signum(ga2d.join(ga2d.vec_to_point([0, 0]), ga2d.vec_to_point([1, 1])))
        assert np.isclose(ga2d.inner_ll(t0, t90), 0.0, atol=1e-12)
        assert np.isclose(ga2d.inner_ll(t0, t45), np.cos(np.pi / 4))
        # outer sign: left turn positive
        assert ga2d.outer_ll(t0, t90) > 0
        assert ga2d.outer_ll(t90, t0) < 0

    def test_rotate_90_cw(self):
        # Line along +x direction; rotated 90° CW → direction -y.
        l = ga2d.signum(ga2d.join(ga2d.vec_to_point([0, 0]), ga2d.vec_to_point([1, 0])))
        r = ga2d.rotate_90_degree_clockwise(l)
        direction = [r[2], -r[1]]
        assert np.allclose(direction, [0.0, -1.0])

    def test_line_through_point_with_direction(self):
        d = ga2d.signum(ga2d.join(ga2d.vec_to_point([0, 0]), ga2d.vec_to_point([1, 2])))
        p = ga2d.vec_to_point([5.0, -1.0])
        l = ga2d.line_through_point_with_direction(d, p)
        assert abs(ga2d.point_line(p, l)) < 1e-12
        # Same direction components.
        assert np.allclose(l[1:], d[1:])


class TestMotors:
    def test_translate(self):
        m = ga2d.translate2d([3.0, -4.0])
        p = ga2d.motor_apply(m, ga2d.vec_to_point([1.0, 1.0]))
        assert np.allclose(ga2d.point_to_vec(p), [4.0, -3.0])
        assert np.allclose(ga2d.translation2d(m), [3.0, -4.0])
        assert np.isclose(ga2d.rotation2d(m), 0.0)

    def test_rotate_ccw(self):
        m = ga2d.rotate2d(np.pi / 2)
        p = ga2d.motor_apply(m, ga2d.vec_to_point([1.0, 0.0]))
        assert np.allclose(ga2d.point_to_vec(p), [0.0, 1.0], atol=1e-12)
        assert np.isclose(ga2d.rotation2d(m), np.pi / 2)

    def test_composition_order(self):
        rot = ga2d.rotate2d(np.pi / 2)
        tra = ga2d.translate2d([1.0, 0.0])
        # product(tra, rot): rotate first, then translate.
        m = ga2d.motor_product(tra, rot)
        p = ga2d.motor_apply(m, ga2d.vec_to_point([1.0, 0.0]))
        assert np.allclose(ga2d.point_to_vec(p), [1.0, 1.0], atol=1e-12)
        # product(rot, tra): translate first, then rotate.
        m2 = ga2d.motor_product(rot, tra)
        p2 = ga2d.motor_apply(m2, ga2d.vec_to_point([1.0, 0.0]))
        assert np.allclose(ga2d.point_to_vec(p2), [0.0, 2.0], atol=1e-12)

    def test_translation_extraction_of_composite(self):
        m = ga2d.motor_product(ga2d.translate2d([2.0, 5.0]), ga2d.rotate2d(1.1))
        assert np.isclose(ga2d.rotation2d(m), 1.1)
        assert np.allclose(ga2d.translation2d(m), [2.0, 5.0])

    def test_motor2d_to_mat3_matches_apply(self):
        m = ga2d.motor_product(ga2d.translate2d([2.0, -1.0]), ga2d.rotate2d(0.7))
        mat = ga2d.motor2d_to_mat3(m)
        # Path.transform formula (reference path.rs:391-397):
        # out = mat[2][:2] + x*mat[0][:2] + y*mat[1][:2]
        p = np.array([0.3, -0.9])
        via_mat = mat[2, :2] + p[0] * mat[0, :2] + p[1] * mat[1, :2]
        via_apply = ga2d.point_to_vec(ga2d.motor_apply(m, ga2d.vec_to_point(p)))
        assert np.allclose(via_mat, via_apply)


class TestConvexPolygons:
    def test_sat_overlap(self):
        a = ga2d.aabb_to_convex_polygon([0.0, 0.0, 2.0, 2.0])
        b = ga2d.aabb_to_convex_polygon([1.0, 1.0, 3.0, 3.0])
        c = ga2d.aabb_to_convex_polygon([2.5, 2.5, 4.0, 4.0])
        assert ga2d.do_convex_polygons_overlap(a, b)
        assert not ga2d.do_convex_polygons_overlap(a, c)
        assert ga2d.do_convex_polygons_overlap(a, a)


class TestGa3d:
    def test_join3_plane_through_points(self):
        pts = np.array(
            [
                [1.0, 0.0, 0.0, 0.0],
                [1.0, 1.0, 0.0, 1.0],
                [1.0, 0.0, 1.0, 2.0],
            ]
        )
        plane = ga3d.join3(pts[0], pts[1], pts[2])
        for p in pts:
            assert abs(np.dot(plane, p)) < 1e-12
        # Normalize like weight_planes (reference fill.rs:81): v-coefficient -1.
        plane = plane / -plane[3]
        # v(x, y) = c + a x + b y with v(0,0)=0, v(1,0)=1, v(0,1)=2.
        c, a, b = plane[0], plane[1], plane[2]
        assert np.isclose(c, 0.0)
        assert np.isclose(a, 1.0)
        assert np.isclose(b, 2.0)

    def test_normalize4(self):
        v = ga3d.normalize4([3.0, 0.0, 4.0, 0.0])
        assert np.allclose(v, [0.6, 0.0, 0.8, 0.0])


class TestMatrix:
    def test_translator_roundtrip(self):
        m = matrix.translator3d([1.0, -2.0, 3.0])
        assert np.allclose(matrix.motor3d_translation(m), [1.0, -2.0, 3.0])

    def test_rotor_mat4(self):
        q = matrix.rotate_around_axis(np.pi / 2, [0.0, 0.0, 1.0])
        mat = matrix.motor3d_to_mat4(matrix.rotor_to_motor3d(q))
        v = matrix.apply_mat4(mat, [1.0, 0.0, 0.0, 1.0])
        assert np.allclose(v, [0.0, 1.0, 0.0, 1.0], atol=1e-12)

    def test_motor_product_translation_then_rotation(self):
        t = matrix.translator3d([5.0, 0.0, 0.0])
        r = matrix.rotor_to_motor3d(matrix.rotate_around_axis(np.pi / 2, [0, 0, 1]))
        # t∘r: rotate then translate.
        m = matrix.motor3d_product(t, r)
        mat = matrix.motor3d_to_mat4(m)
        v = matrix.apply_mat4(mat, [1.0, 0.0, 0.0, 1.0])
        assert np.allclose(v, [5.0, 1.0, 0.0, 1.0], atol=1e-12)

    def test_perspective(self):
        proj = matrix.perspective_projection(np.pi / 2, 1.0, 1.0, 1000.0)
        v = matrix.apply_mat4(proj, [0.0, 0.0, 1.0, 1.0])  # at near plane
        ndc = v[:3] / v[3]
        assert np.isclose(ndc[2], 0.0, atol=1e-5)
        v = matrix.apply_mat4(proj, [0.0, 0.0, 1000.0, 1.0])  # at far plane
        ndc = v[:3] / v[3]
        assert np.isclose(ndc[2], 1.0, atol=1e-5)

    def test_matmul_matches_composition(self):
        a = matrix.motor3d_to_mat4(matrix.translator3d([1.0, 2.0, 3.0]))
        b = matrix.motor3d_to_mat4(
            matrix.rotor_to_motor3d(matrix.rotate_around_axis(0.3, [0, 1, 0]))
        )
        ab = matrix.matrix_multiplication(a, b)
        v = np.array([0.5, -0.5, 2.0, 1.0])
        assert np.allclose(
            matrix.apply_mat4(ab, v), matrix.apply_mat4(a, matrix.apply_mat4(b, v))
        )
