"""Unit tests for the polynomial solvers (utils.polynomial)."""

import numpy as np

from contrast_renderer.utils import polynomial as poly

EPS = 1e-4


def real_values(roots):
    return sorted(r.real for r in roots if r.is_finite and abs(r.numerator.imag) < 1e-9)


class TestLinear:
    def test_simple(self):
        _, roots = poly.solve_linear((-6.0, 2.0), EPS)
        assert real_values(roots) == [3.0]

    def test_degenerate(self):
        _, roots = poly.solve_linear((1.0, 0.0), EPS)
        assert roots == []


class TestQuadratic:
    def test_two_real(self):
        # (t-1)(t-3) = 3 - 4t + t²
        disc, roots = poly.solve_quadratic((3.0, -4.0, 1.0), EPS)
        assert disc > 0
        assert np.allclose(real_values(roots), [1.0, 3.0])

    def test_double_root(self):
        # (t-2)² = 4 - 4t + t²
        disc, roots = poly.solve_quadratic((4.0, -4.0, 1.0), EPS)
        assert abs(disc) <= EPS
        assert len(roots) == 1
        assert np.isclose(roots[0].real, 2.0)

    def test_complex_pair(self):
        # t² + 1
        disc, roots = poly.solve_quadratic((1.0, 0.0, 1.0), EPS)
        assert disc < 0
        assert len(roots) == 2
        assert real_values(roots) == []  # no real roots
        assert np.isclose(roots[0].numerator.imag / roots[0].denominator, 1.0)

    def test_degrades_to_linear(self):
        _, roots = poly.solve_quadratic((-6.0, 2.0, 0.0), EPS)
        assert np.allclose(real_values(roots), [3.0])

    def test_catastrophic_cancellation_stability(self):
        # Roots 1e-8 and 1e8: naive formula loses the small root.
        c0, c1, c2 = 1.0, -(1e8 + 1e-8), 1.0
        _, roots = poly.solve_quadratic((c0, c1, c2), 0.0)
        vals = real_values(roots)
        assert np.isclose(min(vals), 1e-8, rtol=1e-6)
        assert np.isclose(max(vals), 1e8, rtol=1e-6)


class TestCubic:
    def test_three_real(self):
        # (t-1)(t-2)(t-3) = -6 + 11t - 6t² + t³
        disc, roots, _ = poly.solve_cubic((-6.0, 11.0, -6.0, 1.0), EPS)
        assert disc > 0
        assert np.allclose(real_values(roots), [1.0, 2.0, 3.0])

    def test_one_real(self):
        # (t-2)(t²+1) = -2 + t - 2t² + t³
        disc, roots, real_index = poly.solve_cubic((-2.0, 1.0, -2.0, 1.0), EPS)
        assert disc < 0
        assert np.isclose(roots[real_index].real, 2.0)
        assert abs(roots[real_index].numerator.imag) < 1e-9

    def test_repeated(self):
        # (t-1)²(t-4) = -4 + 9t - 6t² + t³ → discriminant 0
        disc, roots, _ = poly.solve_cubic((-4.0, 9.0, -6.0, 1.0), EPS)
        assert abs(disc) < 1e-9
        assert np.allclose(real_values(roots), [1.0, 1.0, 4.0], atol=1e-5)

    def test_degrades_to_quadratic_with_infinite_root(self):
        disc, roots, _ = poly.solve_cubic((3.0, -4.0, 1.0, 0.0), EPS)
        assert len(roots) == 3
        assert sum(not r.is_finite for r in roots) == 1
        assert np.allclose(real_values(roots), [1.0, 3.0])


class TestQuartic:
    def test_four_real(self):
        # (t² - 1)(t² - 4) = 4 - 5t² + t⁴
        _, roots = poly.solve_quartic((4.0, 0.0, -5.0, 0.0, 1.0), EPS)
        assert np.allclose(real_values(roots), [-2.0, -1.0, 1.0, 2.0])

    def test_mixed(self):
        # (t - 0.5)(t + 3)(t² + 1)
        c = np.polynomial.polynomial.polyfromdomain = None  # noqa
        # Expand: (t² + 2.5t - 1.5)(t² + 1) = t⁴ + 2.5t³ - 0.5t² + 2.5t - 1.5
        _, roots = poly.solve_quartic((-1.5, 2.5, -0.5, 2.5, 1.0), EPS)
        vals = real_values(roots)
        assert np.allclose(vals, [-3.0, 0.5])
        in_unit = poly.real_roots_in_unit_interval(roots)
        assert np.allclose(in_unit, [0.5])

    def test_degrades(self):
        _, roots = poly.solve_quartic((-6.0, 11.0, -6.0, 1.0, 0.0), EPS)
        assert np.allclose(real_values(roots), [1.0, 2.0, 3.0])
