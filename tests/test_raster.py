"""Device (JAX) rasterizer vs the scalar oracle and ground truth."""

import numpy as np
import pytest

from contrast_renderer import oracle
from contrast_renderer.fill import FillBuilder
from contrast_renderer.ops import raster
from contrast_renderer.path import (
    IntegralCubicCurveSegment,
    LineSegment,
    Path,
)

SIZE = 128


def build_table(paths):
    builder = FillBuilder()
    hull = []
    for p in paths:
        builder.add_path(hull, p)
    return builder.build()


def default_transform(width, height):
    t = np.diag([2.0 / width, 2.0 / height, 1.0, 1.0]).astype(np.float32)
    t[0, 3] = -1.0
    t[1, 3] = -1.0
    return t


def device_winding(table, width=SIZE, height=SIZE, **kw):
    rasterize = raster.make_fill_rasterizer(width, height, **kw)
    winding, max_count = rasterize(
        table.xy, table.aux, table.kind, table.meta, default_transform(width, height)
    )
    return np.asarray(winding), int(max_count)


@pytest.mark.slow  # oracle batteries; golden-image smoke stays in the fast gate
class TestDeviceMatchesOracle:
    @pytest.mark.parametrize(
        "make",
        [
            lambda: Path.from_rect((64, 64), (40, 30)),
            lambda: Path.from_circle((64, 64), 45),
            lambda: Path.from_rounded_rect((64, 64), (45, 30), 12),
        ],
        ids=["rect", "circle", "rounded_rect"],
    )
    @pytest.mark.parametrize("orient", ["forward", "reverse"])
    def test_winding_matches_oracle(self, make, orient):
        p = make()
        if orient == "reverse":
            p.reverse()
        table = build_table([p])
        got, max_count = device_winding(table)
        assert max_count <= 256
        want = oracle.rasterize_fill_table(table, SIZE, SIZE)
        mismatch = np.mean(got != want)
        assert mismatch < 5e-4, f"device/oracle mismatch {mismatch}"

    def test_cubic_battery(self):
        p = Path(start=(16, 40))
        p.push_integral_cubic_curve(
            IntegralCubicCurveSegment([(40, 120), (90, 120), (112, 40)])
        )
        p.push_line(LineSegment([(16, 40)]))
        table = build_table([p])
        got, _ = device_winding(table)
        want = oracle.rasterize_fill_table(table, SIZE, SIZE)
        assert np.mean(got != want) < 5e-4

    def test_matches_ground_truth_config1(self):
        """BASELINE.json config 1: filled circle at 256², nonzero winding,
        coverage error vs the scalar oracle ≤ 1e-3."""
        size = 256
        p = Path.from_circle((128, 128), 100)
        table = build_table([p])
        got, _ = device_winding(table, width=size, height=size)
        positions = oracle.sample_positions(size, size)

        def m2p(pts):
            out = pts.copy()
            out[:, 1] = size - out[:, 1]
            return out

        truth = oracle.ground_truth_winding([p], positions, m2p, 512)
        coverage_got = oracle.coverage_from_winding(got)
        coverage_truth = oracle.coverage_from_winding(truth)
        err = np.mean(coverage_got != coverage_truth)
        assert err <= 1e-3, f"mean coverage error {err}"

    def test_even_odd_winding(self):
        # Two concentric circles SAME orientation: even-odd (1 winding
        # bit) punches a hole; nonzero with 4 bits does not.
        outer = Path.from_circle((64, 64), 50)
        inner = Path.from_circle((64, 64), 25)
        table = build_table([outer, inner])
        got, _ = device_winding(table)
        cov_eo = oracle.coverage_from_winding(got, winding_bits=1)
        cov_nz = oracle.coverage_from_winding(got, winding_bits=4)
        assert not cov_eo[64, 64].any()  # hole
        assert cov_nz[64, 64].all()  # filled
        assert cov_eo[64, 25].all() and cov_nz[64, 25].all()

    def test_tile_capacity_overflow_reported(self):
        paths = [Path.from_circle((64, 64), 40 - i) for i in range(20)]
        table = build_table(paths)
        _, max_count = device_winding(table, capacity=8)
        assert max_count > 8  # host can detect and re-run with more capacity

    def test_composite(self):
        p = Path.from_circle((64, 64), 40)
        table = build_table([p])
        got, _ = device_winding(table)
        coverage = raster.resolve_coverage(got)
        img = np.asarray(
            raster.composite_color(coverage, np.array([1.0, 0.0, 0.0, 0.5]))
        )
        assert img.shape == (SIZE, SIZE, 4)
        assert np.allclose(img[64, 64], [0.5, 0, 0, 0.5])
        assert np.allclose(img[2, 2], 0.0)
        # Edge pixels are partially covered (MSAA resolve).
        frac = img[..., 3]
        assert ((frac > 0.05) & (frac < 0.95)).sum() > 50
