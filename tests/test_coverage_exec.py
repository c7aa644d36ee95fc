"""Round-2 executor tests: capacity growth, MSAA generality, finite
validation, clip × opacity-group interplay, and cubic fills against
analytic (polyline) ground truth rather than the scalar oracle."""

import numpy as np
import pytest

from contrast_renderer.path import (
    IntegralCubicCurveSegment,
    LineSegment,
    Path,
)
from contrast_renderer.renderer import (
    Configuration,
    DrawCommand,
    RenderOperation,
    Renderer,
    Shape,
)

SIZE = 64


def ortho(size=SIZE):
    t = np.diag([2.0 / size, 2.0 / size, 1.0, 1.0]).astype(np.float32)
    t[0, 3] = -1.0
    t[1, 3] = -1.0
    return t


def stencil_color(shape, transform, color):
    return [
        DrawCommand(RenderOperation.STENCIL, shape, transform),
        DrawCommand(RenderOperation.COLOR, shape, transform, color=color),
    ]


class TestCapacityGrowth:
    def test_overcapacity_scene_renders_correctly(self):
        # 20 concentric circles overlap the central tiles far beyond the
        # initial capacity; the renderer must detect the overflow and
        # regrow instead of silently dropping triangles
        # (reference contract: ops/raster.py capacity retry).
        renderer = Renderer(Configuration(), SIZE, SIZE, tile_capacity=8)
        shapes = [Shape([Path.from_circle((32, 32), 28 - i)]) for i in range(20)]
        commands = []
        for s in shapes:
            commands += stencil_color(s, ortho(), (1.0, 0.0, 0.0, 1.0))
        image = renderer.render(commands)
        assert renderer.tile_capacity > 8
        assert renderer.stats["max_tile_entries"] <= renderer.tile_capacity
        # All circles same winding: the full disc is red.
        assert np.allclose(image[32, 32], [1, 0, 0, 1], atol=1e-5)
        assert np.allclose(image[32, 32 - 26], [1, 0, 0, 1], atol=1e-5)
        assert image[1, 1, 3] == 0.0


class TestDeferredCapacity:
    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_deferred_growth_converges_next_frame(self):
        # strict_capacity=False defers the overflow check: the first
        # over-capacity frames may drop triangles; within two frames the
        # deferred counter is consumed, the buffers grow, and rendering
        # is correct (the check is non-blocking so a remote-device link
        # costs no per-frame round trip).
        renderer = Renderer(
            Configuration(), SIZE, SIZE, tile_capacity=8,
            strict_capacity=False,
        )
        shapes = [Shape([Path.from_circle((32, 32), 28 - i)]) for i in range(20)]
        commands = []
        for s in shapes:
            commands += stencil_color(s, ortho(), (1.0, 0.0, 0.0, 1.0))
        renderer.render(commands)          # may drop (capacity 8)
        image = renderer.render(commands)
        if renderer.tile_capacity <= 8:    # counter not landed yet
            image = renderer.render(commands)  # two-frame bound
        assert renderer.tile_capacity > 8
        assert np.allclose(image[32, 32], [1, 0, 0, 1], atol=1e-5)
        assert np.allclose(image[32, 32 - 26], [1, 0, 0, 1], atol=1e-5)


class TestMsaaGenerality:
    @pytest.mark.slow  # two extra full-kernel compiles (2× and 8× MSAA)
    @pytest.mark.parametrize("samples", [2, 8])
    def test_circle_coverage(self, samples):
        renderer = Renderer(
            Configuration(msaa_sample_count=samples), SIZE, SIZE
        )
        shape = Shape([Path.from_circle((32, 32), 22)])
        image = renderer.render(
            stencil_color(shape, ortho(), (0.0, 1.0, 0.0, 1.0))
        )
        # Compare coverage to the analytic disc via high-res supersampling.
        yy, xx = np.meshgrid(
            np.arange(SIZE), np.arange(SIZE), indexing="ij"
        )
        sub = np.linspace(1.0 / 8, 1.0 - 1.0 / 8, 4)
        frac = np.zeros((SIZE, SIZE))
        for oy in sub:
            for ox in sub:
                px = xx + ox
                py_model = SIZE - (yy + oy)
                frac += np.hypot(px - 32, py_model - 32) <= 22
        frac /= len(sub) ** 2
        err = np.abs(image[..., 3] - frac)
        assert err.mean() < 0.01
        # More samples, finer alpha quantization on edges.
        edge = (image[..., 3] > 0) & (image[..., 3] < 1)
        assert edge.sum() > 40

    def test_invalid_sample_count_rejected(self):
        with pytest.raises(ValueError):
            Configuration(msaa_sample_count=3)


class TestFiniteValidation:
    def test_nan_path_rejected_at_push_boundary(self):
        # SafeFloat semantics (safe_float.rs:44-52): non-finite control
        # points are rejected at Path construction.
        p = Path(start=(0.0, 0.0))
        with pytest.raises(ValueError, match="finite"):
            p.push_line(LineSegment([(float("nan"), 4.0)]))

    def test_nan_geometry_rejected_at_shape_boundary(self):
        # Defense in depth: geometry mutated to NaN after construction
        # is still caught when the Shape's triangle table is built.
        p = Path(start=(0.0, 0.0))
        p.push_line(LineSegment([(8.0, 0.0)]))
        p.push_line(LineSegment([(8.0, 8.0)]))
        p.push_line(LineSegment([(0.0, 0.0)]))
        p.line_segments[0].control_points[0, 0] = float("nan")
        with pytest.raises(ValueError, match="finite"):
            Shape([p])

    def test_inf_transform_rejected_at_render_boundary(self):
        renderer = Renderer(Configuration(), SIZE, SIZE)
        shape = Shape([Path.from_rect((32, 32), (4, 4))])
        t = ortho()
        t[0, 0] = float("inf")
        with pytest.raises(ValueError, match="finite"):
            renderer.render(
                [DrawCommand(RenderOperation.STENCIL, shape, t)]
            )


@pytest.mark.slow  # fast gate keeps one compile per feature area; full battery in CI device-slow
class TestClipInsideOpacityGroup:
    def test_clipped_content_inside_group(self):
        # The reference's nesting interplay (renderer.rs:756-861): a clip
        # established *inside* an opacity group must gate the group's
        # content, and the group opacity must still apply on restore.
        renderer = Renderer(
            Configuration(alpha_layer_count=1, blending="front_to_back"),
            SIZE,
            SIZE,
        )
        circle = Shape([Path.from_circle((32, 32), 16)])
        rect = Shape([Path.from_rect((32, 32), (26, 26))])
        cover_all = Shape([Path.from_rect((32, 32), (32, 32))])
        g = 0.5
        commands = [
            DrawCommand(
                RenderOperation.SAVE_ALPHA_CONTEXT, cover_all, ortho(),
                alpha_layer=0,
            ),
            DrawCommand(
                RenderOperation.SCALE_ALPHA_CONTEXT, cover_all, ortho(),
                color=(0, 0, 0, g),
            ),
            # Group content: a red rect clipped by the circle.
            DrawCommand(RenderOperation.STENCIL, circle, ortho()),
            DrawCommand(RenderOperation.CLIP, circle, ortho(), clip_depth=1),
            DrawCommand(
                RenderOperation.STENCIL, rect, ortho(), clip_depth=1
            ),
            DrawCommand(
                RenderOperation.COLOR, rect, ortho(),
                color=(1.0, 0.0, 0.0, 1.0), clip_depth=1,
            ),
            DrawCommand(
                RenderOperation.UNCLIP, circle, ortho(), clip_depth=0
            ),
            DrawCommand(
                RenderOperation.RESTORE_ALPHA_CONTEXT, cover_all, ortho(),
                color=(0, 0, 0, g), alpha_layer=0,
            ),
            # Behind everything: full blue.
            *stencil_color(cover_all, ortho(), (0.0, 0.0, 1.0, 1.0)),
        ]
        image = renderer.render(commands)
        # rect ∩ circle: red at group opacity g over blue.
        assert np.allclose(image[32, 32], [g, 0, 1 - g, 1.0], atol=1e-4)
        # inside rect, outside circle (clip rejected): pure blue.
        assert np.allclose(image[32, 12], [0, 0, 1, 1], atol=1e-4)
        # outside rect: pure blue.
        assert np.allclose(image[2, 2], [0, 0, 1, 1], atol=1e-4)


class TestGoldenImage:
    def test_showcase_matches_golden(self):
        # Whole-pipeline regression gate: the full showcase (fills +
        # dashed strokes + text + instancing + perspective) against a
        # stored render.  Tolerances absorb backend-boundary sample
        # flips between backends.
        import os

        from contrast_renderer.assets import font_path
        from contrast_renderer.models import showcase
        from contrast_renderer.utils.png import read_png

        golden_path = os.path.join(
            os.path.dirname(__file__), "golden", "showcase_192x108.png"
        )
        if not os.path.exists(font_path()):
            pytest.skip("OpenSans test font unavailable")
        w, h = 192, 108
        renderer = Renderer(Configuration(), w, h)
        shape = showcase.build_shape(with_text=True)
        commands = showcase.showcase_commands(shape, w, h)
        image = renderer.render(commands)
        got = (np.clip(image, 0, 1) * 255.0 + 0.5).astype(np.uint8)
        want = read_png(golden_path)
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.mean() < 1.0, diff.mean()
        assert (diff.max(axis=-1) > 32).mean() < 0.01


class TestDegenerateFrames:
    def test_covers_only_frame(self):
        # A frame with no stencil command must compile and render
        # (nothing painted: no winding anywhere).
        renderer = Renderer(Configuration(), SIZE, SIZE)
        shape = Shape([Path.from_rect((32, 32), (20, 20))])
        image = renderer.render(
            [
                DrawCommand(
                    RenderOperation.COLOR, shape, ortho(),
                    color=(1, 0, 0, 1),
                )
            ]
        )
        assert image.shape == (SIZE, SIZE, 4)
        assert image.max() == 0.0

    def test_empty_shape_renders(self):
        renderer = Renderer(Configuration(), SIZE, SIZE)
        shape = Shape([])
        image = renderer.render(
            stencil_color(shape, ortho(), (1, 0, 0, 1))
        )
        assert image.max() == 0.0


class TestShapeReuse:
    def test_update_paths_rerenders_new_geometry(self):
        # The reference recycles Shape buffers in place
        # (renderer.rs:216-227); update_paths must invalidate the
        # renderer's cached scene upload.
        renderer = Renderer(Configuration(), SIZE, SIZE)
        shape = Shape([Path.from_rect((16, 32), (8, 8))])
        red = stencil_color(shape, ortho(), (1.0, 0.0, 0.0, 1.0))
        image0 = renderer.render(red)
        assert image0[32, 16, 3] > 0.9
        assert image0[32, 48, 3] == 0.0
        shape.update_paths([Path.from_rect((48, 32), (8, 8))])
        image1 = renderer.render(red)
        assert image1[32, 48, 3] > 0.9
        assert image1[32, 16, 3] == 0.0


class TestCopyAffine:
    def test_matches_motor_transform(self):
        from contrast_renderer.path import (
            IntegralQuadraticCurveSegment, StrokeOptions)
        from contrast_renderer.utils import ga2d

        p = Path(start=(1.0, 2.0))
        p.push_line(LineSegment([(5.0, 2.0)]))
        p.push_integral_quadratic_curve(
            IntegralQuadraticCurveSegment([(7.0, 4.0), (5.0, 6.0)])
        )
        p.stroke_options = StrokeOptions(width=2.0)
        scale, offset = 3.0, (10.0, -4.0)
        fast = p.copy_affine(scale, offset)
        slow = p.copy()
        slow.transform(scale, ga2d.translate2d(list(offset)))
        assert np.allclose(fast.start, slow.start)
        for a, b in zip(fast.iter_segments(), slow.iter_segments()):
            assert np.allclose(a[1].control_points, b[1].control_points)
        assert fast.stroke_options == slow.stroke_options
        # The prototype is untouched.
        assert np.allclose(p.start, (1.0, 2.0))
        assert p.stroke_options.width == 2.0


@pytest.mark.slow  # fast gate keeps one compile per feature area; full battery in CI device-slow
class TestResize:
    def test_resize_renders_at_new_size(self):
        renderer = Renderer(Configuration(), SIZE, SIZE)
        shape = Shape([Path.from_circle((32, 32), 20)])
        img0 = renderer.render(
            stencil_color(shape, ortho(), (1, 0, 0, 1))
        )
        assert img0.shape == (SIZE, SIZE, 4)
        renderer.resize(96, 96)
        img1 = renderer.render(
            stencil_color(shape, ortho(96), (1, 0, 0, 1))
        )
        assert img1.shape == (96, 96, 4)
        # Circle center model (32, 32) → image row 96-32, col 32.
        assert img1[96 - 32, 32, 3] > 0.9
        assert img1[2, 2, 3] == 0.0


class TestFrameTimer:
    def test_rolling_average(self):
        from contrast_renderer.utils.profiling import FrameTimer

        timer = FrameTimer(window=4)
        for _ in range(6):
            with timer.frame():
                pass
        assert timer.frame_index == 6
        assert timer.average_s >= 0.0
        assert timer.fps > 0.0


class TestNearPlaneHull:
    def test_cover_survives_hull_vertex_behind_camera(self):
        # One Shape containing a visible rect and a far rect whose clip
        # w is negative under a perspective-like transform.  The convex
        # hull then has vertices behind the camera; the cover must be
        # near-plane clipped (GPU hardware behavior) instead of the
        # whole command being disabled.
        renderer = Renderer(Configuration(), SIZE, SIZE)
        near = Path.from_rect((20, 32), (8, 8))
        far = Path.from_rect((-600, 32), (8, 8))
        shape = Shape([near, far])
        t = ortho()
        t[3, 0] = 0.004  # w = 1 + 0.004·x: negative at x = -600
        commands = stencil_color(shape, t, (1.0, 0.0, 0.0, 1.0))
        image = renderer.render(commands)
        assert (image[..., 3] > 0.5).sum() > 30, "visible rect was dropped"


def _cubic_region_paths():
    """Three integral cubics — serpentine, cusp, loop (the inflection
    classification cases of the reference, fill.rs:53-65) — each closed
    with a line, in a 64×64 local box."""
    specs = {
        "serpentine": ((4, 16), [(24, 60), (40, 4), (60, 48)]),
        "cusp": ((4, 8), [(60, 60), (4, 60), (60, 8)]),
        "loop": ((8, 12), [(56, 52), (8, 52), (56, 12)]),
    }
    paths = {}
    for name, (start, control) in specs.items():
        p = Path(start=start)
        p.push_integral_cubic_curve(IntegralCubicCurveSegment(control))
        p.push_line(LineSegment([start]))
        paths[name] = p
    return paths


def _polyline_winding(path_start, control, points, n=4096):
    """Analytic ground truth: dense polyline of the cubic + closing
    line, then winding via the shoelace/crossing rule per point."""
    t = np.linspace(0.0, 1.0, n)[:, None]
    p0 = np.asarray(path_start, np.float64)
    p1, p2, p3 = (np.asarray(c, np.float64) for c in control)
    curve = (
        (1 - t) ** 3 * p0
        + 3 * (1 - t) ** 2 * t * p1
        + 3 * (1 - t) * t**2 * p2
        + t**3 * p3
    )
    poly = np.concatenate([curve, p0[None, :]], axis=0)
    a = poly[:-1]
    b = poly[1:]
    px = points[..., 0][..., None]
    py = points[..., 1][..., None]
    cond = (a[:, 1] <= py) != (b[:, 1] <= py)
    denom = b[:, 1] - a[:, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = a[:, 0] + (py - a[:, 1]) * (b[:, 0] - a[:, 0]) / denom
    cross = cond & (xint > px)
    direction = np.where(b[:, 1] > a[:, 1], 1, -1)
    return np.sum(np.where(cross, direction, 0), axis=-1)


class TestCubicGroundTruth:
    @pytest.mark.slow  # 128² battery, two full-kernel compiles
    @pytest.mark.parametrize("orient", ["forward", "reverse"])
    def test_cubic_battery_vs_polyline(self, orient):
        size = 128
        renderer = Renderer(
            Configuration(msaa_sample_count=1), size, size
        )
        paths = _cubic_region_paths()
        offsets = {"serpentine": (0, 0), "cusp": (64, 0), "loop": (0, 64)}
        commands = []
        shapes = {}
        for name, path in paths.items():
            if orient == "reverse":
                path.reverse()
            shapes[name] = Shape([path])
            ox, oy = offsets[name]
            t = np.diag(
                [2.0 / size, 2.0 / size, 1.0, 1.0]
            ).astype(np.float32)
            t[0, 3] = -1.0 + 2.0 * ox / size
            t[1, 3] = -1.0 + 2.0 * oy / size
            commands += stencil_color(shapes[name], t, (1, 1, 1, 1))
        image = renderer.render(commands)

        specs = {
            "serpentine": ((4, 16), [(24, 60), (40, 4), (60, 48)]),
            "cusp": ((4, 8), [(60, 60), (4, 60), (60, 8)]),
            "loop": ((8, 12), [(56, 52), (8, 52), (56, 12)]),
        }
        for name, (start, control) in specs.items():
            ox, oy = offsets[name]
            xx, yy = np.meshgrid(
                np.arange(64) + 0.5, np.arange(64) + 0.5, indexing="xy"
            )
            pts = np.stack([xx, yy], axis=-1)
            winding = _polyline_winding(start, control, pts)
            want = (winding != 0).astype(np.float32)
            # Rendered sub-image for this region (flip y for image rows).
            region = image[
                size - oy - 64: size - oy, ox: ox + 64, 3
            ][::-1]
            mismatch = np.mean(np.abs(region - want) > 0.5)
            assert mismatch < 5e-3, (name, orient, mismatch)


class TestFrameLimits:
    """The raster kernel's real limit: per-tile tables indexed by int32
    (tiles × commands, tiles × cover draws); past it the frame raises
    the typed error before anything compiles."""

    def test_frame_too_complex_typed_error(self):
        from contrast_renderer.error import FrameTooComplex
        from contrast_renderer.ops import coverage

        spec = coverage.FrameSpec(
            width=16384, height=16384, ops=(0, 3), cmd_shape=(0, 0),
            cmd_inst=(40000, 40000), n_shapes=1, t_max=8, h_max=8,
            samples=1, winding_bits=4, n_layers=0,
            blending="back_to_front",
        )
        with pytest.raises(FrameTooComplex):
            coverage.make_rasterize(spec)
