"""Randomized device-vs-ground-truth fuzzing of the full render path.

Scenes of random polygons, circles, rounded rects and free-form
quadratic/cubic loops run through the complete Renderer (stencil +
color cover) and are compared against the analytic polyline winding of
the same paths (oracle.ground_truth_winding — dense flattening, no
shared code with the device path).  Seeded for determinism; one shape
per scene keeps a single compiled frame program.
"""

import numpy as np
import pytest

from contrast_renderer import oracle
from contrast_renderer.path import (
    IntegralCubicCurveSegment,
    IntegralQuadraticCurveSegment,
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

# Each randomized scene compiles its own frame program — minutes of XLA
# compile time cold; excluded from the fast gate (pytest.ini).
pytestmark = pytest.mark.slow

SIZE = 64


def ortho(size=SIZE):
    t = np.diag([2.0 / size, 2.0 / size, 1.0, 1.0]).astype(np.float32)
    t[0, 3] = -1.0
    t[1, 3] = -1.0
    return t


def random_blob(rng, center, radius, n_segments):
    """Closed path around `center`: random mix of line / quadratic /
    cubic segments through points jittered around a circle."""
    angles = np.sort(rng.uniform(0.0, 2.0 * np.pi, n_segments))
    radii = rng.uniform(0.4 * radius, radius, n_segments)
    pts = [
        (
            center[0] + r * np.cos(a),
            center[1] + r * np.sin(a),
        )
        for a, r in zip(angles, radii)
    ]
    p = Path(start=pts[0])
    for i in range(1, n_segments + 1):
        target = pts[i % n_segments]
        prev = pts[i - 1]
        kind = rng.integers(0, 3)
        mid = (
            0.5 * (prev[0] + target[0]) + rng.uniform(-8, 8),
            0.5 * (prev[1] + target[1]) + rng.uniform(-8, 8),
        )
        if kind == 0:
            p.push_line(LineSegment([target]))
        elif kind == 1:
            p.push_integral_quadratic_curve(
                IntegralQuadraticCurveSegment([mid, target])
            )
        else:
            mid2 = (
                0.5 * (mid[0] + target[0]) + rng.uniform(-8, 8),
                0.5 * (mid[1] + target[1]) + rng.uniform(-8, 8),
            )
            p.push_integral_cubic_curve(
                IntegralCubicCurveSegment([mid, mid2, target])
            )
    return p


def random_scene(rng):
    paths = []
    for _ in range(3):
        cx, cy = rng.uniform(16, SIZE - 16, 2)
        r = rng.uniform(7, 13)
        shape_kind = rng.integers(0, 4)
        if shape_kind == 0:
            paths.append(Path.from_circle((cx, cy), r))
        elif shape_kind == 1:
            paths.append(
                Path.from_rounded_rect((cx, cy), (r, 0.8 * r), 0.3 * r)
            )
        elif shape_kind == 2:
            k = int(rng.integers(3, 8))
            ang = rng.uniform(0, 2 * np.pi)
            paths.append(
                Path.from_regular_polygon((cx, cy), r, ang, k)
            )
        else:
            paths.append(
                random_blob(rng, (cx, cy), r, int(rng.integers(3, 7)))
            )
    return paths


class TestFuzzFills:
    def test_random_scenes_match_ground_truth(self):
        rng = np.random.default_rng(20260817)
        renderer = Renderer(Configuration(), SIZE, SIZE)
        positions = oracle.sample_positions(SIZE, SIZE)

        def m2p(pts):
            out = pts.copy()
            out[:, 1] = SIZE - out[:, 1]
            return out

        covered = 0.0
        for scene_index in range(2):
            paths = random_scene(rng)
            shape = Shape(paths)
            image = np.asarray(
                renderer.render(
                    [
                        DrawCommand(RenderOperation.STENCIL, shape, ortho()),
                        DrawCommand(
                            RenderOperation.COLOR, shape, ortho(),
                            color=(1.0, 1.0, 1.0, 1.0),
                        ),
                    ]
                )
            )
            truth = oracle.ground_truth_winding(paths, positions, m2p, 512)
            alpha_truth = (
                oracle.coverage_from_winding(truth)
                .mean(axis=-1)
                .astype(np.float32)
            )
            err = np.abs(image[..., 3] - alpha_truth).mean()
            covered += float(alpha_truth.sum())
            assert err < 2e-3, (
                f"scene {scene_index}: mean alpha error {err}"
            )
        assert covered > 100.0  # sanity: scenes were non-empty


class TestFuzzRational:
    """Random scenes of rational quadratics/cubics (ellipses, SVG
    elliptical arcs, weight-lifted blobs) vs the analytic polyline
    ground truth — covering the two segment types the fill fuzz above
    does not (shaders.wgsl:252-266 predicates)."""

    def test_rational_scenes_match_ground_truth(self):
        rng = np.random.default_rng(20260818)
        renderer = Renderer(Configuration(), SIZE, SIZE)
        positions = oracle.sample_positions(SIZE, SIZE)

        def m2p(pts):
            out = pts.copy()
            out[:, 1] = SIZE - out[:, 1]
            return out

        covered = 0.0
        for scene_index in range(2):
            paths = []
            # Ellipse: four weight-1/sqrt(2) rational quadratics.
            cx, cy = rng.uniform(18, SIZE - 18, 2)
            paths.append(
                Path.from_ellipse(
                    (cx, cy), (rng.uniform(8, 14), rng.uniform(5, 10))
                )
            )
            # SVG elliptical arcs: rational quadratics with general
            # weights (path.rs:639-708).
            cx, cy = rng.uniform(18, SIZE - 18, 2)
            p = Path(start=(cx - 10.0, cy))
            p.push_elliptical_arc(
                (rng.uniform(8, 12), rng.uniform(5, 8)),
                rng.uniform(0, np.pi),
                bool(rng.integers(0, 2)),
                True,
                (cx + 10.0, cy),
            )
            p.push_line(LineSegment([(cx - 10.0, cy)]))
            paths.append(p)
            # Weight-lifted blob: integral -> rational, quadratics ->
            # rational cubics with non-unit weights (path.rs:490-615).
            cx, cy = rng.uniform(20, SIZE - 20, 2)
            blob = random_blob(rng, (cx, cy), rng.uniform(8, 12), 5)
            blob = blob.convert_integral_curves_to_rational_curves()
            blob = blob.convert_quadratic_curves_to_cubic_curves()
            paths.append(blob)

            shape = Shape(paths)
            image = np.asarray(
                renderer.render(
                    [
                        DrawCommand(RenderOperation.STENCIL, shape, ortho()),
                        DrawCommand(
                            RenderOperation.COLOR, shape, ortho(),
                            color=(1.0, 1.0, 1.0, 1.0),
                        ),
                    ]
                )
            )
            truth = oracle.ground_truth_winding(paths, positions, m2p, 512)
            alpha_truth = (
                oracle.coverage_from_winding(truth)
                .mean(axis=-1)
                .astype(np.float32)
            )
            err = np.abs(image[..., 3] - alpha_truth).mean()
            covered += float(alpha_truth.sum())
            assert err < 2e-3, (
                f"scene {scene_index}: mean alpha error {err}"
            )
        assert covered > 100.0


def _distance_to_polyline(flat_positions, polyline, closed):
    """Min distance from each (N, 2) position to the polyline's
    segments ((M, 2); closed appends the wrap edge)."""
    a = np.asarray(polyline, np.float64)
    b = np.roll(a, -1, axis=0)
    if not closed:
        a, b = a[:-1], b[:-1]
    ab = b - a
    denom = np.maximum((ab * ab).sum(-1), 1e-30)
    best = np.full(len(flat_positions), np.inf)
    # Chunk over segments to bound the (N, M) temporaries.
    for lo in range(0, len(a), 512):
        aa = a[lo:lo + 512]
        dd = ab[lo:lo + 512]
        t = np.clip(
            ((flat_positions[:, None, :] - aa[None]) * dd[None]).sum(-1)
            / denom[lo:lo + 512][None],
            0.0,
            1.0,
        )
        proj = aa[None] + t[..., None] * dd[None]
        d2 = ((flat_positions[:, None, :] - proj) ** 2).sum(-1)
        best = np.minimum(best, np.sqrt(d2.min(axis=1)))
    return best


class TestFuzzStrokes:
    """Random stroked paths (round joins, round caps, solid) vs the
    analytic stroke region: with round joins and round caps the exact
    stroke is {p : dist(p, curve) <= width/2} — no shared code with the
    stroke tessellator or the device predicates.  Samples within a
    small band of the region boundary are excluded (the polygon
    approximation of curves, stroke.rs:134-168 semantics, legitimately
    deviates there); everything else must match exactly."""

    def test_random_strokes_match_distance_oracle(self):
        from contrast_renderer.path import (
            Cap,
            CurveApproximation,
            DynamicStrokeOptions,
            Join,
            StrokeOptions,
        )

        rng = np.random.default_rng(20260819)
        renderer = Renderer(Configuration(), SIZE, SIZE)
        positions = oracle.sample_positions(SIZE, SIZE)
        flat = positions.reshape(-1, 2)
        solid = DynamicStrokeOptions.make_solid(
            Join.ROUND, Cap.ROUND, Cap.ROUND
        )

        for scene_index in range(2):
            width = float(rng.uniform(3.0, 6.0))
            paths = []
            for _ in range(2):
                cx, cy = rng.uniform(16, SIZE - 16, 2)
                p = random_blob(rng, (cx, cy), rng.uniform(8, 13), 4)
                closed = bool(rng.integers(0, 2))
                p.stroke_options = StrokeOptions(
                    width=width,
                    offset=0.0,
                    miter_clip=1.0,
                    closed=closed,
                    dynamic_stroke_options_group=0,
                    curve_approximation=(
                        CurveApproximation.uniform_tangent_angle(0.05)
                    ),
                )
                paths.append(p)
            shape = Shape(paths, [solid])
            image = np.asarray(
                renderer.render(
                    [
                        DrawCommand(RenderOperation.STENCIL, shape, ortho()),
                        DrawCommand(
                            RenderOperation.COLOR, shape, ortho(),
                            color=(1.0, 1.0, 1.0, 1.0),
                        ),
                    ]
                )
            )

            # Analytic region: union over paths of dist <= width/2.
            dist = np.full(len(flat), np.inf)
            for p in paths:
                poly = oracle.flatten_path(p, 256)
                poly[:, 1] = SIZE - poly[:, 1]  # model -> pixel
                dist = np.minimum(
                    dist,
                    _distance_to_polyline(
                        flat, poly, p.stroke_options.closed
                    ),
                )
            inside = dist <= width / 2.0
            band = np.abs(dist - width / 2.0) < 0.4
            # Compare resolved coverage against the oracle's resolved
            # coverage with boundary-band samples forgiven.
            inside_px = inside.reshape(SIZE, SIZE, 4)
            band_px = band.reshape(SIZE, SIZE, 4)
            want = inside_px.mean(axis=-1)
            have = image[..., 3]
            forgiven = band_px.any(axis=-1)
            exact = ~forgiven
            assert np.abs(have[exact] - want[exact]).max() < 1e-6, (
                f"scene {scene_index}: off-band mismatch"
            )
            # Sanity: the stroke drew something substantial.
            assert want.sum() > 50.0


def _hull_mask(shape, flat_positions):
    """Inside-convex-hull mask in pixel space for a shape drawn under
    `ortho()` (model -> pixel is (x, SIZE - y))."""
    hull = np.asarray(shape.convex_hull, np.float64)
    if len(hull) < 3:
        return np.zeros(len(flat_positions), bool)
    pts = hull.copy()
    pts[:, 1] = SIZE - pts[:, 1]
    nxt = np.roll(pts, -1, axis=0)
    area = np.sum(pts[:, 0] * nxt[:, 1] - nxt[:, 0] * pts[:, 1])
    if area < 0:
        pts = pts[::-1]
        nxt = np.roll(pts, -1, axis=0)
    inside = np.ones(len(flat_positions), bool)
    for a, b in zip(pts, nxt):
        e = (b[0] - a[0]) * (flat_positions[:, 1] - a[1]) - (
            b[1] - a[1]
        ) * (flat_positions[:, 0] - a[0])
        inside &= e >= 0.0
    return inside


class TestFuzzClipAlpha:
    """Random nested clip + transparency-group command stacks vs a
    numpy per-sample compositing oracle implementing the documented
    stencil/blend algebra (renderer.rs:692-861) directly from the
    ground-truth winding — no shared code with the Pallas kernel."""

    def test_random_stacks_match_compositing_oracle(self):
        rng = np.random.default_rng(20260820)
        config = Configuration(
            alpha_layer_count=1, blending="front_to_back"
        )
        renderer = Renderer(config, SIZE, SIZE)
        positions = oracle.sample_positions(SIZE, SIZE)
        flat = positions.reshape(-1, 2)
        winding_mask = 15

        def m2p(pts):
            out = pts.copy()
            out[:, 1] = SIZE - out[:, 1]
            return out

        def random_shape_paths():
            cx, cy = rng.uniform(20, SIZE - 20, 2)
            r = rng.uniform(10, 16)
            kind = rng.integers(0, 3)
            if kind == 0:
                return [Path.from_circle((cx, cy), r)]
            if kind == 1:
                return [
                    Path.from_rounded_rect((cx, cy), (r, 0.7 * r), 0.3 * r)
                ]
            return [
                Path.from_regular_polygon((cx, cy), r, rng.uniform(0, 3), 5)
            ]

        from contrast_renderer.renderer import (
            LinearGradient,
            RadialGradient,
            _paint_kind,
        )

        for scene_index in range(2):
            path_lists = [random_shape_paths() for _ in range(3)]
            shapes = [Shape(p) for p in path_lists]
            clip_shape, content, overlay = shapes
            colors = rng.uniform(0.1, 1.0, (3, 4)).astype(np.float32)
            group_opacity = float(rng.uniform(0.3, 0.9))
            # Scene 1 paints the group content with a random gradient
            # (linear then radial would need a third scene; alternate).
            if scene_index == 1:
                pts = rng.uniform(10, SIZE - 10, (2, 2))
                n_stops = int(rng.integers(2, 5))
                offsets = np.sort(rng.uniform(0.0, 1.0, n_stops))
                stop_colors = rng.uniform(0.1, 1.0, (n_stops, 4))
                paint_cls = LinearGradient if rng.integers(2) else RadialGradient
                content_color = paint_cls(
                    tuple(pts[0]), tuple(pts[1]),
                    stops=tuple(
                        (float(o), tuple(c))
                        for o, c in zip(offsets, stop_colors)
                    ),
                )
            else:
                content_color = tuple(colors[1])

            commands = [
                DrawCommand(RenderOperation.STENCIL, clip_shape, ortho()),
                DrawCommand(
                    RenderOperation.CLIP, clip_shape, ortho(), clip_depth=1
                ),
                DrawCommand(
                    RenderOperation.SAVE_ALPHA_CONTEXT, overlay, ortho(),
                    clip_depth=1, alpha_layer=0,
                ),
                DrawCommand(
                    RenderOperation.SCALE_ALPHA_CONTEXT, overlay, ortho(),
                    clip_depth=1,
                    color=(0.0, 0.0, 0.0, group_opacity),
                ),
                DrawCommand(
                    RenderOperation.STENCIL, content, ortho(), clip_depth=1
                ),
                DrawCommand(
                    RenderOperation.COLOR, content, ortho(),
                    color=content_color, clip_depth=1,
                ),
                DrawCommand(
                    RenderOperation.RESTORE_ALPHA_CONTEXT, overlay,
                    ortho(), clip_depth=1,
                    color=(0.0, 0.0, 0.0, group_opacity), alpha_layer=0,
                ),
                DrawCommand(
                    RenderOperation.UNCLIP, clip_shape, ortho(),
                    clip_depth=0,
                ),
                DrawCommand(RenderOperation.STENCIL, overlay, ortho()),
                DrawCommand(
                    RenderOperation.COLOR, overlay, ortho(),
                    color=tuple(colors[2]),
                ),
            ]
            image = np.asarray(renderer.render(commands))

            # ---- oracle: per-sample state machine --------------------
            n = len(flat)
            wind = np.zeros(n, np.int64)
            clipb = np.zeros(n, np.int64)
            color = np.zeros((n, 4), np.float64)
            layer = np.zeros(n, np.float64)
            truth = {
                id(s): oracle.ground_truth_winding(
                    p, positions, m2p, 512
                ).reshape(-1)
                for s, p in zip(shapes, path_lists)
            }
            hull = {id(s): _hull_mask(s, flat) for s in shapes}

            for cmd in commands:
                op = cmd.operation
                depth = cmd.clip_depth
                clip_ok = clipb == depth
                if op == RenderOperation.STENCIL:
                    wind += np.where(clip_ok, truth[id(cmd.shape)], 0)
                    continue
                in_hull = hull[id(cmd.shape)]
                nonzero = (wind & winding_mask) != 0
                pk = _paint_kind(cmd.color)
                ca = 0.0 if pk else float(np.asarray(cmd.color)[3])
                if op == RenderOperation.COLOR:
                    mask = in_hull & nonzero & clip_ok
                    if pk:
                        # Gradient: per-sample multi-stop interpolation
                        # in pixel space (endpoints through the same
                        # model→pixel map as the winding positions).
                        pts = m2p(
                            cmd.color.points().astype(np.float64).copy()
                        )
                        delta = pts[1] - pts[0]
                        den = max(float(delta @ delta), 1e-12)
                        rel = flat - pts[0][None]
                        if pk == 1:
                            t = (rel @ delta) / den
                        else:
                            t = np.sqrt((rel * rel).sum(-1) / den)
                        t = np.clip(t, 0.0, 1.0)[:, None]
                        offs, cols = cmd.color.stop_table()
                        offs = offs.astype(np.float64)
                        cols = cols.astype(np.float64)
                        rgba = np.broadcast_to(
                            cols[0][None], (len(t), 4)
                        ).copy()
                        for si in range(len(offs) - 1):
                            f = np.clip(
                                (t[:, 0] - offs[si])
                                / max(offs[si + 1] - offs[si], 1e-6),
                                0.0, 1.0,
                            )
                            rgba += (cols[si + 1] - cols[si])[None] * (
                                f[:, None]
                            )
                        src = np.concatenate(
                            [rgba[:, :3] * rgba[:, 3:4], rgba[:, 3:4]],
                            axis=1,
                        )
                    else:
                        s = np.asarray(cmd.color, np.float64)
                        src = np.broadcast_to(
                            np.array([s[0] * ca, s[1] * ca, s[2] * ca, ca]),
                            (n, 4),
                        )
                    remaining = 1.0 - color[:, 3]
                    color = np.where(
                        mask[:, None],
                        color + src * remaining[:, None],
                        color,
                    )
                    wind = np.where(mask, 0, wind)
                elif op == RenderOperation.CLIP:
                    mask = in_hull & nonzero
                    clipb = np.where(mask, depth, clipb)
                    wind = np.where(mask, 0, wind)
                elif op == RenderOperation.UNCLIP:
                    mask = in_hull & (clipb > depth)
                    clipb = np.where(mask, depth, clipb)
                    wind = np.where(mask, 0, wind)
                elif op == RenderOperation.SAVE_ALPHA_CONTEXT:
                    mask = in_hull & clip_ok
                    layer = np.where(mask, color[:, 3], layer)
                elif op == RenderOperation.SCALE_ALPHA_CONTEXT:
                    mask = in_hull & clip_ok
                    color[:, 3] = np.where(
                        mask, (1.0 - ca) + ca * color[:, 3], color[:, 3]
                    )
                elif op == RenderOperation.RESTORE_ALPHA_CONTEXT:
                    mask = in_hull & clip_ok
                    color[:, 3] = np.where(
                        mask,
                        color[:, 3] - (1.0 - layer) * (1.0 - ca),
                        color[:, 3],
                    )

            want = (
                color.reshape(SIZE, SIZE, 4, 4).mean(axis=2)
            ).astype(np.float32)
            err = np.abs(image - want).max()
            assert err < 1e-5, f"scene {scene_index}: max error {err}"
            assert want[..., 3].sum() > 20.0  # non-trivial scene


class TestFuzzBlendStates:
    """Every wgpu blend factor (renderer.BLEND_FACTORS) exercised in a
    random blend state against an independent numpy compositing oracle
    (reference: arbitrary wgpu::BlendState, renderer.rs:381; factor
    semantics per the WebGPU spec)."""

    @staticmethod
    def _blend_oracle(comp_c, comp_a, const, src, dst, ca):
        """One blended draw over (n, 4) premultiplied buffers."""
        da = dst[:, 3].copy()
        out = np.empty_like(dst)
        for chan in range(4):
            sf, op, df = comp_a if chan == 3 else comp_c
            s, d = src[:, chan], dst[:, chan]
            if op == "min":
                out[:, chan] = np.minimum(s, d)
                continue
            if op == "max":
                out[:, chan] = np.maximum(s, d)
                continue

            def fac(name):
                if name == "zero":
                    return 0.0
                if name == "one":
                    return 1.0
                if name == "src_alpha":
                    return ca
                if name == "one_minus_src_alpha":
                    return 1.0 - ca
                if name == "dst_alpha":
                    return da
                if name == "one_minus_dst_alpha":
                    return 1.0 - da
                if name == "src_alpha_saturated":
                    return np.minimum(ca, 1.0 - da) if chan < 3 else 1.0
                if name == "constant":
                    return const[chan]
                return 1.0 - const[chan]  # one_minus_constant

            st, dt = s * fac(sf), d * fac(df)
            if op == "add":
                out[:, chan] = st + dt
            elif op == "subtract":
                out[:, chan] = st - dt
            else:
                out[:, chan] = dt - st  # reverse_subtract
        return out

    def test_every_factor_matches_oracle(self):
        from contrast_renderer.renderer import (
            BLEND_FACTORS,
            BlendComponent,
            BlendState,
        )

        rng = np.random.default_rng(20260818)
        positions = oracle.sample_positions(SIZE, SIZE)
        flat = positions.reshape(-1, 2)
        n = len(flat)
        winding_mask = 15

        def m2p(pts):
            out = pts.copy()
            out[:, 1] = SIZE - out[:, 1]
            return out

        ops_pool = ("add", "subtract", "reverse_subtract")
        for fi, factor in enumerate(BLEND_FACTORS):
            # The factor under test appears as the src factor of both
            # components; the rest of the state is random.
            comp_c = (factor, ops_pool[int(rng.integers(3))],
                      str(rng.choice(BLEND_FACTORS)))
            comp_a = (factor, ops_pool[int(rng.integers(3))],
                      str(rng.choice(BLEND_FACTORS)))
            state = BlendState(
                color=BlendComponent(*comp_c), alpha=BlendComponent(*comp_a)
            )
            const = tuple(rng.uniform(0.0, 1.0, 4).astype(np.float32))
            renderer = Renderer(
                Configuration(blending=state), SIZE, SIZE
            )
            renderer.set_blend_constant(const)

            paths, shapes, colors = [], [], []
            for _ in range(3):
                cx, cy = rng.uniform(18, SIZE - 18, 2)
                p = [Path.from_circle((cx, cy), rng.uniform(10, 18))]
                paths.append(p)
                shapes.append(Shape(p))
                colors.append(rng.uniform(0.1, 1.0, 4))
            commands = []
            for s, c in zip(shapes, colors):
                commands += [
                    DrawCommand(RenderOperation.STENCIL, s, ortho()),
                    DrawCommand(
                        RenderOperation.COLOR, s, ortho(), color=tuple(c)
                    ),
                ]
            image = np.asarray(renderer.render(commands))

            # Oracle: ground-truth winding + hull masks + blend algebra.
            wind = np.zeros(n, np.int64)
            color = np.zeros((n, 4), np.float64)
            for s, p, c in zip(shapes, paths, colors):
                truth = oracle.ground_truth_winding(
                    p, positions, m2p, 512
                ).reshape(-1)
                wind += truth
                mask = _hull_mask(s, flat) & ((wind & winding_mask) != 0)
                ca = float(c[3])
                src = np.broadcast_to(
                    np.array([c[0] * ca, c[1] * ca, c[2] * ca, ca]), (n, 4)
                )
                blended = self._blend_oracle(
                    (comp_c[0], comp_c[1], comp_c[2]),
                    (comp_a[0], comp_a[1], comp_a[2]),
                    const, src, color, ca,
                )
                color = np.where(mask[:, None], blended, color)
                wind = np.where(mask, 0, wind)
            want = (
                color.reshape(SIZE, SIZE, 4, 4).mean(axis=2)
            ).astype(np.float32)
            err = np.abs(image - want).max()
            assert err < 1e-5, (
                f"factor {factor}: state c={comp_c} a={comp_a}, "
                f"max error {err}"
            )
            assert np.abs(want).sum() > 1.0  # non-trivial scene


# ---------------------------------------------------------------------------
# Stroke join / cap / dash fuzzing (beyond the round/round/solid battery
# above): first-principles numpy region oracles, independent of
# stroke.py's tessellator and dynamic_stroke.py's predicates.
# Semantics pinned: joint polygons stroke.rs:53-121, cap shapes
# shaders.wgsl:165-189, dash pattern algebra shaders.wgsl:205-231.
# ---------------------------------------------------------------------------


def _seg_coords(flat, a, b):
    """Per-sample (t, s) coordinates along/across segment a->b (pixel
    space): t in [0, L] inside the span, s signed left-normal offset."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = b - a
    length = np.linalg.norm(d)
    d = d / length
    nl = np.array([-d[1], d[0]])
    rel = flat - a[None]
    return rel @ d, rel @ nl, length, d, nl


def _cap_region(x, y, cap):
    """Cap shapes in width units: x side in [-0.5, 0.5], y distance
    beyond the dash/stroke end (reference shaders.wgsl:165-189; SQUARE
    uses the documented rectangle, see dynamic_stroke.py docstring)."""
    from contrast_renderer.path import Cap

    ax = np.abs(x)
    if cap == Cap.SQUARE:
        return y <= 0.5
    if cap == Cap.ROUND:
        return x * x + y * y < 0.25
    if cap == Cap.OUT:
        return 0.5 - y > ax
    if cap == Cap.IN:
        return y < ax
    if cap == Cap.RIGHT:
        return 0.5 - y > x
    if cap == Cap.LEFT:
        return y - 0.5 < x
    return y < 0.0  # BUTT


def _point_in_polygon(flat, poly):
    """Even-odd crossing test, vectorized over (N, 2) samples."""
    poly = np.asarray(poly, np.float64)
    inside = np.zeros(len(flat), bool)
    j = len(poly) - 1
    for i in range(len(poly)):
        xi, yi = poly[i]
        xj, yj = poly[j]
        crosses = (yi > flat[:, 1]) != (yj > flat[:, 1])
        with np.errstate(divide="ignore", invalid="ignore"):
            x_at = xi + (flat[:, 1] - yi) / (yj - yi) * (xj - xi)
        inside ^= crosses & (flat[:, 0] < x_at)
        j = i
    return inside


def _join_polygon(c, d0, d1, w, join, miter_clip):
    """The joint region at vertex c between directions d0 -> d1
    (first-principles reconstruction of stroke.rs:53-121's polygon)."""
    from contrast_renderer.path import Join

    cross = d0[0] * d1[1] - d0[1] * d1[0]
    side_sign = 1.0 if cross >= 0.0 else -1.0
    nl0 = np.array([-d0[1], d0[0]])
    nl1 = np.array([-d1[1], d1[0]])
    pe = c - side_sign * nl0 * (w / 2.0)
    ne = c - side_sign * nl1 * (w / 2.0)
    if join == Join.BEVEL:
        return [c, pe, ne]
    if join == Join.ROUND:
        return None  # handled as a disc by the caller

    def intersect(p0, t0, p1, t1):
        # p0 + a t0 = p1 + b t1
        m = np.array([[t0[0], -t1[0]], [t0[1], -t1[1]]])
        ab = np.linalg.solve(m, p1 - p0)
        return p0 + ab[0] * t0

    m_pt = intersect(pe, d0, ne, d1)
    clip_len = w * miter_clip
    if np.linalg.norm(m_pt - c) > clip_len:
        mid = d0 + d1
        mid = mid / np.linalg.norm(mid)
        nl_mid = np.array([-mid[1], mid[0]])
        cv = c - side_sign * nl_mid * clip_len
        x1 = intersect(pe, d0, cv, mid)
        x2 = intersect(cv, mid, ne, d1)
        return [c, pe, x1, x2, ne]
    return [c, pe, m_pt, ne]


def _forgive_by_perturbation(region_fn, flat, radius=0.35):
    """Samples whose region membership flips under a small positional
    perturbation sit on a boundary; exempt them from exact comparison
    (f32 interpolation in the kernel vs f64 oracle geometry)."""
    base = region_fn(flat)
    unstable = np.zeros(len(flat), bool)
    for dx, dy in ((radius, 0), (-radius, 0), (0, radius), (0, -radius),
                   (radius, radius), (-radius, -radius),
                   (radius, -radius), (-radius, radius)):
        unstable |= region_fn(flat + np.array([dx, dy])) != base
    return base, unstable


def _render_stroke_scene(paths, options, size=SIZE):
    renderer = Renderer(Configuration(), size, size)
    shape = Shape(paths, options)
    return np.asarray(
        renderer.render(
            [
                DrawCommand(RenderOperation.STENCIL, shape, ortho()),
                DrawCommand(
                    RenderOperation.COLOR, shape, ortho(),
                    color=(1.0, 1.0, 1.0, 1.0),
                ),
            ]
        )
    )


def _compare_stroke_coverage(image, region_fn, label, min_cover=30.0):
    positions = oracle.sample_positions(SIZE, SIZE)
    flat = positions.reshape(-1, 2)
    # Oracle works in model space: pixel (px, py) -> model (px, SIZE-py).
    model = flat.copy()
    model[:, 1] = SIZE - model[:, 1]

    def region_pixel(pts):
        m = pts.copy()
        m[:, 1] = SIZE - pts[:, 1]
        return region_fn(m)

    inside, unstable = _forgive_by_perturbation(region_pixel, flat)
    want = inside.reshape(SIZE, SIZE, 4).mean(axis=-1)
    forgiven = unstable.reshape(SIZE, SIZE, 4).any(axis=-1)
    have = image[..., 3]
    exact = ~forgiven
    err = np.abs(have[exact] - want[exact]).max() if exact.any() else 0.0
    assert err < 1e-6, f"{label}: off-boundary mismatch {err}"
    assert want.sum() > min_cover, f"{label}: trivial scene"


class TestFuzzJoins:
    """Random open polylines with miter (clipped and unclipped) and
    bevel joins, solid butt-capped strokes, vs the exact
    rectangle-union + joint-polygon region."""

    def test_miter_and_bevel_joins_match_polygon_oracle(self):
        from contrast_renderer.path import (
            Cap,
            DynamicStrokeOptions,
            Join,
            StrokeOptions,
        )

        rng = np.random.default_rng(20260821)
        for scene_index in range(2):
            width = float(rng.uniform(4.0, 7.0))
            # Three paths in one shape: miter, tightly-clipped miter,
            # bevel — one descriptor group each (one compile per scene).
            joins = [
                (Join.MITER, float(rng.uniform(2.0, 4.0))),
                (Join.MITER, float(rng.uniform(0.55, 0.8))),
                (Join.BEVEL, 1.0),
            ]
            paths = []
            scene_pts = []
            options = []
            for g, (join, clip) in enumerate(joins):
                # A 4-point polyline with pronounced corners, kept away
                # from the other paths by column placement.
                x0 = 8.0 + 16.0 * g
                pts = [
                    np.array(
                        [x0 + rng.uniform(0.0, 6.0),
                         10.0 + 14.0 * k + rng.uniform(0.0, 6.0)]
                    )
                    for k in range(4)
                ]
                # Skip near-straight/reflex-degenerate corners.
                p = Path(start=tuple(pts[0]))
                for q in pts[1:]:
                    p.push_line(LineSegment([tuple(q)]))
                p.stroke_options = StrokeOptions(
                    width=width,
                    offset=0.0,
                    miter_clip=clip,
                    closed=False,
                    dynamic_stroke_options_group=g,
                )
                paths.append(p)
                scene_pts.append(pts)
                options.append(
                    DynamicStrokeOptions.make_solid(join, Cap.BUTT, Cap.BUTT)
                )
            image = _render_stroke_scene(paths, options)

            def region(model_pts):
                inside = np.zeros(len(model_pts), bool)
                for (join, clip), pts in zip(joins, scene_pts):
                    for a, b in zip(pts[:-1], pts[1:]):
                        t, s, length, _, _ = _seg_coords(model_pts, a, b)
                        inside |= (
                            (np.abs(s) <= width / 2.0)
                            & (t >= 0.0) & (t <= length)
                        )
                    for k in range(1, 3):
                        d0 = pts[k] - pts[k - 1]
                        d0 = d0 / np.linalg.norm(d0)
                        d1 = pts[k + 1] - pts[k]
                        d1 = d1 / np.linalg.norm(d1)
                        if abs(d0 @ d1 - 1.0) <= 1e-4:
                            continue
                        poly = _join_polygon(
                            pts[k], d0, d1, width, join, clip
                        )
                        inside |= _point_in_polygon(model_pts, poly)
                return inside

            _compare_stroke_coverage(
                image, region, f"joins scene {scene_index}"
            )


class TestFuzzCaps:
    """All seven cap styles on random-angle straight strokes vs the
    rectangle + analytic cap region (shaders.wgsl:165-189)."""

    def test_all_caps_match_region_oracle(self):
        from contrast_renderer.path import (
            Cap,
            DynamicStrokeOptions,
            Join,
            StrokeOptions,
        )

        rng = np.random.default_rng(20260822)
        caps = [Cap.SQUARE, Cap.ROUND, Cap.OUT, Cap.IN,
                Cap.RIGHT, Cap.LEFT, Cap.BUTT]
        for scene_index in range(2):
            width = float(rng.uniform(4.0, 6.5))
            segs = []
            paths = []
            options = []
            for g, cap_pair in enumerate(
                zip(caps, np.roll(caps, scene_index + 1))
            ):
                cy = 6.0 + 8.0 * g
                a = np.array([10.0 + rng.uniform(0, 4), cy])
                angle = rng.uniform(-0.25, 0.25)
                length = rng.uniform(28.0, 40.0)
                b = a + length * np.array([np.cos(angle), np.sin(angle)])
                p = Path(start=tuple(a))
                p.push_line(LineSegment([tuple(b)]))
                p.stroke_options = StrokeOptions(
                    width=width, dynamic_stroke_options_group=g
                )
                paths.append(p)
                segs.append((a, b, cap_pair[0], cap_pair[1]))
                options.append(
                    DynamicStrokeOptions.make_solid(
                        Join.MITER,  # irrelevant: single segment
                        cap_pair[0],
                        cap_pair[1],
                    )
                )
            image = _render_stroke_scene(paths, options)

            def region(model_pts):
                inside = np.zeros(len(model_pts), bool)
                for a, b, start_cap, end_cap in segs:
                    t, s, length, _, _ = _seg_coords(model_pts, a, b)
                    x = s / width
                    body = (
                        (np.abs(x) <= 0.5) & (t >= 0.0) & (t <= length)
                    )
                    in_ext_band = np.abs(x) <= 0.5
                    start = (
                        in_ext_band
                        & (t >= -width / 2.0) & (t < 0.0)
                        & _cap_region(x, -t / width, start_cap)
                    )
                    end = (
                        in_ext_band
                        & (t > length) & (t <= length + width / 2.0)
                        & _cap_region(x, (t - length) / width, end_cap)
                    )
                    inside |= body | start | end
                return inside

            _compare_stroke_coverage(
                image, region, f"caps scene {scene_index}"
            )


class TestFuzzDash:
    """Random dash patterns (1-4 intervals, random per-edge caps and
    phases) on random-angle straight strokes vs the pattern-space
    modular region (shaders.wgsl:205-231)."""

    def test_random_dash_patterns_match_oracle(self):
        from contrast_renderer.path import (
            Cap,
            DashInterval,
            DynamicStrokeOptions,
            Join,
            StrokeOptions,
        )

        rng = np.random.default_rng(20260823)
        all_caps = [Cap.SQUARE, Cap.ROUND, Cap.OUT, Cap.IN,
                    Cap.RIGHT, Cap.LEFT, Cap.BUTT]
        for scene_index in range(2):
            width = float(rng.uniform(4.0, 6.0))
            paths, options, segs, descs = [], [], [], []
            for g in range(3):
                n_intervals = int(rng.integers(1, 5))
                pos = 0.0
                intervals = []
                for _ in range(n_intervals):
                    dash_len = float(rng.uniform(0.8, 3.0))
                    gap_len = float(rng.uniform(0.7, 2.0))
                    intervals.append(
                        DashInterval(
                            gap_start=pos + dash_len,
                            gap_end=pos + dash_len + gap_len,
                            dash_start=all_caps[int(rng.integers(7))],
                            dash_end=all_caps[int(rng.integers(7))],
                        )
                    )
                    pos += dash_len + gap_len
                phase = float(rng.uniform(0.0, pos))
                cy = 10.0 + 18.0 * g
                a = np.array([6.0 + rng.uniform(0, 3), cy])
                angle = rng.uniform(-0.2, 0.2)
                length = rng.uniform(40.0, 50.0)
                b = a + length * np.array([np.cos(angle), np.sin(angle)])
                p = Path(start=tuple(a))
                p.push_line(LineSegment([tuple(b)]))
                p.stroke_options = StrokeOptions(
                    width=width, dynamic_stroke_options_group=g
                )
                paths.append(p)
                segs.append((a, b))
                options.append(
                    DynamicStrokeOptions.make_dashed(
                        Join.MITER, intervals, phase=phase
                    )
                )
                descs.append((intervals, phase))
            image = _render_stroke_scene(paths, options)

            def region(model_pts):
                inside = np.zeros(len(model_pts), bool)
                for (a, b), (intervals, phase) in zip(segs, descs):
                    t, s, length, _, _ = _seg_coords(model_pts, a, b)
                    x = s / width
                    in_rect = (
                        (np.abs(x) <= 0.5)
                        & (t >= -width / 2.0)
                        & (t <= length + width / 2.0)
                    )
                    pattern_len = intervals[-1].gap_end
                    position = np.remainder(t / width - phase, pattern_len)
                    # First interval whose gap_end covers the position.
                    n = len(intervals)
                    interval_of = np.full(len(t), n - 1)
                    for i in reversed(range(n)):
                        interval_of = np.where(
                            intervals[i].gap_end - position >= 0.0,
                            i, interval_of,
                        )
                    on = np.zeros(len(t), bool)
                    for i, iv in enumerate(intervals):
                        here = interval_of == i
                        start_cap_next = intervals[(i + 1) % n].dash_start
                        on_i = (
                            (position <= iv.gap_start)
                            | _cap_region(
                                x, position - iv.gap_start, iv.dash_end
                            )
                            | _cap_region(
                                x, iv.gap_end - position, start_cap_next
                            )
                        )
                        on |= here & on_i
                    inside |= in_rect & on
                return inside

            _compare_stroke_coverage(
                image, region, f"dash scene {scene_index}"
            )
