"""End-to-end Renderer tests: stencil/cover command machine, instancing,
clipping, opacity groups, dash animation without retrace."""

import dataclasses

import numpy as np
import pytest

from contrast_renderer import oracle
from contrast_renderer.path import (
    Cap,
    DashInterval,
    DynamicStrokeOptions,
    Join,
    LineSegment,
    Path,
    StrokeOptions,
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


def translate(tx, ty, size=SIZE):
    t = ortho(size)
    t[0, 3] += 2.0 * tx / size
    t[1, 3] += 2.0 * ty / size
    return t


def model_xy(size=SIZE):
    pos = oracle.sample_positions(size, size)
    out = pos.copy()
    out[..., 1] = size - pos[..., 1]
    return out


@pytest.fixture(scope="module")
def renderer():
    return Renderer(Configuration(), SIZE, SIZE)


def stencil_color(shape, transform, color):
    return [
        DrawCommand(RenderOperation.STENCIL, shape, transform),
        DrawCommand(RenderOperation.COLOR, shape, transform, color=color),
    ]


class TestBasicRendering:
    def test_circle_fill(self, renderer):
        shape = Shape([Path.from_circle((32, 32), 22)])
        image = renderer.render(
            stencil_color(shape, ortho(), (1.0, 0.0, 0.0, 1.0))
        )
        assert image.shape == (SIZE, SIZE, 4)
        xy = model_xy()
        r = np.hypot(xy[..., 0] - 32, xy[..., 1] - 32)
        expected = np.mean(r <= 22, axis=-1)
        assert np.mean(np.abs(image[..., 3] - expected)) < 2e-3
        assert np.allclose(image[32, 32], [1, 0, 0, 1], atol=1e-5)
        assert np.allclose(image[2, 2], 0.0)

    def test_instances_over_blend(self, renderer):
        shape = Shape([Path.from_rect((20, 32), (12, 12))])
        commands = stencil_color(shape, ortho(), (1.0, 0.0, 0.0, 1.0))
        commands += stencil_color(
            shape, translate(16, 0), (0.0, 0.0, 1.0, 0.5)
        )
        image = renderer.render(commands)
        # Left-only region: pure red; right-only: half blue; overlap:
        # blue-over-red.
        assert np.allclose(image[32, 10], [1, 0, 0, 1], atol=1e-5)
        assert np.allclose(image[32, 45], [0, 0, 0.5, 0.5], atol=1e-5)
        assert np.allclose(image[32, 28], [0.5, 0, 0.5, 1.0], atol=1e-5)

    def test_winding_reset_between_instances(self, renderer):
        # Same shape drawn twice in the same place: second draw works
        # because the first Color reset the winding (stencil Less→Zero).
        shape = Shape([Path.from_rect((32, 32), (10, 10))])
        commands = stencil_color(shape, ortho(), (1.0, 0.0, 0.0, 1.0))
        commands += stencil_color(shape, ortho(), (0.0, 1.0, 0.0, 1.0))
        image = renderer.render(commands)
        assert np.allclose(image[32, 32], [0, 1, 0, 1], atol=1e-5)


class TestClipping:
    def test_circle_clips_rect(self, renderer):
        circle = Shape([Path.from_circle((32, 32), 16)])
        rect = Shape([Path.from_rect((32, 32), (26, 26))])
        commands = [
            DrawCommand(RenderOperation.STENCIL, circle, ortho()),
            DrawCommand(
                RenderOperation.CLIP, circle, ortho(), clip_depth=1
            ),
            DrawCommand(
                RenderOperation.STENCIL, rect, ortho(), clip_depth=1
            ),
            DrawCommand(
                RenderOperation.COLOR,
                rect,
                ortho(),
                color=(0.0, 1.0, 0.0, 1.0),
                clip_depth=1,
            ),
            DrawCommand(
                RenderOperation.UNCLIP, circle, ortho(), clip_depth=0
            ),
            # After unclip, drawing outside the circle works again.
            DrawCommand(RenderOperation.STENCIL, rect, translate(0, -26)),
        ]
        commands.append(
            DrawCommand(
                RenderOperation.COLOR,
                rect,
                translate(0, -26),
                color=(1.0, 0.0, 0.0, 0.3),
            )
        )
        image = renderer.render(commands)
        xy = model_xy()
        r = np.hypot(xy[..., 0] - 32, xy[..., 1] - 32)
        inside_circle = np.mean(r <= 16, axis=-1)
        # Green only inside circle ∩ rect (rect covers the circle fully).
        # Probe above the translated red rect (model y=40 → row 24).
        assert np.allclose(image[24, 32, 1], 1.0, atol=1e-5)
        assert image[32, 12, 1] < 0.05  # inside rect, outside circle: no green
        # Green matches the circle mask except where the final red cover
        # (alpha 0.3) attenuated it.
        green = image[..., 1]
        attenuated = inside_circle * np.where(image[..., 0] > 0, 0.7, 1.0)
        assert np.mean(np.abs(green - attenuated)) < 5e-3

    def test_clip_depth_overflow_raises(self):
        from contrast_renderer.error import ClipStackOverflow

        renderer = Renderer(
            Configuration(clip_nesting_counter_bits=1), SIZE, SIZE
        )
        shape = Shape([Path.from_rect((32, 32), (4, 4))])
        with pytest.raises(ClipStackOverflow):
            renderer.render(
                [
                    DrawCommand(
                        RenderOperation.STENCIL, shape, ortho(), clip_depth=2
                    )
                ]
            )


class TestOpacityGroups:
    def test_group_opacity_front_to_back(self):
        renderer = Renderer(
            Configuration(alpha_layer_count=1, blending="front_to_back"),
            SIZE,
            SIZE,
        )
        rect = Shape([Path.from_rect((32, 32), (12, 12))])
        cover_all = Shape([Path.from_rect((32, 32), (32, 32))])
        g = 0.5
        commands = [
            # Front-to-back: the group content drawn first, scaled by g.
            # The alpha-context covers need no stencil: their LessEqual
            # stencil state passes across the whole hull
            # (renderer.rs:761-766).
            DrawCommand(
                RenderOperation.SAVE_ALPHA_CONTEXT,
                cover_all,
                ortho(),
                alpha_layer=0,
            ),
            DrawCommand(
                RenderOperation.SCALE_ALPHA_CONTEXT,
                cover_all,
                ortho(),
                color=(0, 0, 0, g),
            ),
            *stencil_color(rect, ortho(), (1.0, 0.0, 0.0, 1.0)),
            DrawCommand(
                RenderOperation.RESTORE_ALPHA_CONTEXT,
                cover_all,
                ortho(),
                color=(0, 0, 0, g),
                alpha_layer=0,
            ),
            # Content behind the group, full blue.
            *stencil_color(cover_all, ortho(), (0.0, 0.0, 1.0, 1.0)),
        ]
        image = renderer.render(commands)
        # Inside the rect: red at opacity g over blue behind.
        assert np.allclose(image[32, 32], [g, 0, 1 - g, 1.0], atol=1e-4)
        # Outside the rect: pure blue.
        assert np.allclose(image[10, 10], [0, 0, 1, 1], atol=1e-4)


class TestDashAnimation:
    def test_phase_update_does_not_retrace(self, renderer):
        def dashed(phase):
            return DynamicStrokeOptions.make_dashed(
                Join.MITER,
                [DashInterval(gap_start=2.0, gap_end=4.0)],
                phase=phase,
            )

        p = Path(
            start=(6, 32),
            stroke_options=StrokeOptions(width=6.0),
        )
        p.push_line(LineSegment([(58, 32)]))
        shape = Shape([p], [dashed(0.0)])
        commands = stencil_color(shape, ortho(), (1, 1, 1, 1))
        before = len(renderer._executors)
        image0 = renderer.render(commands)
        shape.set_dynamic_stroke_options(0, dashed(2.0))
        image1 = renderer.render(commands)
        # Phase shift by 2 widths = 12px: dash pattern moved.
        assert (np.abs(image0[..., 3] - image1[..., 3]) > 0.5).sum() > 50
        # Only one executor signature was (re)used for both frames.
        assert len(renderer._executors) - before <= 1


class TestNearPlaneClipping:
    def test_stencil_triangles_crossing_near_plane_keep_visible_part(self):
        """A filled rect straddling w = 0 renders its visible half.

        The reference relies on GPU hardware near-plane clipping; here
        `prepare` Sutherland-Hodgman-clips crossing stencil triangles
        (cover hulls were already clipped).  Both fan triangles of this
        rect cross the plane, so the pre-clip behavior rendered nothing.
        """
        renderer = Renderer(Configuration(), SIZE, SIZE)
        rect = Shape([Path.from_rect((0.0, 0.0), (0.8, 2.0))])
        # clip = (x, y, 0, y + 0.5): vertices at y = -2 are behind the
        # camera, vertices at y = +2 in front.
        transform = np.array(
            [
                [1.0, 0.0, 0.0, 0.0],
                [0.0, 1.0, 0.0, 0.0],
                [0.0, 0.0, 0.0, 0.0],
                [0.0, 1.0, 0.0, 0.5],
            ],
            np.float32,
        )
        image = renderer.render(
            stencil_color(rect, transform, (1.0, 1.0, 1.0, 1.0))
        )
        assert np.isfinite(image).all()
        # ndc (0, 0) maps to model (0, 0, w=0.5): inside, in front.
        assert image[SIZE // 2, SIZE // 2, 3] == 1.0
        # ndc (0, -0.9) maps to model y ~ -0.237, w ~ 0.26: covered.
        assert image[int(0.95 * SIZE / 2 * 2) - 2, SIZE // 2, 3] == 1.0
        # ndc (0, +0.9) needs model y = 4.5: outside the rect.
        assert image[3, SIZE // 2, 3] == 0.0
        # The stats counter reports the crossings.
        assert renderer.stats["near_plane_crossings"] == 2

    def test_fully_behind_is_culled(self):
        renderer = Renderer(Configuration(), SIZE, SIZE)
        rect = Shape([Path.from_rect((0.0, 0.0), (1.0, 1.0))])
        transform = np.array(
            [
                [1.0, 0.0, 0.0, 0.0],
                [0.0, 1.0, 0.0, 0.0],
                [0.0, 0.0, 0.0, 0.0],
                [0.0, 0.0, 0.0, -1.0],
            ],
            np.float32,
        )
        image = renderer.render(
            stencil_color(rect, transform, (1.0, 1.0, 1.0, 1.0))
        )
        assert (image == 0.0).all()


@pytest.mark.slow  # fast gate keeps one compile per feature area; full battery in CI device-slow
class TestClipAlphaInterplay:
    def test_opacity_group_inside_clip(self):
        """Opacity-group save/scale/restore nested inside a clip region
        (the reference's stencil x alpha interplay, renderer.rs:756-861):
        group content must dim only where the clip admits it."""
        renderer = Renderer(
            Configuration(alpha_layer_count=1, blending="front_to_back"),
            SIZE,
            SIZE,
        )
        # Clip: left half of the screen.
        clip_rect = Shape([Path.from_rect((16, 32), (16, 32))])
        content = Shape([Path.from_rect((32, 32), (28, 8))])
        cover_all = Shape([Path.from_rect((32, 32), (32, 32))])
        g = 0.25
        commands = [
            DrawCommand(RenderOperation.STENCIL, clip_rect, ortho()),
            DrawCommand(RenderOperation.CLIP, clip_rect, ortho(), clip_depth=1),
            DrawCommand(
                RenderOperation.SAVE_ALPHA_CONTEXT, cover_all, ortho(),
                alpha_layer=0, clip_depth=1,
            ),
            DrawCommand(
                RenderOperation.SCALE_ALPHA_CONTEXT, cover_all, ortho(),
                color=(0, 0, 0, g), clip_depth=1,
            ),
            DrawCommand(
                RenderOperation.STENCIL, content, ortho(), clip_depth=1
            ),
            DrawCommand(
                RenderOperation.COLOR, content, ortho(),
                color=(1.0, 0.0, 0.0, 1.0), clip_depth=1,
            ),
            DrawCommand(
                RenderOperation.RESTORE_ALPHA_CONTEXT, cover_all, ortho(),
                color=(0, 0, 0, g), alpha_layer=0, clip_depth=1,
            ),
            DrawCommand(
                RenderOperation.UNCLIP, clip_rect, ortho(), clip_depth=0
            ),
            # Backdrop behind everything, full green.
            *stencil_color(cover_all, ortho(), (0.0, 1.0, 0.0, 1.0)),
        ]
        image = renderer.render(commands)
        # Inside clip & content: red at opacity g over green.
        assert np.allclose(image[32, 10], [g, 1 - g, 0, 1], atol=1e-4), (
            image[32, 10]
        )
        # Outside the clip but inside content's hull: pure green (the
        # clip must gate the group content AND the alpha covers).
        assert np.allclose(image[32, 50], [0, 1, 0, 1], atol=1e-4), (
            image[32, 50]
        )
        # Inside clip, outside content: pure green.
        assert np.allclose(image[10, 10], [0, 1, 0, 1], atol=1e-4)


@pytest.mark.slow  # fast gate keeps one compile per feature area; full battery in CI device-slow
class TestKernelSpecializations:
    """The kernel compiles specialized variants per frame signature
    (no-clip/no-alpha frames, stroke batch width); their semantics must
    be identical to the general paths."""

    def test_nonzero_depth_without_clip_commands_masks(self, renderer):
        """With no CLIP/UNCLIP in the frame the clip buffer is zero, so
        commands at clip_depth > 0 must be complete no-ops (the
        specialized kernel folds this into a scalar depth test)."""
        disc = Shape([Path.from_circle((32.0, 32.0), 20.0)])
        commands = [
            DrawCommand(
                RenderOperation.STENCIL, disc, ortho(), clip_depth=1
            ),
            DrawCommand(
                RenderOperation.COLOR, disc, ortho(),
                color=(1.0, 0.0, 0.0, 1.0), clip_depth=1,
            ),
        ]
        image = renderer.render(commands)
        assert np.all(image == 0.0), "depth-1 draw leaked without clip"
        # Same commands at depth 0 do render.
        commands0 = stencil_color(disc, ortho(), (1.0, 0.0, 0.0, 1.0))
        image0 = renderer.render(commands0)
        assert image0[32, 32, 3] == 1.0

    def test_stroke_batch_widths_agree(self):
        """stroke_batch > 1 (batched geometry + per-entry predicates)
        must reproduce the stroke_batch=1 image exactly, across solid,
        single-interval-dash, and joint-heavy content."""
        dashed = DynamicStrokeOptions.make_dashed(
            Join.ROUND,
            [DashInterval(2.0, 3.0, Cap.ROUND, Cap.OUT)],
            0.5,
        )
        solid = DynamicStrokeOptions.make_solid(
            Join.MITER, Cap.SQUARE, Cap.IN
        )
        zigzag = Path.from_polygon(
            [(8.0, 8.0), (30.0, 50.0), (40.0, 12.0), (56.0, 40.0)]
        )
        zigzag.stroke_options = StrokeOptions(
            width=5.0, dynamic_stroke_options_group=0
        )
        ring = Path.from_circle((32.0, 32.0), 32.0)
        ring.stroke_options = StrokeOptions(
            width=4.0, closed=True, dynamic_stroke_options_group=1
        )
        shape = Shape([zigzag, ring], [dashed, solid])
        commands = stencil_color(shape, ortho(), (0.2, 0.5, 1.0, 0.9))
        images = []
        for sb in (1, 2, 4):
            r = Renderer(Configuration(), SIZE, SIZE, stroke_batch=sb)
            images.append(np.asarray(r.render(commands)))
        assert np.array_equal(images[0], images[1])
        assert np.array_equal(images[0], images[2])
        assert images[0][..., 3].max() > 0.5  # something rendered

    def test_additive_blending(self):
        """Configuration(blending="additive"): src ONE + dst ONE — the
        third blend state reference users configure (renderer.rs:381)."""
        r = Renderer(Configuration(blending="additive"), SIZE, SIZE)
        left = Shape([Path.from_circle((28.0, 32.0), 12.0)])
        right = Shape([Path.from_circle((36.0, 32.0), 12.0)])
        commands = (
            stencil_color(left, ortho(), (0.25, 0.0, 0.0, 1.0))
            + stencil_color(right, ortho(), (0.0, 0.5, 0.0, 1.0))
        )
        image = r.render(commands)
        # Overlap region: channel sums.
        assert np.allclose(image[32, 32, :3], [0.25, 0.5, 0.0], atol=1e-5)
        assert np.isclose(image[32, 32, 3], 2.0, atol=1e-5)  # unclamped
        # Disjoint parts keep their own color.
        assert np.allclose(image[32, 18, :3], [0.25, 0.0, 0.0], atol=1e-5)
        assert np.allclose(image[32, 46, :3], [0.0, 0.5, 0.0], atol=1e-5)

    def test_custom_blend_state_matches_named_mode(self):
        """An explicit BlendState spelling of premultiplied OVER renders
        identically to the "back_to_front" shorthand (the generic wgpu
        blend path, reference renderer.rs:381)."""
        from contrast_renderer.renderer import (
            BlendComponent,
            BlendState,
        )

        shape = Shape([Path.from_circle((30.0, 32.0), 14.0)])
        other = Shape([Path.from_circle((38.0, 32.0), 14.0)])
        commands = (
            stencil_color(shape, ortho(), (0.8, 0.2, 0.1, 0.7))
            + stencil_color(other, ortho(), (0.1, 0.3, 0.9, 0.5))
        )
        named = np.asarray(
            Renderer(
                Configuration(blending="back_to_front"), SIZE, SIZE
            ).render(commands)
        )
        over = BlendComponent("one", "add", "one_minus_src_alpha")
        explicit = np.asarray(
            Renderer(
                Configuration(blending=BlendState(over, over)), SIZE, SIZE
            ).render(commands)
        )
        assert np.array_equal(named, explicit)

    def test_custom_blend_dst_alpha_factor(self):
        """color src·dst_alpha + dst with alpha src·1 + dst·0: color
        only lands where prior draws left alpha, and the dst_alpha
        factor reads the pre-draw destination (wgpu ordering)."""
        from contrast_renderer.renderer import (
            BlendComponent,
            BlendState,
        )

        state = BlendState(
            color=BlendComponent("dst_alpha", "add", "one"),
            alpha=BlendComponent("one", "add", "zero"),
        )
        r = Renderer(Configuration(blending=state), SIZE, SIZE)
        left = Shape([Path.from_circle((28.0, 32.0), 12.0)])
        right = Shape([Path.from_circle((36.0, 32.0), 12.0)])
        image = np.asarray(
            r.render(
                stencil_color(left, ortho(), (1.0, 0.0, 0.0, 1.0))
                + stencil_color(right, ortho(), (0.0, 0.5, 0.0, 1.0))
            )
        )
        # First draw lands on empty canvas: dst_alpha=0 kills its color.
        assert np.allclose(image[32, 18, :3], 0.0, atol=1e-5)
        assert np.isclose(image[32, 18, 3], 1.0, atol=1e-5)
        # Overlap: second draw sees dst_alpha=1 → green lands.
        assert np.allclose(image[32, 32, :3], [0.0, 0.5, 0.0], atol=1e-5)
        # Right-only region: dst_alpha=0 again → color stays empty.
        assert np.allclose(image[32, 46, :3], 0.0, atol=1e-5)
        assert np.isclose(image[32, 46, 3], 1.0, atol=1e-5)

    def test_custom_blend_max_ignores_factors(self):
        """`max` keeps the channel-wise maximum regardless of factors
        (wgpu: min/max ignore blend factors)."""
        from contrast_renderer.renderer import (
            BlendComponent,
            BlendState,
        )

        comp = BlendComponent("zero", "max", "zero")  # factors ignored
        r = Renderer(
            Configuration(blending=BlendState(comp, comp)), SIZE, SIZE
        )
        left = Shape([Path.from_circle((28.0, 32.0), 12.0)])
        right = Shape([Path.from_circle((36.0, 32.0), 12.0)])
        image = np.asarray(
            r.render(
                stencil_color(left, ortho(), (0.25, 0.0, 0.0, 1.0))
                + stencil_color(right, ortho(), (0.0, 0.5, 0.0, 1.0))
            )
        )
        assert np.allclose(
            image[32, 32], [0.25, 0.5, 0.0, 1.0], atol=1e-5
        )
        assert np.allclose(image[32, 18], [0.25, 0.0, 0.0, 1.0], atol=1e-5)

    def test_constant_blend_factor_runtime(self):
        """``constant`` reads the runtime blend-constant color
        (wgpu set_blend_constant); updating it re-renders without a
        recompile (completing wgpu::BlendFactor, renderer.rs:381)."""
        from contrast_renderer.renderer import (
            BlendComponent,
            BlendState,
        )

        state = BlendState(
            color=BlendComponent("constant", "add", "zero"),
            alpha=BlendComponent("one", "add", "zero"),
        )
        r = Renderer(Configuration(blending=state), SIZE, SIZE)
        r.set_blend_constant((0.5, 0.25, 1.0, 1.0))
        shape = Shape([Path.from_circle((32.0, 32.0), 14.0)])
        commands = stencil_color(shape, ortho(), (1.0, 1.0, 1.0, 0.8))
        image = np.asarray(r.render(commands))
        # src premultiplied = 0.8 each channel; out rgb = src·const.
        assert np.allclose(
            image[32, 32], [0.4, 0.2, 0.8, 0.8], atol=1e-5
        )
        r.set_blend_constant((0.1, 1.0, 0.0, 1.0))
        image2 = np.asarray(r.render(commands))
        assert np.allclose(
            image2[32, 32], [0.08, 0.8, 0.0, 0.8], atol=1e-5
        )
        assert len(r._executors) == 1  # constant change never retraces

    def test_blend_constant_animates_through_frame_program(self):
        """wgpu's set_blend_constant is render-pass *dynamic* state: a
        compiled FrameProgram must honor per-frame constant updates
        without a rebuild or retrace (renderer.rs:381 +
        RenderPass::set_blend_constant)."""
        from contrast_renderer.renderer import (
            BlendComponent,
            BlendState,
        )

        state = BlendState(
            color=BlendComponent("constant", "add", "zero"),
            alpha=BlendComponent("one", "add", "zero"),
        )
        r = Renderer(Configuration(blending=state), SIZE, SIZE)
        r.set_blend_constant((0.5, 0.25, 1.0, 1.0))
        shape = Shape([Path.from_circle((32.0, 32.0), 14.0)])
        commands = stencil_color(shape, ortho(), (1.0, 1.0, 1.0, 0.8))
        program = r.compile_frame(commands)
        build_count = len(r._executors)
        image = np.asarray(program())
        assert np.allclose(image[32, 32], [0.4, 0.2, 0.8, 0.8], atol=1e-5)
        for const, want in (
            ((0.1, 1.0, 0.0, 1.0), [0.08, 0.8, 0.0, 0.8]),
            ((1.0, 0.0, 0.5, 1.0), [0.8, 0.0, 0.4, 0.8]),
        ):
            r.set_blend_constant(const)
            image = np.asarray(program())
            assert np.allclose(image[32, 32], want, atol=1e-5)
        # Animating the constant never rebuilt the program's executors.
        assert len(r._executors) == build_count

    def test_one_minus_constant_blend_factor(self):
        from contrast_renderer.renderer import (
            BlendComponent,
            BlendState,
        )

        state = BlendState(
            color=BlendComponent("one_minus_constant", "add", "zero"),
            alpha=BlendComponent("one", "add", "zero"),
        )
        r = Renderer(Configuration(blending=state), SIZE, SIZE)
        r.set_blend_constant((0.25, 0.5, 1.0, 0.0))
        shape = Shape([Path.from_circle((32.0, 32.0), 14.0)])
        image = np.asarray(
            r.render(stencil_color(shape, ortho(), (1.0, 1.0, 1.0, 1.0)))
        )
        assert np.allclose(
            image[32, 32], [0.75, 0.5, 0.0, 1.0], atol=1e-5
        )

    def test_src_alpha_saturated_blend_factor(self):
        """``src_alpha_saturated``: min(αs, 1−αd) on RGB, 1 on alpha —
        the classic saturating accumulation (wgpu::BlendFactor)."""
        from contrast_renderer.renderer import (
            BlendComponent,
            BlendState,
        )

        state = BlendState(
            color=BlendComponent("src_alpha_saturated", "add", "one"),
            alpha=BlendComponent("one", "add", "zero"),
        )
        r = Renderer(Configuration(blending=state), SIZE, SIZE)
        left = Shape([Path.from_circle((28.0, 32.0), 12.0)])
        right = Shape([Path.from_circle((36.0, 32.0), 12.0)])
        image = np.asarray(
            r.render(
                stencil_color(left, ortho(), (1.0, 0.0, 0.0, 0.6))
                + stencil_color(right, ortho(), (0.0, 1.0, 0.0, 0.9))
            )
        )
        # Left-only: empty canvas ⇒ factor = min(0.6, 1) = 0.6 over
        # premultiplied red 0.6 ⇒ 0.36; alpha replaced with 0.6.
        assert np.allclose(image[32, 18], [0.36, 0.0, 0.0, 0.6], atol=1e-5)
        # Overlap: dst alpha 0.6 ⇒ factor = min(0.9, 0.4) = 0.4 over
        # premultiplied green 0.9 ⇒ 0.36 added to dst rgb.
        assert np.allclose(
            image[32, 32], [0.36, 0.36, 0.0, 0.9], atol=1e-5
        )
        # Right-only: factor = min(0.9, 1) = 0.9 ⇒ green 0.81.
        assert np.allclose(image[32, 46], [0.0, 0.81, 0.0, 0.9], atol=1e-5)

    def test_blend_constant_validation(self):
        r = Renderer(Configuration(), SIZE, SIZE)
        with pytest.raises(ValueError):
            r.set_blend_constant((0.5, 0.5, 0.5))
        with pytest.raises(ValueError):
            r.set_blend_constant((0.5, np.nan, 0.5, 1.0))


def ortho_z(z, size=SIZE):
    """ortho() with the model plane pushed to NDC depth ``z``."""
    t = ortho(size)
    t[2, 3] = z
    return t


class TestDepth:
    """Per-sample depth buffer (reference Configuration.depth_compare /
    depth_write_enabled, renderer.rs:387-392; only the color cover
    tests/writes depth — every other reference pipeline is
    Always/no-write, renderer.rs:601-841)."""

    @staticmethod
    def _depth_scene():
        near = Shape([Path.from_circle((28.0, 32.0), 14.0)])
        far = Shape([Path.from_circle((40.0, 32.0), 14.0)])
        return (
            stencil_color(near, ortho_z(0.3), (1.0, 0.0, 0.0, 1.0))
            + stencil_color(far, ortho_z(0.7), (0.0, 1.0, 0.0, 1.0))
        )

    def test_less_equal_with_write_occludes_later_draws(self):
        """The classic z-buffer: a farther shape drawn later loses to
        the nearer ink already present (the reference showcase's
        LessEqual + write state, examples/showcase/main.rs:46-49)."""
        commands = self._depth_scene()
        r = Renderer(
            Configuration(
                depth_compare="less_equal", depth_write_enabled=True
            ),
            SIZE, SIZE,
        )
        image = np.asarray(r.render(commands))
        assert np.allclose(image[32, 34], [1, 0, 0, 1], atol=1e-5)  # near wins
        assert np.allclose(image[32, 48], [0, 1, 0, 1], atol=1e-5)  # far alone
        assert np.allclose(image[32, 20], [1, 0, 0, 1], atol=1e-5)
        # Default state (depth compiled out): command order rules.
        plain = np.asarray(Renderer(Configuration(), SIZE, SIZE)
                           .render(commands))
        assert np.allclose(plain[32, 34], [0, 1, 0, 1], atol=1e-5)

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_greater_without_write_keeps_both(self):
        """compare=greater passes the farther-drawn shape everywhere
        (dst cleared to 1.0 never updates without write, so the nearer
        first draw passes nothing... greater against clear 1.0 fails for
        all z<1; nothing draws)."""
        commands = self._depth_scene()
        r = Renderer(
            Configuration(depth_compare="greater"), SIZE, SIZE
        )
        image = np.asarray(r.render(commands))
        assert np.allclose(image, 0.0, atol=1e-6)

    def test_depth_compare_validation(self):
        with pytest.raises(ValueError):
            Configuration(depth_compare="sometimes")

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_depth_inside_clip(self):
        """Depth and clip compose: inside the clip region the z-buffer
        occludes the later far draw, outside it nothing draws at all
        (color covers honor both the stencil/clip test and the depth
        test, as the reference's combined stencil+depth state does)."""
        clip_shape = Shape([Path.from_rect((32.0, 32.0), (16.0, 32.0))])
        near = Shape([Path.from_circle((28.0, 32.0), 14.0)])
        far = Shape([Path.from_circle((40.0, 32.0), 14.0)])
        commands = [
            DrawCommand(RenderOperation.STENCIL, clip_shape, ortho()),
            DrawCommand(
                RenderOperation.CLIP, clip_shape, ortho(), clip_depth=1
            ),
        ]
        for shape, z, color in (
            (near, 0.3, (1.0, 0.0, 0.0, 1.0)),
            (far, 0.7, (0.0, 1.0, 0.0, 1.0)),
        ):
            commands += [
                DrawCommand(
                    RenderOperation.STENCIL, shape, ortho_z(z),
                    clip_depth=1,
                ),
                DrawCommand(
                    RenderOperation.COLOR, shape, ortho_z(z),
                    color=color, clip_depth=1,
                ),
            ]
        commands.append(
            DrawCommand(
                RenderOperation.UNCLIP, clip_shape, ortho(), clip_depth=0
            )
        )
        r = Renderer(
            Configuration(
                depth_compare="less_equal", depth_write_enabled=True
            ),
            SIZE, SIZE,
        )
        image = np.asarray(r.render(commands))
        # Clip rect spans x in [16, 48].  Overlap inside clip: near wins.
        assert np.allclose(image[32, 34], [1, 0, 0, 1], atol=1e-5)
        # Far-circle ink outside the clip (x=50 < 54): nothing.
        assert np.allclose(image[32, 50], 0.0, atol=1e-6)
        # Far circle inside clip past the near ink (x=45 > 42): green.
        assert np.allclose(image[32, 45], [0, 1, 0, 1], atol=1e-5)

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_showcase_depth_state_matches_reference_semantics(self):
        """Pin the depth decision (r2 verdict §missing 3): under the
        reference showcase's LessEqual+write state
        (examples/showcase/main.rs:46-49) and its real perspective
        instance matrices, the later-drawn middle grid instance (NDC
        z≈0.93, directly behind the center) is occluded by the
        first-drawn near center instance's ink (z≈0.80) — which plain
        command-order compositing gets wrong.  At test resolution the
        showcase's hairline glyph/stroke inks never overlap, so the pin
        uses the showcase's transforms on a solid fill of its rounded
        rect (the occlusion claim is about the camera/depth state, not
        the ink width)."""
        from contrast_renderer.models import showcase

        size = 64
        solid = Shape(
            [Path.from_rounded_rect((0.0, 0.0), (5.8, 1.3), 0.5)]
        )
        transforms, _ = showcase.instance_transforms_and_colors(size, size)
        t_center = np.ascontiguousarray(transforms[0], np.float32)
        t_mid = np.ascontiguousarray(transforms[23], np.float32)
        commands = (
            stencil_color(solid, t_center, (1.0, 1.0, 1.0, 1.0))
            + stencil_color(solid, t_mid, (1.0, 0.0, 0.0, 1.0))
        )
        depth_cfg = Configuration(
            depth_compare="less_equal", depth_write_enabled=True
        )
        with_depth = np.asarray(
            Renderer(depth_cfg, size, size).render(commands)
        )
        plain_renderer = Renderer(Configuration(), size, size)
        plain = np.asarray(plain_renderer.render(commands))
        center_only = np.asarray(plain_renderer.render(commands[:2]))
        # Interior of the center instance's ink: fully covered pixels.
        interior = center_only[..., 3] >= 1.0 - 1e-6
        # The later-drawn farther instance overdraws it in command
        # order...
        overdrawn = interior & (
            np.abs(plain - center_only).max(axis=-1) > 1e-4
        )
        assert overdrawn.sum() > 20, "mid instance must overlap center ink"
        # ...but under the reference's depth state the center wins
        # everywhere its ink lies.
        assert np.allclose(
            with_depth[interior], center_only[interior], atol=1e-5
        ), np.abs(with_depth[interior] - center_only[interior]).max()


@pytest.mark.slow  # fast gate keeps one compile per feature area; full battery in CI device-slow
class TestInstancing:
    """Single-draw instancing (reference instance_range + instance-rate
    transform/color attributes, renderer.rs:267, 462-466): a stencil
    command accumulates winding from all its instances, cover commands
    replay per-instance hull covers in instance order."""

    def test_instanced_equals_expanded_disjoint(self, renderer):
        shape = Shape([Path.from_rect((10, 32), (6, 6))])
        tfs = np.stack([ortho(), translate(20, 0), translate(40, 8)])
        colors = np.array(
            [[1, 0, 0, 1], [0, 1, 0, 0.5], [0, 0, 1, 0.25]], np.float32
        )
        instanced = renderer.render(
            [
                DrawCommand(RenderOperation.STENCIL, shape, tfs),
                DrawCommand(
                    RenderOperation.COLOR, shape, tfs, color=colors
                ),
            ]
        )
        expanded = []
        for i in range(3):
            expanded += stencil_color(shape, tfs[i], tuple(colors[i]))
        assert np.array_equal(instanced, renderer.render(expanded))
        assert instanced[..., 3].max() > 0.5

    def test_instanced_equals_grouped_overlapping(self, renderer):
        """Overlapping instances: winding accumulates across ALL
        instances before any cover — matching the grouped expansion
        [stencil×N, color×N], not interleaved pairs."""
        shape = Shape([Path.from_rect((30, 32), (16, 16))])
        tfs = np.stack([ortho(), translate(8, 4)])
        colors = np.array([[1, 0, 0, 1], [0, 0, 1, 0.5]], np.float32)
        instanced = renderer.render(
            [
                DrawCommand(RenderOperation.STENCIL, shape, tfs),
                DrawCommand(
                    RenderOperation.COLOR, shape, tfs, color=colors
                ),
            ]
        )
        grouped = renderer.render(
            [
                DrawCommand(RenderOperation.STENCIL, shape, tfs[0]),
                DrawCommand(RenderOperation.STENCIL, shape, tfs[1]),
                DrawCommand(
                    RenderOperation.COLOR, shape, tfs[0],
                    color=tuple(colors[0]),
                ),
                DrawCommand(
                    RenderOperation.COLOR, shape, tfs[1],
                    color=tuple(colors[1]),
                ),
            ]
        )
        assert np.array_equal(instanced, grouped)
        assert instanced[..., 3].max() > 0.5

    def test_shared_color_broadcasts(self, renderer):
        shape = Shape([Path.from_circle((8, 8), 5)])
        tfs = np.stack([ortho(), translate(16, 16), translate(32, 32)])
        one = renderer.render(
            [
                DrawCommand(RenderOperation.STENCIL, shape, tfs),
                DrawCommand(
                    RenderOperation.COLOR, shape, tfs, color=(0, 1, 0, 1)
                ),
            ]
        )
        many = renderer.render(
            [
                DrawCommand(RenderOperation.STENCIL, shape, tfs),
                DrawCommand(
                    RenderOperation.COLOR, shape, tfs,
                    color=np.tile(
                        np.asarray([0, 1, 0, 1], np.float32), (3, 1)
                    ),
                ),
            ]
        )
        assert np.array_equal(one, many)

    def test_mismatched_color_count_raises(self, renderer):
        shape = Shape([Path.from_circle((8, 8), 5)])
        tfs = np.stack([ortho(), translate(16, 16)])
        with pytest.raises(ValueError):
            renderer.render(
                [
                    DrawCommand(RenderOperation.STENCIL, shape, tfs),
                    DrawCommand(
                        RenderOperation.COLOR, shape, tfs,
                        color=np.zeros((3, 4), np.float32),
                    ),
                ]
            )


@pytest.mark.slow  # fast gate keeps one compile per feature area; full battery in CI device-slow
class TestCarryProbe:
    """The fused completion probe: render(carry=...) and
    FrameProgram(..., carry=...) return (image, carry + sum(alpha))
    computed in the frame's own dispatch."""

    def test_render_carry_matches_alpha_sum(self, renderer):
        import jax.numpy as jnp

        shape = Shape([Path.from_circle((32.0, 32.0), 16.0)])
        commands = stencil_color(shape, ortho(), (1.0, 0.0, 0.0, 1.0))
        image = np.asarray(renderer.render(commands))
        out, acc = renderer.render(commands, carry=jnp.float32(1.5))
        assert np.array_equal(np.asarray(out), image)
        assert np.isclose(float(acc), 1.5 + image[..., 3].sum(), rtol=1e-5)
        # Chaining accumulates.
        _, acc2 = renderer.render(commands, carry=acc)
        assert np.isclose(
            float(acc2), 1.5 + 2 * image[..., 3].sum(), rtol=1e-5
        )

    def test_frame_program_carry(self):
        import jax.numpy as jnp

        from contrast_renderer.models import showcase

        size = 64
        r = Renderer(Configuration(), size, size)
        shape = showcase.build_shape(with_text=False)
        commands = showcase.showcase_commands(shape, size, size)[:4]
        program = r.compile_frame(commands)
        plain = np.asarray(program())
        image, acc = program(carry=jnp.float32(0.0))
        assert np.array_equal(np.asarray(image), plain)
        assert np.isclose(float(acc), plain[..., 3].sum(), rtol=1e-5)

    def test_frame_program_shrinks_capacities_to_scene(self):
        """The settle frame's counters size the compiled program's
        binning buffers (next-pow2 with margin), not the renderer's
        worst-case defaults — the dense per-tile materialization and
        the kernel's per-tile DMA blocks scale with this capacity
        every frame."""
        from contrast_renderer.models import showcase

        size = 64
        r = Renderer(Configuration(), size, size)
        shape = showcase.build_shape(with_text=False)
        commands = showcase.showcase_commands(shape, size, size)[:4]
        program = r.compile_frame(commands)
        assert program._spec.capacity < r.tile_capacity
        assert program._spec.capacity >= 32  # floor
        want = np.asarray(r.render(commands))
        assert np.allclose(np.asarray(program()), want, atol=1e-6)

    def test_frame_program_self_heals_after_capacity_shrink(self):
        """A scene that outgrows the shrunk-to-fit capacities triggers
        the deferred rebuild with grown program-local capacities
        (never clamped back down by the fit)."""
        from contrast_renderer.models import showcase

        size = 64
        r = Renderer(Configuration(), size, size)
        shape = showcase.build_shape(with_text=False)
        commands = showcase.showcase_commands(shape, size, size)[:4]
        program = r.compile_frame(commands)
        # The NATURAL frame's demand (compile_frame leaves the
        # probe-maxed settle stats on the renderer; the rebuild below
        # only ever sees the natural frame's overflow counters).
        r.render(commands, to_host=False)
        demand = r.stats["max_tile_entries"]
        assert demand > 1, "scene too sparse to exercise overflow"
        want = np.asarray(program())
        # Fault injection: under-provision the per-tile capacity and
        # rebuild, simulating a camera sweep past the settle frame's
        # counts.
        program._caps["capacity"] = 1
        program._pending.clear()  # only the injected build's counters
        program._build()
        assert program._spec.capacity == 1
        program.OVERFLOW_MAX_LAG = 0  # consume counters synchronously
        program()  # overflows (possibly under-populated)
        healed = np.asarray(program())  # consumed counter → rebuild
        assert program._caps["capacity"] >= demand
        assert np.allclose(healed, want, atol=1e-6), (
            np.abs(healed - want).max()
        )

    def test_frame_program_uint8_output_matches_quantized_float(self):
        """uint8_output=True resolves to packed RGBA8 inside the kernel
        (the swapchain presentation format; reference surfaces are
        8-bit) — bit-identical to quantizing the float program's output,
        including under a moved camera and with a carry probe."""
        import jax.numpy as jnp

        from contrast_renderer.models import showcase

        size = 64
        r = Renderer(Configuration(), size, size)
        shape = showcase.build_shape(with_text=False)
        commands = showcase.showcase_commands(shape, size, size)[:4]
        fprog = r.compile_frame(commands)
        uprog = r.compile_frame(commands, uint8_output=True)
        want = np.asarray(Renderer._quantize(fprog()))
        got = np.asarray(uprog())
        assert got.dtype == np.uint8 and got.shape == (size, size, 4)
        assert np.array_equal(got, want)
        # Camera motion (runtime transforms) and the carry probe.
        rotor = np.array([np.cos(0.1), 0.0, np.sin(0.1), 0.0])
        moved = showcase.command_transforms(
            size, size, view_rotation=rotor
        )[: len(commands)]
        want2 = np.asarray(Renderer._quantize(fprog(moved)))
        got2, acc = uprog(moved, carry=jnp.float32(0.0))
        got2 = np.asarray(got2)
        assert np.array_equal(got2, want2)
        assert np.isclose(
            float(acc), got2[..., 3].astype(np.float64).sum(), rtol=1e-5
        )

    def test_render_uint8_kernel_matches_quantized_float(self):
        """Renderer.render(uint8_kernel=True): packed RGBA8 resolve in
        the kernel with the cached-binning path (the static-camera
        presentation route) — bit-identical to quantizing the float
        render; shares the prepared (binning) cache with the float
        path; composes with the carry probe; rejects background."""
        from contrast_renderer.models import showcase

        size = 64
        r = Renderer(Configuration(), size, size)
        shape = showcase.build_shape(with_text=False)
        commands = showcase.showcase_commands(shape, size, size)[:4]
        flt = r.render(commands)
        n_prepared = len(r._prepared_cache)
        got = r.render(commands, uint8_kernel=True)
        # Binning was reused, not recomputed under a different key.
        assert len(r._prepared_cache) == n_prepared
        want = (np.clip(flt, 0, 1) * 255.0 + 0.5).astype(np.uint8)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
        img, acc = r.render(
            commands, to_host=False, carry=0.0, uint8_kernel=True
        )
        img = np.asarray(img)
        assert img.dtype == np.uint8 and np.array_equal(img, want)
        assert np.isclose(
            float(acc), want[..., 3].astype(np.float64).sum(), rtol=1e-5
        )
        with pytest.raises(ValueError):
            r.render(
                commands, uint8_kernel=True, background=np.zeros(4)
            )


@pytest.mark.slow  # fast gate keeps one compile per feature area; full battery in CI device-slow
class TestSaveScaleFusion:
    """SaveAlphaContext + ScaleAlphaContext over the identical cover
    fuse into one kernel pass (coverage.OP_SAVE_SCALE); semantics must
    match the unfused sequence exactly."""

    @staticmethod
    def _shapes():
        rect = Shape([Path.from_rect((32, 32), (12, 12))])
        cover_all = Shape([Path.from_rect((32, 32), (32, 32))])
        return rect, cover_all

    @staticmethod
    def _group_commands(rect, cover_all, g, blocker=None):
        mid = [] if blocker is None else [blocker]
        return [
            DrawCommand(
                RenderOperation.SAVE_ALPHA_CONTEXT, cover_all, ortho(),
                alpha_layer=0,
            ),
            *mid,
            DrawCommand(
                RenderOperation.SCALE_ALPHA_CONTEXT, cover_all, ortho(),
                color=(0, 0, 0, g),
            ),
            *stencil_color(rect, ortho(), (1.0, 0.0, 0.0, 1.0)),
            DrawCommand(
                RenderOperation.RESTORE_ALPHA_CONTEXT, cover_all, ortho(),
                color=(0, 0, 0, g), alpha_layer=0,
            ),
            *stencil_color(cover_all, ortho(), (0.0, 0.0, 1.0, 1.0)),
        ]

    def test_optimizer_fuses_and_maps_rows(self):
        from contrast_renderer.ops import coverage
        from contrast_renderer.renderer import _optimize_commands

        rect, cover_all = self._shapes()
        commands = self._group_commands(rect, cover_all, 0.5)
        opt, keep = _optimize_commands(commands)
        assert [int(c.operation) for c in opt] == [
            coverage.OP_SAVE_SCALE, 0, 3, 6, 0, 3
        ]
        # The fused command keeps the SCALE's color (its alpha is the
        # group opacity) and drops the SAVE's transform row.
        assert np.asarray(opt[0].color)[3] == 0.5
        assert keep is not None and list(keep) == [1, 2, 3, 4, 5, 6]
        # A command between the pair blocks fusion.
        blocker = DrawCommand(
            RenderOperation.STENCIL, rect, translate(10 * SIZE, 0)
        )
        blocked = self._group_commands(rect, cover_all, 0.5, blocker)
        opt2, keep2 = _optimize_commands(blocked)
        assert len(opt2) == len(blocked) and keep2 is None
        # Mismatched clip depth blocks fusion too.
        mixed = self._group_commands(rect, cover_all, 0.5)
        mixed[1] = DrawCommand(
            RenderOperation.SCALE_ALPHA_CONTEXT, cover_all, ortho(),
            color=(0, 0, 0, 0.5), clip_depth=1,
        )
        opt3, keep3 = _optimize_commands(mixed)
        assert len(opt3) == len(mixed) and keep3 is None

    def test_fused_matches_unfused_image(self):
        renderer = Renderer(
            Configuration(alpha_layer_count=1, blending="front_to_back"),
            SIZE, SIZE,
        )
        rect, cover_all = self._shapes()
        g = 0.5
        fused = renderer.render(self._group_commands(rect, cover_all, g))
        # An offscreen stencil between SAVE and SCALE blocks fusion and
        # contributes nothing visible.
        blocker = DrawCommand(
            RenderOperation.STENCIL, rect, translate(10 * SIZE, 0)
        )
        unfused = renderer.render(
            self._group_commands(rect, cover_all, g, blocker)
        )
        assert np.allclose(fused, unfused, atol=1e-6)
        assert np.allclose(fused[32, 32], [g, 0, 1 - g, 1.0], atol=1e-4)

    def test_frame_program_accepts_original_transform_layout(self):
        """FrameProgram's public transform stack keeps one row per
        original (command, instance) draw; fused-away SAVE rows are
        dropped internally."""
        r = Renderer(
            Configuration(alpha_layer_count=1, blending="front_to_back"),
            SIZE, SIZE,
        )
        rect, cover_all = self._shapes()
        commands = self._group_commands(rect, cover_all, 0.5)
        program = r.compile_frame(commands)
        default = np.asarray(program())
        explicit = np.asarray(
            program(transforms=Renderer._pack_transforms(commands))
        )
        assert np.array_equal(default, explicit)
        assert np.allclose(default[32, 32], [0.5, 0, 0.5, 1.0], atol=1e-4)


@pytest.mark.slow  # fast gate keeps one compile per feature area; full battery in CI device-slow
class TestGradientPaints:
    """Two-stop linear/radial gradient paints (extension:
    the reference's color cover is solid-only, shaders.wgsl:304-309).
    Validated per MSAA sample against the analytic interpolation."""

    def test_linear_gradient_matches_analytic(self, renderer):
        from contrast_renderer.renderer import LinearGradient

        rect = Shape([Path.from_rect((32, 32), (24, 24))])
        paint = LinearGradient(
            start=(16.0, 32.0), end=(48.0, 32.0),
            color0=(1.0, 0.0, 0.0, 1.0), color1=(0.0, 0.0, 1.0, 0.5),
        )
        image = renderer.render(
            [
                DrawCommand(RenderOperation.STENCIL, rect, ortho()),
                DrawCommand(
                    RenderOperation.COLOR, rect, ortho(), color=paint
                ),
            ]
        )
        xy = model_xy()
        t = np.clip((xy[..., 0] - 16.0) / 32.0, 0.0, 1.0)
        inside = (np.abs(xy[..., 0] - 32) <= 24) & (
            np.abs(xy[..., 1] - 32) <= 24
        )
        alpha = 1.0 + (0.5 - 1.0) * t
        want = np.stack(
            [
                (1.0 - t) * alpha,       # red, premultiplied
                np.zeros_like(t),
                t * alpha,               # blue, premultiplied
                alpha,
            ],
            axis=-1,
        ) * inside[..., None]
        assert np.abs(image - want.mean(axis=2)).max() < 1e-4

    def test_radial_gradient_matches_analytic(self, renderer):
        from contrast_renderer.renderer import RadialGradient

        disc = Shape([Path.from_circle((32.0, 32.0), 24.0)])
        paint = RadialGradient(
            center=(32.0, 32.0), edge=(52.0, 32.0),
            color0=(1.0, 1.0, 1.0, 1.0), color1=(0.0, 0.0, 0.0, 1.0),
        )
        image = renderer.render(
            [
                DrawCommand(RenderOperation.STENCIL, disc, ortho()),
                DrawCommand(
                    RenderOperation.COLOR, disc, ortho(), color=paint
                ),
            ]
        )
        xy = model_xy()
        rad = np.hypot(xy[..., 0] - 32.0, xy[..., 1] - 32.0)
        t = np.clip(rad / 20.0, 0.0, 1.0)
        # Interior (away from the AA edge): luminance = 1 - t.
        interior = rad < 22.0
        got = image[..., 0]
        want = np.mean(np.where(interior, 1.0 - t, 0.0), axis=-1)
        mask = np.mean(interior.astype(np.float64), axis=-1) == 1.0
        assert np.abs(np.where(mask, got - want, 0.0)).max() < 1e-4
        # Center bright, rim dark, monotone in between.
        assert image[32, 32, 0] > 0.95
        assert image[32, 50, 0] < 0.15

    def test_gradient_on_stroke(self, renderer):
        """Gradients apply to stroked shapes through the same COLOR
        cover (stroke coverage is winding like fills)."""
        from contrast_renderer.path import (
            Cap,
            Join,
            LineSegment,
            StrokeOptions,
        )
        from contrast_renderer.renderer import LinearGradient

        p = Path(start=(8, 32), stroke_options=StrokeOptions(width=8.0))
        p.push_line(LineSegment([(56, 32)]))
        shape = Shape(
            [p],
            [DynamicStrokeOptions.make_solid(Join.MITER, Cap.BUTT, Cap.BUTT)],
        )
        paint = LinearGradient(
            start=(8.0, 32.0), end=(56.0, 32.0),
            color0=(1.0, 0.0, 0.0, 1.0), color1=(0.0, 0.0, 1.0, 1.0),
        )
        image = renderer.render(
            [
                DrawCommand(RenderOperation.STENCIL, shape, ortho()),
                DrawCommand(
                    RenderOperation.COLOR, shape, ortho(), color=paint
                ),
            ]
        )
        # Left of the stroke: red; right: blue; middle: the mix.
        assert image[32, 10, 0] > 0.9 and image[32, 10, 2] < 0.1
        assert image[32, 54, 2] > 0.9 and image[32, 54, 0] < 0.1
        assert abs(image[32, 32, 0] - 0.5) < 0.05
        # Above the stroke band: nothing.
        assert image[20, 32, 3] == 0.0

    def test_instanced_gradient_per_instance(self, renderer):
        """One instanced command with a gradient paint: each instance's
        endpoints project through its own transform, so every copy
        carries its own gradient."""
        from contrast_renderer.renderer import LinearGradient

        rect = Shape([Path.from_rect((16, 16), (10, 10))])
        paint = LinearGradient(
            start=(6.0, 16.0), end=(26.0, 16.0),
            color0=(1.0, 0.0, 0.0, 1.0), color1=(0.0, 0.0, 1.0, 1.0),
        )
        stacked = np.stack([ortho(), translate(32, 32)])
        image = renderer.render(
            [
                DrawCommand(RenderOperation.STENCIL, rect, stacked),
                DrawCommand(
                    RenderOperation.COLOR, rect, stacked, color=paint
                ),
            ]
        )
        # Instance 1 at (16, 16) model = row 48 px; instance 2 at
        # (48, 48) model = row 16 px. Left edge red, right edge blue,
        # in BOTH copies.
        for row, col0, col1 in ((48, 8, 24), (16, 40, 56)):
            assert image[row, col0, 0] > 0.85, (row, col0)
            assert image[row, col0, 2] < 0.15
            assert image[row, col1, 2] > 0.85, (row, col1)
            assert image[row, col1, 0] < 0.15

    def test_frame_program_gradient_tracks_camera(self, renderer):
        """The gradient endpoints ride the per-frame transform stack:
        translating the draw moves the gradient with it."""
        from contrast_renderer.renderer import LinearGradient

        rect = Shape([Path.from_rect((32, 32), (16, 16))])
        paint = LinearGradient(
            start=(16.0, 32.0), end=(48.0, 32.0),
            color0=(1.0, 0.0, 0.0, 1.0), color1=(0.0, 1.0, 0.0, 1.0),
        )
        commands = [
            DrawCommand(RenderOperation.STENCIL, rect, ortho()),
            DrawCommand(RenderOperation.COLOR, rect, ortho(), color=paint),
        ]
        program = renderer.compile_frame(commands)
        base = np.asarray(program())
        assert np.allclose(base, renderer.render(commands), atol=1e-6)
        shifted = np.asarray(
            program(np.stack([translate(8, 0)] * 2))
        )
        # The paint moved with the shape: the shifted image equals the
        # base image translated 8px right (interior rows).
        assert np.allclose(
            shifted[:, 8:], base[:, :-8], atol=1e-5
        )

    def test_multi_stop_linear_gradient(self, renderer):
        from contrast_renderer.renderer import LinearGradient

        rect = Shape([Path.from_rect((32, 32), (28, 20))])
        stops = (
            (0.0, (1.0, 0.0, 0.0, 1.0)),
            (0.25, (0.0, 1.0, 0.0, 1.0)),
            (1.0, (0.0, 0.0, 1.0, 0.6)),
        )
        paint = LinearGradient(
            start=(8.0, 32.0), end=(56.0, 32.0), stops=stops
        )
        image = renderer.render(
            [
                DrawCommand(RenderOperation.STENCIL, rect, ortho()),
                DrawCommand(
                    RenderOperation.COLOR, rect, ortho(), color=paint
                ),
            ]
        )
        xy = model_xy()
        t = np.clip((xy[..., 0] - 8.0) / 48.0, 0.0, 1.0)
        offs = np.array([0.0, 0.25, 1.0, 1.0])
        cols = np.array([s[1] for s in stops] + [stops[-1][1]])
        rgba = np.broadcast_to(cols[0], t.shape + (4,)).copy()
        for i in range(3):
            f = np.clip(
                (t - offs[i]) / max(offs[i + 1] - offs[i], 1e-6), 0, 1
            )
            rgba = rgba + (cols[i + 1] - cols[i]) * f[..., None]
        inside = (np.abs(xy[..., 0] - 32) <= 28) & (
            np.abs(xy[..., 1] - 32) <= 20
        )
        want = np.concatenate(
            [rgba[..., :3] * rgba[..., 3:4], rgba[..., 3:4]], axis=-1
        ) * inside[..., None]
        assert np.abs(image - want.mean(axis=2)).max() < 1e-4
        # Too many stops raise.
        import pytest as _pytest

        with _pytest.raises(ValueError):
            LinearGradient(
                (0, 0), (1, 1),
                stops=tuple((i / 4, (0, 0, 0, 1)) for i in range(5)),
            )


@pytest.mark.slow  # fast gate keeps one compile per feature area; full battery in CI device-slow
class TestUserPaint:
    """renderer.UserPaint: user-supplied JAX-traceable paint functions
    compiled into the cover composite — the reference's user-defined
    shader hook (README.md:28-33 via custom wgpu pipelines,
    lib.rs:4-7)."""

    def test_checkerboard_matches_oracle(self, renderer):
        import jax.numpy as jnp

        from contrast_renderer.renderer import UserPaint

        def checker(px, py, anchor):
            c = ((jnp.floor(px / 8.0) + jnp.floor(py / 8.0)) % 2.0)
            return c, 1.0 - c, jnp.zeros_like(c), jnp.ones_like(c)

        rect = Shape([Path.from_rect((32, 32), (24, 24))])
        image = renderer.render(
            [
                DrawCommand(RenderOperation.STENCIL, rect, ortho()),
                DrawCommand(
                    RenderOperation.COLOR, rect, ortho(),
                    color=UserPaint(checker),
                ),
            ]
        )
        pos = oracle.sample_positions(SIZE, SIZE)   # screen space
        c = (np.floor(pos[..., 0] / 8.0) + np.floor(pos[..., 1] / 8.0)) % 2.0
        xy = model_xy()
        inside = (np.abs(xy[..., 0] - 32) <= 24) & (
            np.abs(xy[..., 1] - 32) <= 24
        )
        want = np.stack(
            [c, 1.0 - c, np.zeros_like(c), np.ones_like(c)], axis=-1
        ) * inside[..., None]
        assert np.abs(image - want.mean(axis=2)).max() < 1e-4

    def test_user_linear_ramp_matches_builtin_gradient(self, renderer):
        """A UserPaint re-implementing the 2-stop linear ramp through
        the anchor points must match LinearGradient (same projection,
        same per-sample math)."""
        import jax.numpy as jnp

        from contrast_renderer.renderer import (
            LinearGradient, UserPaint)

        c0 = (1.0, 0.0, 0.0, 1.0)
        c1 = (0.0, 0.0, 1.0, 0.5)

        def ramp(px, py, anchor):
            x0, y0, x1, y1 = anchor
            dx, dy = x1 - x0, y1 - y0
            den = jnp.maximum(dx * dx + dy * dy, 1e-12)
            t = jnp.clip(((px - x0) * dx + (py - y0) * dy) / den, 0.0, 1.0)
            return (
                c0[0] + (c1[0] - c0[0]) * t,
                c0[1] + (c1[1] - c0[1]) * t,
                c0[2] + (c1[2] - c0[2]) * t,
                c0[3] + (c1[3] - c0[3]) * t,
            )

        rect = Shape([Path.from_rect((32, 32), (24, 24))])

        def render_with(paint):
            return renderer.render(
                [
                    DrawCommand(RenderOperation.STENCIL, rect, ortho()),
                    DrawCommand(
                        RenderOperation.COLOR, rect, ortho(), color=paint
                    ),
                ]
            )

        user = render_with(
            UserPaint(ramp, points=((16.0, 32.0), (48.0, 32.0)))
        )
        builtin = render_with(
            LinearGradient(
                start=(16.0, 32.0), end=(48.0, 32.0),
                color0=c0, color1=c1,
            )
        )
        assert np.abs(user - builtin).max() < 1e-5

    def test_two_distinct_fns_in_one_frame(self, renderer):
        import jax.numpy as jnp

        from contrast_renderer.renderer import UserPaint

        def solid_red(px, py, anchor):
            one = jnp.ones_like(px)
            return one, 0.0 * one, 0.0 * one, one

        def solid_green(px, py, anchor):
            one = jnp.ones_like(px)
            return 0.0 * one, one, 0.0 * one, one

        a = Shape([Path.from_rect((16, 32), (10, 10))])
        b = Shape([Path.from_rect((48, 32), (10, 10))])
        image = renderer.render(
            stencil_color(a, ortho(), UserPaint(solid_red))
            + stencil_color(b, ortho(), UserPaint(solid_green))
        )
        xy = model_xy()
        in_a = (np.abs(xy[..., 0] - 16) <= 10) & (
            np.abs(xy[..., 1] - 32) <= 10
        )
        in_b = (np.abs(xy[..., 0] - 48) <= 10) & (
            np.abs(xy[..., 1] - 32) <= 10
        )
        want = np.stack(
            [
                in_a.astype(np.float32),
                in_b.astype(np.float32),
                np.zeros(in_a.shape, np.float32),
                (in_a | in_b).astype(np.float32),
            ],
            axis=-1,
        ).mean(axis=2)
        assert np.abs(image - want).max() < 1e-4


@pytest.mark.slow  # fast gate keeps one compile per feature area; full battery in CI device-slow
class TestRenderSequence:
    def test_sequence_matches_per_frame(self, renderer):
        """render_sequence (one dispatch, lax.scan over frames) produces
        the same pixels as per-frame FrameProgram calls."""
        shape = Shape([Path.from_rect((20, 32), (10, 10))])
        commands = stencil_color(shape, ortho(), (1.0, 0.2, 0.1, 1.0))
        program = renderer.compile_frame(commands)
        stacks = np.stack(
            [
                np.stack([translate(dx, 0)] * 2)
                for dx in (0.0, 8.0, 20.0)
            ]
        )
        frames = np.asarray(program.render_sequence(stacks))
        assert frames.shape == (3, SIZE, SIZE, 4)
        assert frames.dtype == np.uint8
        for i in range(3):
            want = np.asarray(
                Renderer._quantize(program(stacks[i]))
            )
            assert np.array_equal(frames[i], want), i
        # Float output mode too.
        frames_f = np.asarray(
            program.render_sequence(stacks, as_uint8=False)
        )
        assert frames_f.dtype == np.float32
        assert np.allclose(
            frames_f[2], np.asarray(program(stacks[2])), atol=1e-6
        )

    def test_instanced_pairs_do_not_fuse(self):
        """Instanced SAVE+SCALE stays unfused: with overlapping
        instance covers the unfused sequence snapshots ALL pre-scale
        alpha before any scaling; fusing would interleave per instance."""
        from contrast_renderer.renderer import _optimize_commands

        cover = Shape([Path.from_rect((32, 32), (32, 32))])
        stacked = np.stack([ortho(), translate(4, 0)])
        commands = [
            DrawCommand(
                RenderOperation.SAVE_ALPHA_CONTEXT, cover, stacked,
                alpha_layer=0,
            ),
            DrawCommand(
                RenderOperation.SCALE_ALPHA_CONTEXT, cover, stacked,
                color=(0, 0, 0, 0.5),
            ),
        ]
        opt, keep = _optimize_commands(commands)
        assert len(opt) == 2 and keep is None


@pytest.mark.slow  # fast gate keeps one compile per feature area; full battery in CI device-slow
class TestSrgbOutput:
    def test_srgb_quantization_matches_host_conversion(self, renderer):
        from contrast_renderer.utils.color import linear_to_srgb

        shape = Shape([Path.from_rect((32, 32), (20, 20))])
        commands = stencil_color(shape, ortho(), (0.2, 0.5, 0.8, 1.0))
        linear = renderer.render(commands)
        device = renderer.render(
            commands, as_uint8=True, srgb=True,
            background=(1.0, 1.0, 1.0, 1.0),
        )
        composited = linear + np.array([1, 1, 1, 1.0]) * (
            1.0 - linear[..., 3:4]
        )
        want = linear_to_srgb(np.clip(composited, 0, 1))
        want = (np.clip(want, 0, 1) * 255.0 + 0.5).astype(np.uint8)
        assert np.abs(
            device.astype(np.int32) - want.astype(np.int32)
        ).max() <= 1  # f32 vs f64 pow rounding
        # sRGB encoding brightens mid-tones: the red channel (0.2
        # linear) quantizes well above its linear byte value.
        assert device[32, 32, 0] > int(0.2 * 255) + 30


@pytest.mark.slow  # fast gate keeps one compile per feature area; full battery in CI device-slow
class TestAutoInstancing:
    """render()'s _fuse_instance_runs pass: consecutive per-instance
    (Stencil, Color) pairs collapse into instanced draws wherever the
    covers are disjoint on screen — pixel-exact vs the sequential walk
    (the reference's instance_range draw, renderer.rs:267, 462-466)."""

    def _render_pair(self, commands, config=None):
        config = config or Configuration()
        seq = Renderer(config, SIZE, SIZE, auto_instance=False)
        fused = Renderer(config, SIZE, SIZE, auto_instance=True)
        return (
            np.asarray(seq.render(commands)),
            np.asarray(fused.render(commands)),
        )

    def test_disjoint_grid_fuses_and_matches(self):
        from contrast_renderer.renderer import _fuse_instance_runs

        shape = Shape([Path.from_circle((6.0, 6.0), 5.0)])
        commands = []
        for gx in range(4):
            for gy in range(4):
                commands += stencil_color(
                    shape, translate(14.0 * gx, 14.0 * gy),
                    (0.1 * gx, 0.1 * gy, 0.5, 0.5),
                )
        fused, any_fused = _fuse_instance_runs(commands)
        assert any_fused
        assert len(fused) == 2 and fused[0].n_instances == 16
        seq_img, fused_img = self._render_pair(commands)
        assert np.array_equal(seq_img, fused_img)

    def test_overlapping_pairs_split_groups_exactly(self):
        """Translucent overlapping instances expose any compositing
        difference; the greedy grouping must keep overlap-ordered
        pairs in separate groups and stay bitwise equal."""
        from contrast_renderer.renderer import _fuse_instance_runs

        shape = Shape([Path.from_circle((8.0, 8.0), 7.0)])
        offsets = [
            (0.0, 0.0),    # A
            (40.0, 0.0),   # B: disjoint from A  -> joins A's group
            (6.0, 6.0),    # C: overlaps A       -> new group
            (40.0, 40.0),  # D: disjoint from C  -> joins C's group
        ]
        commands = []
        for k, (dx, dy) in enumerate(offsets):
            commands += stencil_color(
                shape, translate(dx, dy),
                (1.0 - 0.2 * k, 0.2 * k, 0.3, 0.4),
            )
        fused, any_fused = _fuse_instance_runs(commands)
        assert any_fused
        assert [c.n_instances for c in fused] == [2, 2, 2, 2]
        seq_img, fused_img = self._render_pair(commands)
        assert np.array_equal(seq_img, fused_img)

    def test_showcase_scene_fuses_pixel_exact(self):
        from contrast_renderer.models import showcase
        from contrast_renderer.renderer import _fuse_instance_runs

        shape = showcase.build_shape(with_text=False)
        commands = showcase.showcase_commands(shape, SIZE, SIZE)
        fused, any_fused = _fuse_instance_runs(commands)
        assert any_fused and len(fused) < len(commands)
        seq_img, fused_img = self._render_pair(commands)
        assert np.array_equal(seq_img, fused_img)

    def test_near_plane_crossing_never_fuses(self):
        from contrast_renderer.renderer import _fuse_instance_runs

        shape = Shape([Path.from_circle((0.0, 0.0), 1.0)])
        behind = np.eye(4, dtype=np.float32)
        behind[3, 2] = -2.0  # projective row: w crosses zero over the hull
        behind[3, 3] = 0.5
        commands = (
            stencil_color(shape, behind, (1, 0, 0, 1))
            + stencil_color(shape, behind, (0, 1, 0, 1))
        )
        fused, any_fused = _fuse_instance_runs(commands)
        assert not any_fused and len(fused) == 4

    def test_mixed_state_breaks_runs(self):
        """A clip-depth change (or shape change) ends the fusable run."""
        from contrast_renderer.renderer import _fuse_instance_runs

        a = Shape([Path.from_circle((6.0, 6.0), 5.0)])
        b = Shape([Path.from_rect((6.0, 6.0), (4.0, 4.0))])
        commands = (
            stencil_color(a, translate(0, 0), (1, 0, 0, 1))
            + stencil_color(a, translate(20, 0), (0, 1, 0, 1))
            + stencil_color(b, translate(40, 0), (0, 0, 1, 1))
        )
        fused, any_fused = _fuse_instance_runs(commands)
        assert any_fused
        assert [c.n_instances for c in fused] == [2, 2, 1, 1]


class TestFrameProgramFusion:
    """FrameProgram's runtime-checked auto-instancing: fusable runs
    are detected structurally at build, and every call re-validates
    cover disjointness with the frame's transform stack, dispatching
    the fused variant only then (falling back to the sequential walk
    otherwise) — pixel-exact either way."""

    def _commands(self, shape, offsets):
        commands = []
        for k, (dx, dy) in enumerate(offsets):
            commands += stencil_color(
                shape, translate(dx, dy),
                (1.0 - 0.2 * k, 0.2 * k, 0.3, 0.6),
            )
        return commands

    def test_fused_dispatch_matches_sequential(self):
        shape = Shape([Path.from_circle((6.0, 6.0), 5.0)])
        commands = self._commands(
            shape, [(0.0, 0.0), (20.0, 0.0), (40.0, 0.0)]
        )
        r = Renderer(Configuration(), SIZE, SIZE)
        program = r.compile_frame(commands)
        assert program._runs and program._plan is not None
        assert len(program._plan.commands) == 2
        want = Renderer(
            Configuration(), SIZE, SIZE, auto_instance=False
        ).render(commands)
        assert np.array_equal(np.asarray(program()), want)

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_camera_motion_regroups_when_covers_touch(self):
        shape = Shape([Path.from_circle((8.0, 8.0), 7.0)])
        commands = self._commands(shape, [(0.0, 0.0), (40.0, 0.0)])
        r = Renderer(Configuration(), SIZE, SIZE)
        program = r.compile_frame(commands)
        seq = Renderer(Configuration(), SIZE, SIZE, auto_instance=False)
        # Slide the second instance onto the first: covers overlap, the
        # active plan invalidates, the derived grouping degenerates to
        # singles (no fused variant), and the sequential walk renders
        # the exact blended result.
        moved = self._commands(shape, [(0.0, 0.0), (6.0, 4.0)])
        transforms = Renderer._pack_transforms(moved)
        assert program._plan_transforms_if_valid(
            program._plan, transforms
        ) is None
        assert program._derive_plan(transforms) is None
        assert np.array_equal(
            np.asarray(program(transforms)), seq.render(moved)
        )
        assert program._plan is None  # fell back
        # And back apart: the original grouping re-derives, hits the
        # variant cache, and matches again.
        apart = Renderer._pack_transforms(commands)
        assert np.array_equal(
            np.asarray(program(apart)), seq.render(commands)
        )
        assert program._plan is not None

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_partial_overlap_regroups_into_disjoint_groups(self):
        """Three instances where the second overlaps the first: the
        derived grouping splits render()-style — (first) + (second,
        third) — instead of abandoning fusion, and stays pixel-exact.

        Grouping changes compile on a BACKGROUND thread (a synchronous
        mid-animation XLA compile measured 56 → 1.06 FPS on the 4K
        orbit): the first frame under the new grouping dispatches the
        sequential walk while the fused variant compiles; once
        installed, the same transforms dispatch fused."""
        shape = Shape([Path.from_circle((8.0, 8.0), 7.0)])
        commands = self._commands(
            shape, [(0.0, 0.0), (40.0, 0.0), (20.0, 20.0)]
        )
        r = Renderer(Configuration(), SIZE, SIZE)
        program = r.compile_frame(commands)
        seq = Renderer(Configuration(), SIZE, SIZE, auto_instance=False)
        moved = self._commands(
            shape, [(0.0, 0.0), (6.0, 4.0), (40.0, 0.0)]
        )
        transforms = Renderer._pack_transforms(moved)
        plan = program._derive_plan(transforms)
        assert plan is not None
        assert plan.signature == ((False, (0,), (1, 2)),)
        # First frame: sequential walk; the derived grouping is only
        # COUNTED (compile hysteresis — continuous motion derives a
        # fresh grouping every frame, and compiling each would starve
        # the animation).
        assert np.array_equal(
            np.asarray(program(transforms)), seq.render(moved)
        )
        assert program._plan is None  # never blocks on a compile
        assert not program._compiling
        # Second frame under the SAME grouping: now the background
        # compile spawns; the frame itself still dispatches sequential.
        assert np.array_equal(
            np.asarray(program(transforms)), seq.render(moved)
        )
        assert program._plan is None
        assert program.wait_fused_compiles(timeout=300.0)
        # Steady state: the compiled grouping serves from the cache.
        assert np.array_equal(
            np.asarray(program(transforms)), seq.render(moved)
        )
        assert program._plan is not None
        assert program._plan.signature == plan.signature

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_render_sequence_falls_back_across_segment(self):
        shape = Shape([Path.from_circle((8.0, 8.0), 7.0)])
        commands = self._commands(shape, [(0.0, 0.0), (40.0, 0.0)])
        moved = self._commands(shape, [(0.0, 0.0), (6.0, 4.0)])
        r = Renderer(Configuration(), SIZE, SIZE)
        program = r.compile_frame(commands)
        seq = Renderer(Configuration(), SIZE, SIZE, auto_instance=False)
        stacks = np.stack([
            Renderer._pack_transforms(commands),
            Renderer._pack_transforms(moved),
        ])
        frames = np.asarray(program.render_sequence(stacks, as_uint8=False))
        assert np.array_equal(frames[0], seq.render(commands))
        assert np.array_equal(frames[1], seq.render(moved))

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_uniform_opaque_color_fuses_despite_overlap(self):
        """A run painting ONE opaque color fuses whole even where
        covers overlap (idempotent blend, no depth, uniform
        orientation): overlap changes which cover paints a shared
        sample, which is invisible for a single opaque color — and
        must render pixel-exactly vs the sequential walk."""
        shape = Shape([Path.from_circle((8.0, 8.0), 7.0)])
        commands = []
        for dx, dy in [(0.0, 0.0), (6.0, 4.0), (40.0, 0.0)]:
            commands += stencil_color(
                shape, translate(dx, dy), (0.2, 0.7, 0.9, 1.0)
            )
        r = Renderer(Configuration(), SIZE, SIZE)
        program = r.compile_frame(commands)
        assert program._plan is not None
        assert program._plan.signature == ((True, (0, 1, 2)),)
        want = Renderer(
            Configuration(), SIZE, SIZE, auto_instance=False
        ).render(commands)
        assert np.array_equal(np.asarray(program()), want)

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_translucent_uniform_color_never_escapes(self):
        shape = Shape([Path.from_circle((8.0, 8.0), 7.0)])
        commands = []
        for dx, dy in [(0.0, 0.0), (6.0, 4.0)]:
            commands += stencil_color(
                shape, translate(dx, dy), (0.2, 0.7, 0.9, 0.5)
            )
        r = Renderer(Configuration(), SIZE, SIZE)
        program = r.compile_frame(commands)
        # Overlapping translucent covers: no escape, greedy grouping
        # degenerates to singles, no fused variant.
        assert program._plan is None

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_mismatched_pair_rows_disable_fusion(self):
        """A caller stack whose stencil and cover rows differ must
        never dispatch a fused variant (fused draws share one
        transform row per instance)."""
        shape = Shape([Path.from_circle((6.0, 6.0), 5.0)])
        commands = self._commands(shape, [(0.0, 0.0), (20.0, 0.0)])
        r = Renderer(Configuration(), SIZE, SIZE)
        program = r.compile_frame(commands)
        transforms = Renderer._pack_transforms(commands).copy()
        transforms[1, 0, 3] += 0.25  # cover row diverges from stencil
        assert program._plan_transforms_if_valid(
            program._plan, transforms
        ) is None
        assert program._derive_plan(transforms) is None

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_auto_instance_off_compiles_no_fused_variant(self):
        shape = Shape([Path.from_circle((6.0, 6.0), 5.0)])
        commands = self._commands(shape, [(0.0, 0.0), (20.0, 0.0)])
        r = Renderer(Configuration(), SIZE, SIZE, auto_instance=False)
        program = r.compile_frame(commands)
        assert program._runs == [] and program._fused_variants == {}

    def test_plan_for_motion_fuses_across_sweep(self):
        """plan_for_motion derives ONE grouping valid across a whole
        motion (pairs fuse only where disjoint in EVERY frame), so a
        camera path dispatches a single pre-compiled fused variant
        with zero compiles in flight — pixel-exact per frame."""
        shape = Shape([Path.from_circle((6.0, 6.0), 5.0)])
        commands = self._commands(
            shape, [(0.0, 0.0), (24.0, 0.0), (48.0, 0.0)]
        )
        r = Renderer(Configuration(), SIZE, SIZE)
        program = r.compile_frame(commands)
        seq = Renderer(Configuration(), SIZE, SIZE, auto_instance=False)

        def at(dy):
            moved = self._commands(
                shape, [(0.0, dy), (24.0, 0.0), (48.0, dy)]
            )
            return Renderer._pack_transforms(moved), moved

        assert program.plan_for_motion(
            [at(dy)[0] for dy in (0.0, 8.0, 16.0)], timeout=300.0
        )
        sig = program._plan.signature
        assert sig == ((False, (0, 1, 2)),)
        for dy in (0.0, 8.0, 16.0):
            transforms, moved = at(dy)
            assert np.array_equal(
                np.asarray(program(transforms)), seq.render(moved)
            )
            assert program._plan is not None
            assert program._plan.signature == sig
            assert not program._compiling

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_plan_for_motion_excludes_colliding_pairs(self):
        """A pair that collides with its group-mate in ANY frame of
        the motion is excluded from that group; the rest still fuse."""
        shape = Shape([Path.from_circle((8.0, 8.0), 7.0)])
        commands = self._commands(
            shape, [(0.0, 0.0), (40.0, 0.0), (20.0, 28.0)]
        )
        r = Renderer(Configuration(), SIZE, SIZE)
        program = r.compile_frame(commands)
        far = Renderer._pack_transforms(commands)
        near_cmds = self._commands(
            shape, [(0.0, 0.0), (6.0, 4.0), (20.0, 28.0)]
        )
        near = Renderer._pack_transforms(near_cmds)
        assert program.plan_for_motion([far, near], timeout=300.0)
        # Pair 1 overlaps pair 0 in the second frame: the motion plan
        # must group (0,) + (1, 2).
        assert program._plan.signature == ((False, (0,), (1, 2)),)
        seq = Renderer(Configuration(), SIZE, SIZE, auto_instance=False)
        assert np.array_equal(
            np.asarray(program(near)), seq.render(near_cmds)
        )
        assert np.array_equal(
            np.asarray(program(far)), seq.render(commands)
        )

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_fully_behind_pair_fuses_as_empty_cover(self):
        """A pair whose hull lands fully behind the camera in some
        frame draws NOTHING there (the kernel's near-plane clip yields
        an empty cover), so the host model treats its cover as the
        empty region — disjoint from everything — instead of vetoing
        the whole-motion plan.  An orbiting camera always has such
        frames (shapes sweep behind the eye), which is exactly why the
        4K-orbit motion plan failed to derive before this model."""
        shape = Shape([Path.from_circle((6.0, 6.0), 5.0)])
        commands = self._commands(
            shape, [(0.0, 0.0), (24.0, 0.0), (48.0, 0.0)]
        )
        behind = np.array(
            [
                [1.0, 0.0, 0.0, 0.0],
                [0.0, 1.0, 0.0, 0.0],
                [0.0, 0.0, 0.0, 0.0],
                [0.0, 0.0, 0.0, -1.0],
            ],
            np.float32,
        )
        front = Renderer._pack_transforms(commands)
        mixed = front.copy()
        mixed[2] = mixed[3] = behind  # pair 1's stencil + cover rows
        r = Renderer(Configuration(), SIZE, SIZE)
        program = r.compile_frame(commands)
        assert program.plan_for_motion([front, mixed], timeout=300.0)
        # The behind frame never splits the grouping: all three fuse.
        assert program._plan.signature == ((False, (0, 1, 2)),)
        seq = Renderer(Configuration(), SIZE, SIZE, auto_instance=False)
        mixed_cmds = list(commands)
        mixed_cmds[2] = dataclasses.replace(commands[2], transform=behind)
        mixed_cmds[3] = dataclasses.replace(commands[3], transform=behind)
        for tf, cmds in ((front, commands), (mixed, mixed_cmds)):
            assert np.array_equal(
                np.asarray(program(tf)), seq.render(cmds)
            )

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_near_plane_crossing_pair_fuses_when_clipped_cover_disjoint(self):
        """A pair whose hull CROSSES the near plane used to veto any
        grouping containing it (its projection was 'not well-defined').
        The host now clips the hull against w > eps exactly as the
        kernel does, so the pair fuses whenever its CLIPPED cover is
        disjoint from its group — and the fused frame matches the
        sequential walk at the crossing pose."""
        shape = Shape([Path.from_circle((6.0, 6.0), 5.0)])
        commands = self._commands(
            shape, [(0.0, 0.0), (24.0, 0.0), (48.0, 0.0)]
        )
        crossing = np.array(
            [
                [0.02, 0.0, 0.0, 0.0],
                [0.0, 0.02, 0.0, 0.0],
                [0.0, 0.0, 0.0, 0.0],
                # w = 0.1·y − 0.5 over hull y ∈ [1, 11]: crosses w = 0.
                [0.0, 0.1, 0.0, -0.5],
            ],
            np.float32,
        )
        front = Renderer._pack_transforms(commands)
        mixed = front.copy()
        mixed[0] = mixed[1] = crossing
        r = Renderer(Configuration(), SIZE, SIZE)
        program = r.compile_frame(commands)
        assert program.plan_for_motion([front, mixed], timeout=300.0)
        # The clipped cover lands far up-right of the other two: all
        # three pairs fuse despite the near-plane crossing.
        assert program._plan.signature == ((False, (0, 1, 2)),)
        seq = Renderer(Configuration(), SIZE, SIZE, auto_instance=False)
        mixed_cmds = list(commands)
        mixed_cmds[0] = dataclasses.replace(commands[0], transform=crossing)
        mixed_cmds[1] = dataclasses.replace(commands[1], transform=crossing)
        assert np.array_equal(
            np.asarray(program(mixed)), seq.render(mixed_cmds)
        )
        assert np.array_equal(
            np.asarray(program(front)),
            seq.render(commands),
        )


class TestBracketGating:
    """Per-tile clip/alpha machinery gating (FrameSpec.gate_spans):
    tiles no content draw touches drop the whole balanced bracket —
    provably identity there — usually onto the empty-tile fast path.
    Each case compares against a gating-disabled render bit-exactly."""

    W = H = 128  # a handful of tiles (4 rows x 1 col)

    def _scene(self, content_transform=None, unclip_transform=None):
        """Nested clip + alpha group over a full-viewport rect, with a
        small circle of content in the top-left corner only."""
        identity = np.eye(4, dtype=np.float32)
        clip_shape = Shape([Path.from_rect((0.0, 0.0), (1.0, 1.0))])
        cover = Shape([Path.from_rect((0.0, 0.0), (1.0, 1.0))])
        content = Shape([Path.from_circle((-0.7, 0.7), 0.15)])
        ct = identity if content_transform is None else content_transform
        ut = identity if unclip_transform is None else unclip_transform
        return [
            DrawCommand(RenderOperation.STENCIL, clip_shape, identity),
            DrawCommand(
                RenderOperation.CLIP, clip_shape, identity, clip_depth=1
            ),
            DrawCommand(
                RenderOperation.SAVE_ALPHA_CONTEXT, cover, identity,
                clip_depth=1, alpha_layer=0,
            ),
            DrawCommand(
                RenderOperation.SCALE_ALPHA_CONTEXT, cover, identity,
                clip_depth=1, color=(0.0, 0.0, 0.0, 0.5),
            ),
            DrawCommand(
                RenderOperation.STENCIL, content, ct, clip_depth=1
            ),
            DrawCommand(
                RenderOperation.COLOR, content, ct,
                color=(0.9, 0.4, 0.1, 1.0), clip_depth=1,
            ),
            DrawCommand(
                RenderOperation.RESTORE_ALPHA_CONTEXT, cover, identity,
                clip_depth=1, color=(0.0, 0.0, 0.0, 0.5),
                alpha_layer=0,
            ),
            DrawCommand(
                RenderOperation.UNCLIP, clip_shape, ut, clip_depth=0
            ),
        ]

    def _render_both(self, commands, monkeypatch):
        from contrast_renderer import renderer as renderer_mod

        config = Configuration(
            alpha_layer_count=1, blending="front_to_back"
        )
        gated = Renderer(config, self.W, self.H).render(commands)
        monkeypatch.setattr(
            renderer_mod, "_gate_spans", lambda commands, spec: ()
        )
        ungated = Renderer(config, self.W, self.H).render(commands)
        return gated, ungated

    def test_gated_bracket_matches_ungated(self, monkeypatch):
        commands = self._scene()
        from contrast_renderer import renderer as renderer_mod

        r = Renderer(
            Configuration(alpha_layer_count=1, blending="front_to_back"),
            self.W, self.H,
        )
        # The analysis derives a span for this stream (sanity: the
        # optimization actually engages before we assert equality).
        opt, _ = renderer_mod._optimize_commands(commands)
        shapes, shape_index = r._unique_shapes(opt)
        _, scene = r._scene_arrays(shapes)
        spec = r._spec(
            tuple(int(c.operation) for c in opt),
            tuple(
                Renderer._cmd_shape_entry(c, shape_index) for c in opt
            ),
            (),
            scene,
            tuple(renderer_mod._spec_paint(c.color) for c in opt),
            commands=opt,
        )
        assert spec.gate_spans
        gated, ungated = self._render_both(commands, monkeypatch)
        assert np.array_equal(gated, ungated)
        # The content circle actually rendered (the gate did not eat
        # the content tiles).
        assert gated[..., 3].max() > 0.0

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_mismatched_bracket_rows_disable_gating_at_runtime(
        self, monkeypatch
    ):
        # The UNCLIP cover's transform differs from its CLIP's: the
        # traced row-pair check must disable the span's gating, and the
        # frame must still match the ungated render bit-exactly.
        shifted = np.eye(4, dtype=np.float32)
        shifted[0, 3] = 0.25
        commands = self._scene(unclip_transform=shifted)
        gated, ungated = self._render_both(commands, monkeypatch)
        assert np.array_equal(gated, ungated)

    def _spec_of(self, commands):
        from contrast_renderer import renderer as renderer_mod

        r = Renderer(
            Configuration(alpha_layer_count=1, blending="front_to_back"),
            self.W, self.H,
        )
        opt, _ = renderer_mod._optimize_commands(commands)
        shapes, shape_index = r._unique_shapes(opt)
        _, scene = r._scene_arrays(shapes)
        return r._spec(
            tuple(int(c.operation) for c in opt),
            tuple(
                Renderer._cmd_shape_entry(c, shape_index) for c in opt
            ),
            (),
            scene,
            tuple(renderer_mod._spec_paint(c.color) for c in opt),
            commands=opt,
        )

    def test_unbalanced_stream_never_gates(self):
        commands = self._scene()[:-1]  # drop the closing UNCLIP
        assert self._spec_of(commands).gate_spans == ()

    def test_restore_after_unclip_never_gates(self):
        """The kernel masks every alpha op with clipb == its depth, so
        a RESTORE issued after the bracket's UNCLIP applies nowhere
        while its SAVE applied somewhere — NOT identity.  The analysis
        must refuse (issue-time clip state differs)."""
        commands = self._scene()
        restore = commands[6]
        unclip = commands[7]
        assert restore.operation == RenderOperation.RESTORE_ALPHA_CONTEXT
        assert unclip.operation == RenderOperation.UNCLIP
        reordered = commands[:6] + [
            unclip,
            dataclasses.replace(restore, clip_depth=0),
        ]
        assert self._spec_of(reordered).gate_spans == ()

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_background_under_bracket_keeps_machinery(self, monkeypatch):
        """With content anywhere in a tile, frame alpha under the
        bracket can be nonzero and the float save/scale/restore chain
        is only identity in exact arithmetic — such tiles must keep
        their machinery.  A full-screen translucent background before
        the bracket marks every tile as touched; gated and ungated
        renders must stay bit-equal."""
        identity = np.eye(4, dtype=np.float32)
        bg = Shape([Path.from_rect((0.0, 0.0), (1.0, 1.0))])
        commands = [
            DrawCommand(RenderOperation.STENCIL, bg, identity),
            DrawCommand(
                RenderOperation.COLOR, bg, identity,
                color=(0.2, 0.3, 0.4, 0.37),
            ),
        ] + self._scene()
        spec = self._spec_of(commands)
        assert spec.gate_spans  # analysis still derives the span
        gated, ungated = self._render_both(commands, monkeypatch)
        assert np.array_equal(gated, ungated)
