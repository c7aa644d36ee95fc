"""Scenes for the raster-kernel tests: small frames (64×64) that each
exercise one part of the kernel's feature matrix, and the comparison of
the kernel (Pallas interpret mode here) with the plain-XLA executor.

The two executors compile to different XLA programs, and the compiler
may contract a multiply-add in one and not the other, so a sample lying
exactly on an edge can flip: `assert_matches` holds them to the limits
chip_smoke.py uses on the card (per-channel mean |d| < 1e-4, under
0.1 % of pixels off by more than 1/255, no NaN)."""

import numpy as np

from contrast_renderer.ops import reference
from contrast_renderer.path import (
    Cap,
    DashInterval,
    DynamicStrokeOptions,
    IntegralCubicCurveSegment,
    IntegralQuadraticCurveSegment,
    Join,
    LineSegment,
    Path,
    StrokeOptions,
)
from contrast_renderer.renderer import (
    Configuration,
    DrawCommand,
    LinearGradient,
    RenderOperation,
    Renderer,
    Shape,
    UserPaint,
)

SIZE = 64


def ortho(size=SIZE):
    t = np.diag([2.0 / size, 2.0 / size, 1.0, 1.0]).astype(np.float32)
    t[0, 3] = -1.0
    t[1, 3] = -1.0
    return t


def stencil_color(shape, color, transform=None, **kw):
    t = ortho() if transform is None else transform
    return [
        DrawCommand(RenderOperation.STENCIL, shape, t, **kw),
        DrawCommand(RenderOperation.COLOR, shape, t, color=color, **kw),
    ]


def _stroked(options, width=5.0, closed=False):
    zigzag = Path.from_polygon(
        [(6.0, 8.0), (26.0, 54.0), (38.0, 10.0), (58.0, 44.0)]
    )
    zigzag.stroke_options = StrokeOptions(
        width=width, closed=closed, dynamic_stroke_options_group=0
    )
    return Shape([zigzag], [options])


def fill_solid():
    tri = Shape([Path.from_polygon([(4.0, 4.0), (60.0, 12.0), (20.0, 58.0)])])
    rect = Shape([Path.from_rect((40.0, 40.0), (14.0, 10.0))])
    return Configuration(), (
        stencil_color(tri, (1.0, 0.2, 0.1, 1.0))
        + stencil_color(rect, (0.1, 0.3, 1.0, 0.6))
    )


def fill_quadratic():
    p = Path(start=(6.0, 10.0))
    p.push_integral_quadratic_curve(
        IntegralQuadraticCurveSegment([(60.0, 2.0), (40.0, 58.0)])
    )
    p.push_line(LineSegment([(6.0, 10.0)]))
    return Configuration(), stencil_color(Shape([p]), (0.9, 0.8, 0.1, 1.0))


def fill_cubic():
    p = Path(start=(4.0, 16.0))
    p.push_integral_cubic_curve(
        IntegralCubicCurveSegment([(24.0, 62.0), (40.0, 2.0), (60.0, 48.0)])
    )
    p.push_line(LineSegment([(4.0, 16.0)]))
    return Configuration(), stencil_color(Shape([p]), (0.2, 0.9, 0.4, 1.0))


def stroke_solid(join, start, end):
    shape = _stroked(DynamicStrokeOptions.make_solid(join, start, end))
    return Configuration(), stencil_color(shape, (0.3, 0.5, 1.0, 0.9))


def stroke_dash_single():
    shape = _stroked(DynamicStrokeOptions.make_dashed(
        Join.ROUND, [DashInterval(2.0, 3.0, Cap.ROUND, Cap.OUT)], 0.5
    ))
    return Configuration(), stencil_color(shape, (1.0, 0.4, 0.2, 1.0))


def stroke_dash_multi():
    shape = _stroked(DynamicStrokeOptions.make_dashed(
        Join.BEVEL,
        [
            DashInterval(1.0, 2.0, Cap.SQUARE, Cap.IN),
            DashInterval(3.0, 3.5, Cap.RIGHT, Cap.LEFT),
            DashInterval(4.5, 6.0, Cap.BUTT, Cap.ROUND),
        ],
        0.25,
    ), closed=True)
    return Configuration(), stencil_color(shape, (0.6, 0.2, 0.9, 1.0))


def clip_nested():
    disc = Shape([Path.from_circle((32.0, 32.0), 22.0)])
    band = Shape([Path.from_rect((32.0, 32.0), (28.0, 8.0))])
    square = Shape([Path.from_rect((32.0, 32.0), (30.0, 30.0))])
    return Configuration(), [
        DrawCommand(RenderOperation.STENCIL, disc, ortho()),
        DrawCommand(RenderOperation.CLIP, disc, ortho(), clip_depth=1),
        DrawCommand(RenderOperation.STENCIL, band, ortho(), clip_depth=1),
        DrawCommand(RenderOperation.CLIP, band, ortho(), clip_depth=2),
        *stencil_color(square, (1.0, 0.0, 0.0, 1.0), clip_depth=2),
        DrawCommand(RenderOperation.UNCLIP, band, ortho(), clip_depth=1),
        *stencil_color(square, (0.0, 0.0, 1.0, 0.5), clip_depth=1),
        DrawCommand(RenderOperation.UNCLIP, disc, ortho(), clip_depth=0),
    ]


def alpha_group():
    cover = Shape([Path.from_rect((32.0, 32.0), (32.0, 32.0))])
    disc = Shape([Path.from_circle((28.0, 30.0), 16.0)])
    rect = Shape([Path.from_rect((40.0, 36.0), (14.0, 14.0))])
    g = 0.4
    return Configuration(alpha_layer_count=1, blending="front_to_back"), [
        DrawCommand(RenderOperation.SAVE_ALPHA_CONTEXT, cover, ortho(),
                    alpha_layer=0),
        DrawCommand(RenderOperation.SCALE_ALPHA_CONTEXT, cover, ortho(),
                    color=(0, 0, 0, g)),
        *stencil_color(disc, (1.0, 0.5, 0.0, 1.0)),
        *stencil_color(rect, (0.0, 0.6, 0.2, 1.0)),
        DrawCommand(RenderOperation.RESTORE_ALPHA_CONTEXT, cover, ortho(),
                    color=(0, 0, 0, g), alpha_layer=0),
        *stencil_color(cover, (0.1, 0.1, 0.3, 1.0)),
    ]


def depth_less_equal():
    near = ortho()
    near[2, 3] = -0.5
    far = ortho()
    far[2, 3] = 0.5
    a = Shape([Path.from_circle((26.0, 32.0), 16.0)])
    b = Shape([Path.from_circle((38.0, 32.0), 16.0)])
    return Configuration(
        depth_compare="less_equal", depth_write_enabled=True
    ), (
        stencil_color(a, (1.0, 0.0, 0.0, 1.0), transform=near)
        + stencil_color(b, (0.0, 1.0, 0.0, 1.0), transform=far)
    )


def _checker(px, py, anchor):
    import jax.numpy as jnp

    c = (jnp.floor(px * 0.25) + jnp.floor(py * 0.25)).astype(jnp.int32) % 2
    c = c.astype(jnp.float32)
    return c, 1.0 - c, c, jnp.full_like(c, 0.8)


def paints():
    disc = Shape([Path.from_circle((20.0, 20.0), 14.0)])
    rect = Shape([Path.from_rect((42.0, 42.0), (16.0, 16.0))])
    grad = LinearGradient(
        start=(6.0, 20.0), end=(34.0, 20.0),
        color0=(1.0, 0.0, 0.0, 1.0), color1=(0.0, 0.0, 1.0, 0.5),
    )
    return Configuration(), (
        stencil_color(disc, grad) + stencil_color(rect, UserPaint(_checker))
    )


CASES = {
    "fill_solid": fill_solid,
    "fill_quadratic": fill_quadratic,
    "fill_cubic": fill_cubic,
    "stroke_miter_butt": lambda: stroke_solid(Join.MITER, Cap.BUTT, Cap.BUTT),
    "stroke_bevel_square_round": lambda: stroke_solid(
        Join.BEVEL, Cap.SQUARE, Cap.ROUND),
    "stroke_round_out_in": lambda: stroke_solid(Join.ROUND, Cap.OUT, Cap.IN),
    "stroke_dash_single": stroke_dash_single,
    "stroke_dash_multi": stroke_dash_multi,
    "clip_nested": clip_nested,
    "alpha_group": alpha_group,
    "depth_less_equal": depth_less_equal,
    "paints": paints,
}


def assert_matches(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if want.max() > 1.5:  # packed uint8
        got, want = got / 255.0, want / 255.0
    assert got.shape == want.shape
    assert not np.isnan(got).any()
    d = np.abs(got - want)
    assert (d.mean(axis=(0, 1)) < 1e-4).all(), d.mean(axis=(0, 1))
    assert (d.max(axis=-1) > 1.0 / 255.0).mean() < 1e-3


def kernel_and_reference(case, uint8=False, **renderer_kw):
    """(kernel image, plain-executor image) of a case on the CPU."""
    config, commands = CASES[case]()
    renderer = Renderer(config, SIZE, SIZE, **renderer_kw)
    got = np.asarray(renderer.render(commands, uint8_kernel=uint8))
    want = np.asarray(reference.render_reference(renderer, commands)) \
        if not uint8 else None
    if uint8:
        from dataclasses import replace

        spec, args = renderer._prepare_frame(commands)
        want = np.asarray(reference.make_reference_rasterize(
            replace(spec, out_uint8=True))(*args))
    return got, want
