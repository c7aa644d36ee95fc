"""Measure the renderer's scene configurations on the GPU.

Prints one JSON line per config.  Exits non-zero when JAX finds no GPU.

Usage: python benchmarks/run_configs.py [--configs 1,2,3,4,5] [--frames N]
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def _timed_frames(frame, n):
    """Device-side frame throughput: frames dispatched back-to-back and
    every frame forced to completion through a per-frame device
    checksum fetched once at the end.

    ``frame(i, acc)`` must return ``(image, acc + sum(image[..., 3]))``
    with the checksum computed INSIDE the frame's own dispatch
    (``carry=`` on Renderer.render / FrameProgram.__call__) — the same
    single-launch forcing bench.py uses."""
    import jax.numpy as jnp

    _, acc = frame(0, jnp.float32(0.0))
    _, acc = frame(1, acc)
    float(acc)  # compile frame (+ fused probe)
    best = 0.0
    for b in range(3):  # best sustained batch (see bench.py)
        start = time.perf_counter()
        acc = jnp.float32(0.0)
        for i in range(n):
            _, acc = frame(b * n + i + 1, acc)
        assert np.isfinite(float(acc))  # forces the whole chain
        best = max(best, n / (time.perf_counter() - start))
    return best



def _env_int(name):
    return int(os.environ[name]) if os.environ.get(name) else None


def _renderer_knobs():
    """Env-tunable Renderer knobs shared by every config
    (BENCH_TILE_H, BENCH_FILL_BATCH)."""
    return {
        "tile_size": _env_int("BENCH_TILE_H"),
        "fill_batch": _env_int("BENCH_FILL_BATCH"),
    }


def ortho_wh(width, height):
    t = np.diag([2.0 / width, 2.0 / height, 1.0, 1.0]).astype(np.float32)
    t[0, 3] = -1.0
    t[1, 3] = -1.0
    return t


def emit(metric, value, unit, extra=None):
    record = {"metric": metric, "value": round(value, 4), "unit": unit}
    if extra:
        record.update(extra)
    print(json.dumps(record), flush=True)


def config1():
    """Filled circle at 256², nonzero winding: coverage error vs the
    scalar oracle."""
    from contrast_renderer import oracle
    from contrast_renderer.fill import FillBuilder
    from contrast_renderer.ops import raster
    from contrast_renderer.path import Path

    size = 256
    builder = FillBuilder()
    hull = []
    builder.add_path(hull, Path.from_circle((128, 128), 90))
    table = builder.build()
    rasterize = raster.make_fill_rasterizer(size, size)
    winding, _ = rasterize(
        table.xy, table.aux, table.kind, table.meta, ortho_wh(size, size)
    )
    got = np.asarray(winding)
    want = oracle.rasterize_fill_table(table, size, size)
    err = np.mean(got != want)
    emit("config1_circle_256_coverage_err", float(err), "fraction mismatched samples")


def config2(frames):
    """1k integral quad/cubic Bézier fills, 1080p, 4×MSAA."""
    from contrast_renderer.path import (
        IntegralCubicCurveSegment,
        IntegralQuadraticCurveSegment,
        LineSegment,
        Path,
    )
    from contrast_renderer.renderer import (
        Configuration, DrawCommand, RenderOperation, Renderer, Shape)

    width, height = 1920, 1080
    rng = np.random.default_rng(0)
    paths = []
    for i in range(1000):
        cx = rng.uniform(40, width - 40)
        cy = rng.uniform(40, height - 40)
        r = rng.uniform(8, 30)
        pts = np.stack(
            [cx + rng.uniform(-r, r, 4), cy + rng.uniform(-r, r, 4)], axis=1
        )
        p = Path(start=(cx - r, cy))
        if i % 2 == 0:
            p.push_integral_quadratic_curve(
                IntegralQuadraticCurveSegment([tuple(pts[0]), tuple(pts[1])])
            )
        else:
            p.push_integral_cubic_curve(
                IntegralCubicCurveSegment(
                    [tuple(pts[0]), tuple(pts[1]), tuple(pts[2])]
                )
            )
        p.push_line(LineSegment([(cx - r, cy)]))
        paths.append(p)
    t0 = time.perf_counter()
    shape = Shape(paths)
    build_s = time.perf_counter() - t0
    renderer = Renderer(Configuration(), width, height, **_renderer_knobs(),)
    t = ortho_wh(width, height)
    commands = [
        DrawCommand(RenderOperation.STENCIL, shape, t),
        DrawCommand(
            RenderOperation.COLOR, shape, t, color=(0.9, 0.4, 0.1, 1.0)
        ),
    ]

    def frame(i, acc):
        return renderer.render(commands, to_host=False, carry=acc)

    fps = _timed_frames(frame, frames)
    emit(
        "config2_1k_beziers_1080p", fps, "frames/s",
        {
            "triangles": len(shape.triangles),
            "scene_build_s": round(build_s, 3),
            "gpixels_per_s": round(fps * width * height * 4 / 1e9, 3),
        },
    )


def config3(frames, width=1920, height=1080,
            label="config3_dashed_strokes_1080p"):
    """Dashed strokes, all join styles, animated phase."""
    from contrast_renderer.path import (
        Cap, CurveApproximation, DashInterval, DynamicStrokeOptions,
        Join, Path, StrokeOptions)
    from contrast_renderer.renderer import (
        Configuration, DrawCommand, RenderOperation, Renderer, Shape)

    def dashed(join, phase):
        return DynamicStrokeOptions.make_dashed(
            join,
            [
                DashInterval(gap_start=2.0, gap_end=3.0,
                             dash_start=Cap.ROUND, dash_end=Cap.OUT),
                DashInterval(gap_start=5.0, gap_end=5.5,
                             dash_start=Cap.BUTT, dash_end=Cap.BUTT),
            ],
            phase=phase,
        )

    joins = [Join.MITER, Join.BEVEL, Join.ROUND]
    paths = []
    rng = np.random.default_rng(1)
    for i in range(60):
        p = Path(start=(rng.uniform(100, width - 100), rng.uniform(100, height - 100)))
        from contrast_renderer.path import LineSegment
        for _ in range(6):
            p.push_line(
                LineSegment([
                    (rng.uniform(50, width - 50), rng.uniform(50, height - 50))
                ])
            )
        p.stroke_options = StrokeOptions(
            width=10.0, offset=0.0, miter_clip=2.0, closed=False,
            dynamic_stroke_options_group=i % 3,
            curve_approximation=CurveApproximation.uniform_tangent_angle(0.1),
        )
        paths.append(p)
    options = [dashed(j, 0.0) for j in joins]
    shape = Shape(paths, options)
    renderer = Renderer(Configuration(), width, height, **_renderer_knobs(),)
    t = ortho_wh(width, height)
    commands = [
        DrawCommand(RenderOperation.STENCIL, shape, t),
        DrawCommand(RenderOperation.COLOR, shape, t, color=(1, 1, 1, 1)),
    ]

    def frame(i, acc):
        for g, join in enumerate(joins):
            shape.set_dynamic_stroke_options(g, dashed(join, i * 0.3))
        return renderer.render(commands, to_host=False, carry=acc)

    fps = _timed_frames(frame, frames)
    emit(label, fps, "frames/s", {"triangles": len(shape.triangles)})


def config4(frames):
    """10k TTF glyphs at 1080p."""
    from contrast_renderer.path import Path
    from contrast_renderer.renderer import (
        Configuration, DrawCommand, RenderOperation, Renderer, Shape)
    from contrast_renderer.text import (
        Alignment, Font, Layout, Orientation, paths_of_text)

    width, height = 1920, 1080
    from contrast_renderer.assets import load_default_font
    font = load_default_font()
    layout = Layout(
        size=16.0,
        orientation=Orientation.LEFT_TO_RIGHT,
        major_alignment=Alignment.BEGIN,
        minor_alignment=Alignment.BEGIN,
    )
    text = "\n".join(
        "the quick brown fox jumps over the lazy dog 0123456789 " * 2
        for _ in range(112)
    )
    n_glyphs = sum(1 for ch in text if not ch.isspace())
    t0 = time.perf_counter()
    paths = paths_of_text(font.face, layout, text)
    outline_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shape = Shape(paths)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shape_py = Shape(paths, use_native=False)
    build_py_s = time.perf_counter() - t0
    assert len(shape_py.triangles) == len(shape.triangles)
    # Production text path: per-glyph triangle-table cache + instance
    # stamping (text.shape_of_text) — tessellates each unique glyph
    # once; cold includes filling the cache, warm is the steady state.
    from contrast_renderer.text import shape_of_text
    t0 = time.perf_counter()
    shape_fast = shape_of_text(font.face, layout, text)
    build_fast_cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shape_fast = shape_of_text(font.face, layout, text)
    build_fast_warm_s = time.perf_counter() - t0
    assert len(shape_fast.triangles) == len(shape.triangles)
    shape = shape_fast

    renderer = Renderer(Configuration(), width, height, **_renderer_knobs(),)
    # Glyph box is ~[0, 850]x[-200, 1370]; map onto the viewport.
    t = np.diag(
        [2.0 / 1800.0, 2.0 / 1500.0, 1.0, 1.0]
    ).astype(np.float32)
    t[0, 3] = -1.0
    t[1, 3] = 0.95
    commands = [
        DrawCommand(RenderOperation.STENCIL, shape, t),
        DrawCommand(RenderOperation.COLOR, shape, t, color=(1, 1, 1, 1)),
    ]

    def frame(i, acc):
        return renderer.render(commands, to_host=False, carry=acc)

    fps_mono = _timed_frames(frame, frames)
    emit(
        "config4_10k_glyphs_1080p_monolith", fps_mono * n_glyphs,
        "glyphs/s",
        {
            "glyphs": n_glyphs,
            "frames_per_s": round(fps_mono, 3),
            "triangles": len(shape.triangles),
            "outline_s": round(outline_s, 3),
            "scene_build_native_s": round(build_s, 3),
            "scene_build_python_s": round(build_py_s, 3),
            "scene_build_glyphcache_cold_s": round(build_fast_cold_s, 3),
            "scene_build_glyphcache_warm_s": round(build_fast_warm_s, 3),
        },
    )

    # Production path (headline): ONE multi-shape instanced stencil +
    # ONE whole-string cover (text.text_commands_fused) — the
    # monolith's exact two-command kernel walk over per-glyph cached
    # tables (the reference's per-glyph vertex buffers in one
    # instanced stream, text.rs:97-104 + renderer.rs:462-466), at the
    # instanced path's ~0.3 s scene build.
    from contrast_renderer.text import text_commands, text_commands_fused
    t0 = time.perf_counter()
    inst_commands = text_commands_fused(
        font.face, layout, text, t, color=(1, 1, 1, 1)
    )
    build_inst_s = time.perf_counter() - t0
    renderer_inst = Renderer(
        Configuration(), width, height,
        **_renderer_knobs(),
    )

    def frame_inst(i, acc):
        return renderer_inst.render(inst_commands, to_host=False, carry=acc)

    fps = _timed_frames(frame_inst, frames)
    emit(
        "config4_10k_glyphs_1080p", fps * n_glyphs, "glyphs/s",
        {
            "glyphs": n_glyphs,
            "frames_per_s": round(fps, 3),
            "commands": len(inst_commands),
            "unique_glyph_triangles": sum(
                len(s.triangles)
                for s in {
                    id(s): s
                    for c in inst_commands
                    for s in c.shapes
                }.values()
            ),
            "scene_build_instanced_s": round(build_inst_s, 3),
        },
    )

    # Per-glyph instanced pairs (individual covers — the form that
    # supports per-glyph colors / incremental redraw).
    t0 = time.perf_counter()
    pg_commands = text_commands(
        font.face, layout, text, t, color=(1, 1, 1, 1)
    )
    build_pg_s = time.perf_counter() - t0
    renderer_pg = Renderer(
        Configuration(), width, height,
        **_renderer_knobs(),
    )

    def frame_pg(i, acc):
        return renderer_pg.render(pg_commands, to_host=False, carry=acc)

    fps = _timed_frames(frame_pg, frames)
    emit(
        "config4_10k_glyphs_1080p_perglyph", fps * n_glyphs, "glyphs/s",
        {
            "glyphs": n_glyphs,
            "frames_per_s": round(fps, 3),
            "commands": len(pg_commands),
            "scene_build_instanced_s": round(build_pg_s, 3),
        },
    )


def config5(frames):
    """Full showcase at 4K."""
    from contrast_renderer.models import showcase
    from contrast_renderer.renderer import Configuration, Renderer

    width, height = 3840, 2160
    renderer = Renderer(Configuration(), width, height, **_renderer_knobs(),)
    shape = showcase.build_shape(with_text=True)
    commands = showcase.showcase_commands(shape, width, height)

    def frame(i, acc):
        shape.set_dynamic_stroke_options(
            0, showcase.dashed_options(i * 0.032)
        )
        return renderer.render(commands, to_host=False, carry=acc)

    fps = _timed_frames(frame, frames)
    emit(
        "config5_showcase_4k", fps, "frames/s",
        {"commands": len(commands), "vs_60fps": round(fps / 60.0, 3)},
    )

    # Config 5 as written: nested clipping (2 levels) + a transparency
    # group — the clip/alpha machinery compiles in (has_clip/has_alpha)
    # and every covered tile pays the per-sample clip compare.
    renderer_ca = Renderer(
        Configuration(alpha_layer_count=1, blending="front_to_back"),
        width, height,
        **_renderer_knobs(),
    )
    commands_ca = showcase.showcase_commands_clip_alpha(
        shape, width, height
    )

    def frame_ca(i, acc):
        shape.set_dynamic_stroke_options(
            0, showcase.dashed_options(i * 0.032)
        )
        return renderer_ca.render(commands_ca, to_host=False, carry=acc)

    fps = _timed_frames(frame_ca, frames)
    emit(
        "config5_showcase_4k_clipalpha", fps, "frames/s",
        {"commands": len(commands_ca), "vs_60fps": round(fps / 60.0, 3)},
    )


def config5_orbit(frames, width, height, label):
    """Showcase under an orbiting camera: instance transforms change
    every frame, so binning re-runs per frame — through the fused
    FrameProgram (camera→binning→raster in ONE dispatch, the
    reference's the-camera-is-just-a-matrix economics,
    examples/showcase/main.rs:255-274)."""
    from contrast_renderer.models import showcase
    from contrast_renderer.renderer import Configuration, Renderer

    renderer = Renderer(
        Configuration(), width, height, strict_capacity=False,
        **_renderer_knobs(),
    )
    shape = showcase.build_shape(with_text=True)
    commands = showcase.showcase_commands(shape, width, height)
    program = renderer.compile_frame(commands)

    def orbit_transforms(i):
        angle = 0.05 * i
        rotor = np.array(
            [math.cos(angle / 2), 0.0, math.sin(angle / 2), 0.0]
        )
        return showcase.command_transforms(
            width, height, view_rotation=rotor
        )

    def frame_fn(i, acc):
        shape.set_dynamic_stroke_options(
            0, showcase.dashed_options(i * 0.032)
        )
        return program(orbit_transforms(i), carry=acc)

    # ONE fused grouping valid across the exact angle set the timed
    # batches visit, compiled before timing starts (per-frame greedy
    # groupings churn a fresh signature almost every frame of a
    # sweep — compiling them during timing measured 1.06 FPS here).
    fused_warm = program.plan_for_motion(
        [orbit_transforms(i) for i in range(3 * frames + 3)],
        timeout=600.0,
    )
    if not fused_warm:
        print(
            f"# {label}: no fused motion plan (or compile timed out); "
            "timing the sequential walk",
            flush=True,
        )
    # Warm the dispatch path (binning + raster compile for whichever
    # variant serves the motion).
    fps = _timed_frames(frame_fn, frames)
    emit(
        label, fps, "frames/s",
        {
            "commands": len(commands),
            "fused_motion_plan": bool(fused_warm),
        },
    )


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--configs", default="1,2,3,4,5,6,7,8",
        help="1-5: scene configs; 6: 1080p orbit; 7: 4K orbit; "
             "8: 4K dashed strokes",
    )
    # 32 frames per timed batch, same as bench.py.
    parser.add_argument("--frames", type=int, default=32)
    args = parser.parse_args()
    from contrast_renderer.utils.runtime import (
        enable_compile_cache,
        require_gpu,
    )

    enable_compile_cache()
    require_gpu("run_configs")
    wanted = {int(x) for x in args.configs.split(",")}
    fns = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}
    for index in sorted(wanted):
        if index == 1:
            config1()
        elif index == 6:
            config5_orbit(
                args.frames, 1920, 1080, "config5c_showcase_1080p_orbit"
            )
        elif index == 7:
            config5_orbit(
                args.frames, 3840, 2160, "config5d_showcase_4k_orbit"
            )
        elif index == 8:
            config3(
                args.frames, 3840, 2160, "config3b_dashed_strokes_4k"
            )
        else:
            fns[index](args.frames)


if __name__ == "__main__":
    main()
