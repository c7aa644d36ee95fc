"""Showcase scene (reference examples/showcase/main.rs) renders end to
end, and the multi-chip band-sharded path produces the same image."""

import numpy as np
import pytest

from contrast_renderer.models import showcase
from contrast_renderer.renderer import Configuration, Renderer


@pytest.fixture(scope="module")
def shape():
    # Text-free variant keeps the tiny-CPU test budget sane; the text
    # pipeline itself is covered by test_text.py.
    return showcase.build_shape(with_text=False)


class TestShowcase:
    def test_full_shape_builds_with_text(self):
        import os

        from contrast_renderer.assets import font_path

        if not os.path.exists(font_path()):
            pytest.skip("OpenSans test font unavailable")
        full = showcase.build_shape(with_text=True)
        # Dashed rounded-rect stroke + "Hello World" glyph fills.
        assert len(full.triangles) > 200
        assert len(full.convex_hull) >= 4

    def test_showcase_renders(self, shape):
        size = 96
        renderer = Renderer(Configuration(), size, size)
        commands = showcase.showcase_commands(shape, size, size)
        assert len(commands) == 2 * (1 + showcase.ROWS * showcase.COLUMNS)
        image = renderer.render(commands[:8])
        assert image.shape == (size, size, 4)
        assert np.isfinite(image).all()
        # The dashed rounded-rect stroke leaves visible pixels.
        assert (image[..., 3] > 0.1).sum() > 20

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_clip_alpha_variant(self, shape):
        """The clipped/grouped showcase (BASELINE config 5 as written):
        outside the nested clips nothing renders; inside, front-to-back
        group algebra scales the whole scene by the group opacity (with
        a transparent backdrop, save=0 ⇒ restore leaves exactly g×scene,
        renderer.rs:756-861)."""
        size = 96
        config = Configuration(
            alpha_layer_count=1, blending="front_to_back"
        )
        renderer = Renderer(config, size, size)
        # Center instance only (+ the 6-command prologue and 3-command
        # epilogue) for budget.
        full = showcase.showcase_commands_clip_alpha(shape, size, size)
        commands = full[:8] + full[-3:]
        assert [int(c.operation) for c in commands] == [
            0, 1, 0, 1, 4, 5, 0, 3, 6, 2, 2,
        ]
        image = renderer.render(commands)
        assert np.isfinite(image).all()
        plain = Renderer(config, size, size).render(
            showcase.showcase_commands(shape, size, size)[:2]
        )
        # Clip corners: outside the rounded outer clip rect.
        assert np.abs(image[:2, :2]).max() == 0.0
        assert np.abs(image[-2:, -2:]).max() == 0.0
        # Interior: exactly opacity-scaled relative to the unclipped
        # render (the ellipse clip covers the center instance).
        center = slice(size // 4, 3 * size // 4)
        diff = np.abs(
            image[center, center] -
            showcase.GROUP_OPACITY * plain[center, center]
        )
        assert diff.max() < 1e-5

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_clip_alpha_instanced_variant(self, shape):
        """The clipped/grouped showcase with ONE instanced stencil/color
        pair: same clip gating, group scaling applies, and the command
        walk collapses (6 prologue + 2 + 3 epilogue)."""
        size = 96
        config = Configuration(
            alpha_layer_count=1, blending="front_to_back"
        )
        renderer = Renderer(config, size, size)
        commands = showcase.showcase_commands_clip_alpha(
            shape, size, size, instanced=True
        )
        assert len(commands) == 11
        assert commands[6].n_instances == 1 + showcase.ROWS * showcase.COLUMNS
        image = renderer.render(commands)
        assert np.isfinite(image).all()
        # Outside the rounded outer clip: nothing.
        assert np.abs(image[:2, :2]).max() == 0.0
        # Content renders inside the clip.
        assert (image[..., 3] > 0.01).sum() > 50

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_frame_program_matches_render(self, shape):
        """The fused FrameProgram (one dispatch, transforms as runtime
        input) renders the same pixels as Renderer.render for moved
        cameras."""
        size = 96
        renderer = Renderer(Configuration(), size, size)
        commands = showcase.showcase_commands(shape, size, size)[:4]
        program = renderer.compile_frame(commands)
        base = np.stack(
            [np.asarray(c.transform, np.float32) for c in commands]
        )
        for angle in (0.0, 0.15):
            rotor = np.array(
                [np.cos(angle / 2), 0.0, np.sin(angle / 2), 0.0]
            )
            moved = showcase.command_transforms(
                size, size, view_rotation=rotor
            )[: len(commands)]
            got = np.asarray(program(moved))
            for c, t in zip(commands, moved):
                c.transform = t
            want = renderer.render(commands)
            assert np.allclose(got, want, atol=1e-6), (
                np.abs(got - want).max()
            )
        for c, t in zip(commands, base):
            c.transform = t

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_dash_phase_animates(self, shape):
        size = 96
        renderer = Renderer(Configuration(), size, size)
        commands = showcase.showcase_commands(shape, size, size)[:2]
        shape.set_dynamic_stroke_options(0, showcase.dashed_options(0.0))
        frame0 = renderer.render(commands)
        shape.set_dynamic_stroke_options(0, showcase.dashed_options(2.0))
        frame1 = renderer.render(commands)
        assert (np.abs(frame0[..., 3] - frame1[..., 3]) > 0.4).sum() > 10
        assert len(renderer._executors) == 1  # no retrace


@pytest.mark.slow  # mesh-program compiles; the driver dryrun covers multichip every round
class TestMultiChip:
    def test_band_sharded_matches_single_device(self, shape):
        import jax
        from jax.sharding import Mesh

        from contrast_renderer.parallel import render_sharded

        # Explicit virtual-CPU mesh: the session default platform may be
        # a single GPU, which cannot host a multi-device mesh.
        cpu_devices = jax.devices("cpu")
        n = min(4, len(cpu_devices))
        assert n >= 2, "need multiple virtual CPU devices (XLA_FLAGS)"
        width, height = 64, 64
        mesh = Mesh(np.array(cpu_devices[:n]), ("y",))
        commands = showcase.showcase_commands(shape, width, height)[:4]
        renderer = Renderer(Configuration(), width, height, tile_size=16)
        sharded = render_sharded(renderer, commands, mesh)
        with jax.default_device(cpu_devices[0]):
            single_renderer = Renderer(
                Configuration(), width, height, tile_size=16, interpret=True
            )
            single = single_renderer.render(commands)
        assert sharded.shape == single.shape
        mismatch = np.mean(np.abs(sharded - single))
        assert mismatch < 1e-4, mismatch

    def test_sharded_frame_program_matches_render_sharded(self, shape):
        """The persistent sharded frame step (traced once, transforms
        as runtime input) renders the same pixels as the per-call
        sharded pipeline under camera motion."""
        import jax
        from jax.sharding import Mesh

        from contrast_renderer.parallel import (
            ShardedFrameProgram,
            render_sharded,
        )

        cpu_devices = jax.devices("cpu")
        n = min(4, len(cpu_devices))
        width, height = 64, 64
        mesh = Mesh(np.array(cpu_devices[:n]), ("y",))
        commands = showcase.showcase_commands(shape, width, height)[:4]
        renderer = Renderer(Configuration(), width, height, tile_size=16)
        program = ShardedFrameProgram(renderer, commands, mesh)
        for angle in (0.0, 0.2):
            rotor = np.array(
                [np.cos(angle / 2), 0.0, np.sin(angle / 2), 0.0]
            )
            moved = showcase.command_transforms(
                width, height, view_rotation=rotor
            )[:4]
            got = np.asarray(program(moved))
            for c, t in zip(commands, moved):
                c.transform = t
            want = render_sharded(
                Renderer(Configuration(), width, height, tile_size=16),
                commands, mesh,
            )
            assert np.allclose(got, want, atol=1e-6), (
                np.abs(got - want).max()
            )

    def test_sharded_frame_program_2d_matches(self, shape):
        import jax
        from jax.sharding import Mesh

        from contrast_renderer.parallel import (
            ShardedFrameProgram2D,
            render_sharded_2d,
        )

        cpu_devices = jax.devices("cpu")
        assert len(cpu_devices) >= 4
        mesh = Mesh(np.array(cpu_devices[:4]).reshape(2, 2), ("y", "x"))
        width, height = 256, 64
        commands = showcase.showcase_commands(shape, width, height)[:4]
        renderer = Renderer(Configuration(), width, height, tile_size=16)
        program = ShardedFrameProgram2D(renderer, commands, mesh)
        got = np.asarray(program())
        want = render_sharded_2d(
            Renderer(Configuration(), width, height, tile_size=16),
            commands, mesh,
        )
        assert np.allclose(got, want, atol=1e-6)

    def test_band_sharded_clip_alpha_matches_single(self, shape):
        """Nested clips + a transparency group through the sharded
        pipeline: the fused SAVE+SCALE cover (OP_SAVE_SCALE) and the
        clip/alpha algebra must survive sub-rect-adjusted projections."""
        import jax
        from jax.sharding import Mesh

        from contrast_renderer.parallel import render_sharded

        cpu_devices = jax.devices("cpu")
        n = min(4, len(cpu_devices))
        assert n >= 2, "need multiple virtual CPU devices (XLA_FLAGS)"
        width, height = 64, 64
        mesh = Mesh(np.array(cpu_devices[:n]), ("y",))
        config = Configuration(
            alpha_layer_count=1, blending="front_to_back"
        )
        full = showcase.showcase_commands_clip_alpha(shape, width, height)
        commands = full[:8] + full[-3:]
        renderer = Renderer(config, width, height, tile_size=16)
        sharded = render_sharded(renderer, commands, mesh)
        with jax.default_device(cpu_devices[0]):
            single_renderer = Renderer(
                config, width, height, tile_size=16, interpret=True
            )
            single = single_renderer.render(commands)
        assert sharded.shape == single.shape
        mismatch = np.mean(np.abs(sharded - single))
        assert mismatch < 1e-4, mismatch

    def test_sharded_instanced_matches_single(self, shape):
        """Instanced DrawCommands (an (N, 4, 4) transform stack on one
        stencil/color pair) cross the mesh and match the single-chip
        image (the r2 sharded pipeline hardcoded cmd_inst=())."""
        import jax
        from jax.sharding import Mesh

        from contrast_renderer.parallel import render_sharded
        from contrast_renderer.renderer import (
            DrawCommand,
            RenderOperation,
        )

        cpu_devices = jax.devices("cpu")
        n = min(4, len(cpu_devices))
        assert n >= 2, "need multiple virtual CPU devices (XLA_FLAGS)"
        width, height = 64, 64
        mesh = Mesh(np.array(cpu_devices[:n]), ("y",))
        transforms, colors = showcase.instance_transforms_and_colors(
            width, height
        )
        t3 = np.ascontiguousarray(transforms[:3], np.float32)
        c3 = np.ascontiguousarray(colors[:3], np.float32)
        commands = [
            DrawCommand(RenderOperation.STENCIL, shape, t3),
            DrawCommand(RenderOperation.COLOR, shape, t3, color=c3),
        ]
        renderer = Renderer(Configuration(), width, height, tile_size=16)
        sharded = render_sharded(renderer, commands, mesh)
        with jax.default_device(cpu_devices[0]):
            single = Renderer(
                Configuration(), width, height, tile_size=16, interpret=True
            ).render(commands)
        mismatch = np.mean(np.abs(sharded - single))
        assert mismatch < 1e-4, mismatch

    def test_sharded_program_gathers_original_transform_layout(self, shape):
        """ShardedFrameProgram accepts transform stacks in the public
        one-row-per-command layout even when SAVE+SCALE fusion drops a
        command: rows of fused-away SAVE covers are gathered out via
        keep_rows (the r2 advisor's silent-misalignment finding)."""
        import jax
        from jax.sharding import Mesh

        from contrast_renderer.parallel import ShardedFrameProgram

        cpu_devices = jax.devices("cpu")
        n = min(4, len(cpu_devices))
        assert n >= 2
        width, height = 64, 64
        mesh = Mesh(np.array(cpu_devices[:n]), ("y",))
        config = Configuration(
            alpha_layer_count=1, blending="front_to_back"
        )
        full = showcase.showcase_commands_clip_alpha(shape, width, height)
        commands = full[:8] + full[-3:]  # 11 commands, SAVE+SCALE at 4/5
        renderer = Renderer(config, width, height, tile_size=16)
        program = ShardedFrameProgram(renderer, commands, mesh)
        # The program's internal (optimized) layout has one row fewer.
        assert program._keep_rows is not None
        assert program._default_transform.shape[0] == len(commands) - 1
        # One row per ORIGINAL command — exactly the commands' stored
        # transforms — must render identically to the default path.
        stack = np.stack(
            [np.asarray(c.transform, np.float32) for c in commands]
        )
        got = np.asarray(program(stack))
        want = np.asarray(program())
        assert np.allclose(got, want), np.abs(got - want).max()
        # A stack sized to the optimized layout cannot be gathered.
        with pytest.raises((ValueError, IndexError)):
            program(stack[:-1])
        # A too-LONG stack must also be rejected: the keep_rows gather
        # would index in range and silently misattribute rows.
        with pytest.raises(ValueError):
            program(np.concatenate([stack, stack[:1]]))

    def test_sharded_program_self_heals_on_overflow(self, shape):
        """A scene that outgrows the program's settled binning
        capacities triggers a deferred rebuild with grown capacities
        (FrameProgram's contract) instead of raising."""
        import jax
        from jax.sharding import Mesh

        from contrast_renderer.parallel import ShardedFrameProgram

        cpu_devices = jax.devices("cpu")
        n = min(4, len(cpu_devices))
        assert n >= 2
        width, height = 64, 64
        mesh = Mesh(np.array(cpu_devices[:n]), ("y",))
        commands = showcase.showcase_commands(shape, width, height)[:2]
        renderer = Renderer(Configuration(), width, height, tile_size=16)
        program = ShardedFrameProgram(renderer, commands, mesh)
        want = np.asarray(program())
        # Fault injection: shrink the per-tile capacity below the
        # scene's real demand (2 entries/tile at this size) and rebuild,
        # simulating a scene that later outgrows its buffers.
        program._sub.tile_capacity = 1
        program._build()
        assert program._limits[0] == 1
        program.OVERFLOW_MAX_LAG = 0  # consume counters synchronously
        # First frame overflows (possibly under-populated); the next
        # call consumes the counter, grows, and rebuilds.
        program()
        healed = np.asarray(program())
        assert program._sub.tile_capacity > 1, program._sub.tile_capacity
        assert np.allclose(healed, want, atol=1e-6), (
            np.abs(healed - want).max()
        )

    def test_sharded_depth_matches_single(self, shape):
        """The per-sample depth buffer composes with band sharding: the
        band-adjusted projection rewrites NDC x/y rows only (z/w rows
        untouched, mesh.py band_adjusted_transform), so per-band depth
        planes equal the full frame's.  Uses the reference showcase's
        LessEqual+write state on two perspective instances whose inks
        genuinely overlap."""
        import jax
        from jax.sharding import Mesh

        from contrast_renderer.parallel import render_sharded
        from contrast_renderer.path import Path
        from contrast_renderer.renderer import (
            DrawCommand,
            RenderOperation,
            Shape,
        )

        cpu_devices = jax.devices("cpu")
        n = min(4, len(cpu_devices))
        assert n >= 2
        width, height = 64, 64
        mesh = Mesh(np.array(cpu_devices[:n]), ("y",))
        solid = Shape(
            [Path.from_rounded_rect((0.0, 0.0), (5.8, 1.3), 0.5)]
        )
        transforms, _ = showcase.instance_transforms_and_colors(
            width, height
        )
        t_center = np.ascontiguousarray(transforms[0], np.float32)
        t_mid = np.ascontiguousarray(transforms[23], np.float32)
        commands = []
        for t, color in (
            (t_center, (1.0, 1.0, 1.0, 1.0)),
            (t_mid, (1.0, 0.0, 0.0, 1.0)),
        ):
            commands += [
                DrawCommand(RenderOperation.STENCIL, solid, t),
                DrawCommand(
                    RenderOperation.COLOR, solid, t, color=color
                ),
            ]
        config = Configuration(
            depth_compare="less_equal", depth_write_enabled=True
        )
        renderer = Renderer(config, width, height, tile_size=16)
        sharded = render_sharded(renderer, commands, mesh)
        with jax.default_device(cpu_devices[0]):
            single = Renderer(
                config, width, height, tile_size=16, interpret=True
            ).render(commands)
        mismatch = np.mean(np.abs(sharded - single))
        assert mismatch < 1e-4, mismatch
        # The depth state must actually have fired: the later mid
        # instance is occluded where the center's ink lies.
        assert (np.asarray(single)[..., 3] > 0).any()

    def test_sharded_program_uint8_output(self, shape):
        """uint8_output=True resolves each band to packed RGBA8 in the
        kernel — bit-identical to quantizing the float sharded frame."""
        import jax
        from jax.sharding import Mesh

        from contrast_renderer.parallel import ShardedFrameProgram

        cpu_devices = jax.devices("cpu")
        n = min(4, len(cpu_devices))
        assert n >= 2
        width, height = 64, 64
        commands = showcase.showcase_commands(shape, width, height)[:2]
        mesh = Mesh(np.array(cpu_devices[:n]), ("y",))
        fprog = ShardedFrameProgram(
            Renderer(Configuration(), width, height, tile_size=16),
            commands, mesh,
        )
        uprog = ShardedFrameProgram(
            Renderer(Configuration(), width, height, tile_size=16),
            commands, mesh, uint8_output=True,
        )
        want = np.asarray(Renderer._quantize(fprog()))
        got = np.asarray(uprog())
        assert got.dtype == np.uint8 and got.shape == (height, width, 4)
        assert np.array_equal(got, want)

    def test_render_sharded_writes_back_grown_capacities(self, shape):
        """Capacity growth inside render_sharded lands on the caller's
        renderer, so a ShardedFrameProgram settling capacities converges
        (the r2 advisor's discarded-growth finding)."""
        import jax
        from jax.sharding import Mesh

        from contrast_renderer.parallel import render_sharded

        cpu_devices = jax.devices("cpu")
        n = min(4, len(cpu_devices))
        assert n >= 2
        width, height = 64, 64
        mesh = Mesh(np.array(cpu_devices[:n]), ("y",))
        commands = showcase.showcase_commands(shape, width, height)[:2]
        renderer = Renderer(
            Configuration(), width, height, tile_size=16, tile_capacity=1
        )
        render_sharded(renderer, commands, mesh)
        assert renderer.tile_capacity > 1

    def test_tile_grid_2d_sharded_matches_single(self, shape):
        import jax
        from jax.sharding import Mesh

        from contrast_renderer.parallel import render_sharded_2d

        cpu_devices = jax.devices("cpu")
        assert len(cpu_devices) >= 4, "need 4 virtual CPU devices"
        mesh = Mesh(np.array(cpu_devices[:4]).reshape(2, 2), ("y", "x"))
        width, height = 256, 64
        commands = showcase.showcase_commands(shape, width, height)[:4]
        renderer = Renderer(Configuration(), width, height, tile_size=16)
        sharded = render_sharded_2d(renderer, commands, mesh)
        with jax.default_device(cpu_devices[0]):
            single_renderer = Renderer(
                Configuration(), width, height, tile_size=16, interpret=True
            )
            single = single_renderer.render(commands)
        assert sharded.shape == single.shape
        mismatch = np.mean(np.abs(sharded - single))
        assert mismatch < 1e-4, mismatch
