"""Text subsystem tests: TTF parsing, glyph outlines, layout, caret math.

Uses the reference repository's bundled OpenSans-Regular.ttf as test
data (the same fixture its showcase uses, examples/showcase/main.rs:10).
"""

import numpy as np
import pytest

from contrast_renderer import oracle
from contrast_renderer.fill import FillBuilder
from contrast_renderer.text import (
    Alignment,
    Font,
    Layout,
    Orientation,
    TextGeometry,
    byte_offset_of_char_index,
    paths_of_glyph,
    paths_of_text,
)

from contrast_renderer.assets import font_path

FONT_PATH = font_path()

import os

pytestmark = pytest.mark.skipif(
    not os.path.exists(FONT_PATH), reason="OpenSans test font unavailable"
)


@pytest.fixture(scope="module")
def font():
    with open(FONT_PATH, "rb") as fh:
        return Font("OpenSans", fh.read())


class TestFace:
    def test_metrics(self, font):
        face = font.face
        assert face.units_per_em == 2048
        assert face.ascender > 0
        assert face.descender < 0
        assert face.height() == face.ascender - face.descender
        assert face.num_glyphs > 500

    def test_glyph_index(self, font):
        face = font.face
        a = face.glyph_index("A")
        assert a is not None and a > 0
        assert face.glyph_index("B") == a + 1  # Latin run is contiguous
        assert face.glyph_index("") is None or True

    def test_advances_and_bbox(self, font):
        face = font.face
        glyph = face.glyph_index("M")
        adv = face.glyph_hor_advance(glyph)
        assert adv is not None and 0 < adv < face.units_per_em * 2
        bbox = face.glyph_bounding_box(glyph)
        assert bbox is not None
        assert bbox[0] < bbox[2] and bbox[1] < bbox[3]

    def test_kerning_table_parsed(self, font):
        # OpenSans has a kern table with (T, o)-style pairs; just check
        # the lookup path works and at least some pair kerns negative.
        face = font.face
        assert isinstance(face._kern, dict)

    def test_space_has_no_outline(self, font):
        face = font.face
        space = face.glyph_index(" ")
        assert paths_of_glyph(face, space) == []


class TestGlyphOutlines:
    def test_outline_structure(self, font):
        face = font.face
        paths = paths_of_glyph(face, face.glyph_index("O"))
        assert len(paths) == 2  # outer + inner contour
        for p in paths:
            # Closed contours: end == start.
            assert np.allclose(p.get_end(), p.start) or len(p) > 0

    def test_glyph_renders_with_hole(self, font):
        face = font.face
        paths = paths_of_glyph(face, face.glyph_index("O"))
        # Scale into a 64² raster.
        bbox = face.glyph_bounding_box(face.glyph_index("O"))
        from contrast_renderer.utils import ga2d

        scale = 56.0 / face.units_per_em
        for p in paths:
            p.transform(
                scale, ga2d.translate2d([8.0, 12.0])
            )
        builder = FillBuilder()
        hull = []
        for p in paths:
            builder.add_path(hull, p)
        table = builder.build()
        winding = oracle.rasterize_fill_table(table, 64, 64)
        coverage = oracle.coverage_from_winding(winding)
        # The middle of the O is a hole; the stem is filled.
        resolved = coverage.mean(axis=-1)
        cx = 8 + (bbox[0] + bbox[2]) / 2 * scale
        cy_model = 12 + (bbox[1] + bbox[3]) / 2 * scale
        row = int(64 - cy_model)
        col = int(cx)
        assert resolved[row, col] == 0.0  # hole
        # Some filled pixels on the left stem.
        left_col = int(8 + bbox[0] * scale + 2)
        assert resolved[row, left_col] > 0.5


class TestLayout:
    def test_paths_of_text_centered(self, font):
        layout = Layout(
            size=2.7,
            orientation=Orientation.LEFT_TO_RIGHT,
            major_alignment=Alignment.CENTER,
            minor_alignment=Alignment.CENTER,
        )
        paths = paths_of_text(font.face, layout, "Hello World")
        assert len(paths) > 10
        points = np.concatenate(
            [[p.start] + [s.control_points[-1] for _, s in p.iter_segments()] for p in paths]
        )
        # Centered: bounding box roughly symmetric around the origin.
        mn, mx = points.min(axis=0), points.max(axis=0)
        assert abs((mn[0] + mx[0]) / 2) < 0.3
        assert abs((mn[1] + mx[1]) / 2) < 0.5
        assert mx[0] - mn[0] > 5.0  # text is wide

    def test_multiline(self, font):
        layout = Layout(size=1.0)
        single = paths_of_text(font.face, layout, "aa")
        double = paths_of_text(font.face, layout, "aa\naa")
        assert len(double) == 2 * len(single)

    def test_clipping_culls_glyphs(self, font):
        from contrast_renderer.utils import ga2d

        layout = Layout(size=2.0)
        clip = ga2d.aabb_to_convex_polygon([-100.0, -100.0, 100.0, 100.0])
        everything = paths_of_text(font.face, layout, "abc", clip)
        tiny_clip = ga2d.aabb_to_convex_polygon([50.0, 50.0, 51.0, 51.0])
        nothing = paths_of_text(font.face, layout, "abc", tiny_clip)
        assert len(everything) > 0
        assert len(nothing) == 0

    def test_kerning_applied(self, font):
        # "To" kerns tighter than "Tl" in OpenSans (if pairs exist, the
        # widths differ by the kerning amount).
        layout = Layout(size=10.0, major_alignment=Alignment.BEGIN)
        geometry = TextGeometry.new(font.face, layout, "To")
        assert geometry.half_extent[0] > 0


class TestTextGeometry:
    def test_caret_roundtrip(self, font):
        layout = Layout(size=10.0)
        geometry = TextGeometry.new(font.face, layout, "Hello\nWorld")
        assert len(geometry.lines) == 2
        assert geometry.line_index_from_char_index(0) == 0
        assert geometry.line_index_from_char_index(7) == 1
        # Position of a glyph maps back to its index.
        line0 = geometry.lines[0][1]
        cursor = (line0[2][0] + 0.01, line0[2][1])
        index = geometry.char_index_from_position(cursor)
        assert index in (1, 2, 3)

    def test_advance_by_line(self, font):
        layout = Layout(size=10.0)
        geometry = TextGeometry.new(font.face, layout, "Hello\nWorld")
        below = geometry.advance_char_index_by_line_index(2, 1)
        assert geometry.line_index_from_char_index(below) == 1
        assert geometry.advance_char_index_by_line_index(2, -1) == 0

    def test_byte_offset(self):
        assert byte_offset_of_char_index("abc", 2) == 2
        assert byte_offset_of_char_index("héllo", 2) == 3
        assert byte_offset_of_char_index("ab", 5) == 2


class TestShapeOfText:
    def test_matches_classic_build(self, font):
        """shape_of_text (per-glyph table cache + instance stamping)
        produces the same triangle multiset as Shape(paths_of_text(...))
        up to f32 rounding of the transform order.

        Tessellation commutes with the affine glyph placement, so the
        two builds must agree triangle-for-triangle; only the order
        differs (classic walks instances, fast groups by glyph).  The
        comparison is order-invariant: per-coordinate sorted sequences
        of ε-close multisets are pointwise ε-close.
        """
        from contrast_renderer.renderer import Shape
        from contrast_renderer.text import shape_of_text

        layout = Layout(
            size=20.0,
            orientation=Orientation.LEFT_TO_RIGHT,
            major_alignment=Alignment.CENTER,
            minor_alignment=Alignment.CENTER,
        )
        text = "Wavy 123"
        fast = shape_of_text(font.face, layout, text)
        classic = Shape(paths_of_text(font.face, layout, text))
        ft, ct = fast.triangles, classic.triangles
        assert len(ft) == len(ct)
        assert np.array_equal(np.sort(ft.kind), np.sort(ct.kind))
        for name in ("xy", "aux"):
            a = getattr(ft, name).reshape(len(ft), -1).astype(np.float64)
            b = getattr(ct, name).reshape(len(ct), -1).astype(np.float64)
            np.testing.assert_allclose(
                np.sort(a, axis=0), np.sort(b, axis=0), atol=2e-3,
                err_msg=name,
            )
        # Signed areas agree in the sorted-multiset sense too (catches
        # flipped winding that coordinate sorting could mask).
        def areas(t):
            v = t.xy.astype(np.float64)
            e1 = v[:, 1] - v[:, 0]
            e2 = v[:, 2] - v[:, 0]
            return np.sort(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])

        np.testing.assert_allclose(areas(ft), areas(ct), atol=2e-2)
        # Hulls: the fast hull must contain the classic hull (it is
        # built from per-glyph hulls, a superset of the proto-hull).
        from contrast_renderer.convex_hull import andrew

        both = andrew(np.concatenate([fast.convex_hull, classic.convex_hull]))
        assert len(both) <= len(fast.convex_hull) + len(classic.convex_hull)

    def test_cache_reused_across_calls(self, font):
        from contrast_renderer.text import shape_of_text

        layout = Layout(size=12.0)
        a = shape_of_text(font.face, layout, "abcabc")
        b = shape_of_text(font.face, layout, "abc")
        assert len(a.triangles) == 2 * len(b.triangles)
        assert getattr(font.face, "_glyph_table_cache", None)


@pytest.mark.slow  # large instanced batteries; the fused-command equality below stays in the fast gate
class TestTextCommands:
    """text_commands: instanced per-unique-glyph draws (the reference's
    per-glyph vertex buffers + instanced draw, text.rs:97-104,
    renderer.rs:462-466) — pixel-exact against the monolithic
    shape_of_text build for opaque text."""

    def _layout(self, size=24.0):
        return Layout(
            size=size,
            orientation=Orientation.LEFT_TO_RIGHT,
            major_alignment=Alignment.BEGIN,
            minor_alignment=Alignment.BEGIN,
        )

    def test_matches_monolith_pixels(self, font):
        from contrast_renderer.renderer import (
            Configuration, DrawCommand, RenderOperation, Renderer)
        from contrast_renderer.text import shape_of_text, text_commands

        layout = self._layout()
        text = "the quick brown fox\njumps over the lazy dog"
        t = np.diag(
            [2.0 / 300.0, 2.0 / 300.0, 1.0, 1.0]
        ).astype(np.float32)
        t[0, 3] = -1.0
        t[1, 3] = 0.8
        shape = shape_of_text(font.face, layout, text)
        mono = Renderer(Configuration(), 256, 256).render([
            DrawCommand(RenderOperation.STENCIL, shape, t),
            DrawCommand(
                RenderOperation.COLOR, shape, t, color=(1, 1, 1, 1)
            ),
        ])
        commands = text_commands(
            font.face, layout, text, t, color=(1, 1, 1, 1)
        )
        inst = Renderer(Configuration(), 256, 256).render(commands)
        assert np.array_equal(mono, inst)
        # Repeated letters share one instanced pair; every non-space
        # glyph is drawn exactly once.
        stencils = [
            c for c in commands
            if c.operation == RenderOperation.STENCIL
        ]
        assert any(c.n_instances > 1 for c in stencils)
        n_glyphs = sum(1 for ch in text if not ch.isspace())
        assert sum(c.n_instances for c in stencils) == n_glyphs

    def test_glyph_shape_cached_and_instanced(self, font):
        from contrast_renderer.renderer import RenderOperation
        from contrast_renderer.text import glyph_shape, text_commands

        layout = self._layout()
        t = np.diag(
            [2.0 / 400.0, 2.0 / 400.0, 1.0, 1.0]
        ).astype(np.float32)
        t[0, 3] = -1.0
        commands = text_commands(font.face, layout, "aaaa b", t)
        # 'a' x4 -> one instanced pair; 'b' -> one single pair;
        # the space has no outline and emits nothing.
        stencils = [
            c for c in commands
            if c.operation == RenderOperation.STENCIL
        ]
        assert sorted(c.n_instances for c in stencils) == [1, 4]
        gid = font.face.glyph_index("a")
        assert glyph_shape(font.face, gid) is stencils[0].shape or \
            glyph_shape(font.face, gid) is stencils[1].shape
        # The per-face cache serves repeated calls the same object.
        assert glyph_shape(font.face, gid) is glyph_shape(font.face, gid)

    def test_matches_sequential_walk_translucent(self, font):
        """The instanced command list must be pixel-exact against the
        fully-sequential per-instance walk even with translucent color
        (where an unsound grouping would double-blend overlap)."""
        from contrast_renderer.renderer import (
            Configuration, DrawCommand, RenderOperation, Renderer)
        from contrast_renderer.text import text_commands

        layout = self._layout(size=48.0)
        t = np.diag(
            [2.0 / 300.0, 2.0 / 300.0, 1.0, 1.0]
        ).astype(np.float32)
        t[0, 3] = -1.0
        t[1, 3] = 0.2
        commands = text_commands(
            font.face, layout, "mammal", t, color=(1.0, 0.4, 0.2, 0.5)
        )
        inst_img = Renderer(Configuration(), 128, 128).render(commands)
        # The sequential walk: every instanced (STENCIL, COLOR) pair
        # expands to S0 C0 S1 C1 ... in instance order.
        seq_cmds = []
        k = 0
        while k < len(commands):
            s, col = commands[k], commands[k + 1]
            tf = np.asarray(s.transform, np.float32).reshape(-1, 4, 4)
            for i in range(s.n_instances):
                seq_cmds.append(
                    DrawCommand(RenderOperation.STENCIL, s.shape, tf[i])
                )
                seq_cmds.append(
                    DrawCommand(
                        RenderOperation.COLOR, col.shape, tf[i],
                        color=col.color,
                    )
                )
            k += 2
        seq_img = Renderer(
            Configuration(), 128, 128, auto_instance=False
        ).render(seq_cmds)
        assert np.array_equal(inst_img, seq_img)

    def test_flag_overlapping_boxes(self):
        from contrast_renderer.text import _flag_overlapping_boxes

        boxes = np.array([
            [0.0, 0.0, 1.0, 1.0],     # overlaps #2
            [5.0, 0.0, 6.0, 1.0],     # isolated
            [0.5, 0.5, 1.5, 1.5],     # overlaps #0
            [0.0, 3.0, 1.0, 4.0],     # same x range, disjoint y
        ])
        flags = _flag_overlapping_boxes(boxes)
        assert flags.tolist() == [True, False, True, False]
        # Touching boxes count as overlapping (closed-box test).
        touching = np.array([
            [0.0, 0.0, 1.0, 1.0],
            [1.0, 0.0, 2.0, 1.0],
        ])
        assert _flag_overlapping_boxes(touching).all()

    def test_near_plane_instances_fall_back(self, font):
        """Instances whose projected hull crosses the near plane are
        emitted as sequential pairs (their boxes are undefined)."""
        from contrast_renderer.renderer import RenderOperation
        from contrast_renderer.text import text_commands

        layout = self._layout()
        behind = np.eye(4, dtype=np.float32)
        behind[3, 2] = -2.0
        behind[3, 3] = -0.5  # w < 0 over the whole layout
        commands = text_commands(font.face, layout, "aaa", behind)
        stencils = [
            c for c in commands
            if c.operation == RenderOperation.STENCIL
        ]
        assert all(c.n_instances == 1 for c in stencils)


class TestCmapLegacyFormats:
    """cmap formats 0 (byte) and 6 (trimmed) — legacy tables some fonts
    ship alone (ttf-parser supports them; OpenSans itself uses 4/12)."""

    @staticmethod
    def _parse(payload):
        import struct

        from contrast_renderer import ttf

        face = ttf.Face.__new__(ttf.Face)
        face.data = (
            struct.pack(">HH", 0, 1)
            + struct.pack(">HHI", 0, 3, 12)
            + payload
        )
        face.tables = {"cmap": (0, len(face.data))}
        return ttf.Face._parse_cmap(face)

    def test_format0(self):
        import struct

        payload = struct.pack(">HHH", 0, 262, 0) + bytes(
            [(i % 200) for i in range(256)]
        )
        mapping = self._parse(payload)
        assert mapping[1] == 1 and mapping[199] == 199
        assert 0 not in mapping and 200 not in mapping  # glyph 0 skipped

    def test_format6(self):
        import struct

        payload = struct.pack(">HHHHH", 6, 16, 0, 65, 3) + struct.pack(
            ">HHH", 7, 0, 9
        )
        mapping = self._parse(payload)
        assert mapping == {65: 7, 67: 9}


class TestTextCommandsFused:
    """text_commands_fused: ONE multi-shape instanced stencil + ONE
    whole-string cover — the monolith's exact two-command walk
    (renderer.rs:187-209, 267-355) over per-glyph cached tables."""

    def _layout(self, size=24.0):
        return Layout(
            size=size,
            orientation=Orientation.LEFT_TO_RIGHT,
            major_alignment=Alignment.BEGIN,
            minor_alignment=Alignment.BEGIN,
        )

    def test_matches_monolith_pixels(self, font):
        from contrast_renderer.renderer import (
            Configuration, DrawCommand, RenderOperation, Renderer)
        from contrast_renderer.text import (
            shape_of_text, text_commands_fused)

        layout = self._layout()
        text = "the quick brown fox\njumps over the lazy dog"
        t = np.diag(
            [2.0 / 300.0, 2.0 / 300.0, 1.0, 1.0]
        ).astype(np.float32)
        t[0, 3] = -1.0
        t[1, 3] = 0.8
        shape = shape_of_text(font.face, layout, text)
        mono = Renderer(Configuration(), 256, 256).render([
            DrawCommand(RenderOperation.STENCIL, shape, t),
            DrawCommand(
                RenderOperation.COLOR, shape, t, color=(1, 1, 1, 1)
            ),
        ])
        commands = text_commands_fused(
            font.face, layout, text, t, color=(1, 1, 1, 1)
        )
        # Exactly two commands: a multi-shape stencil carrying every
        # glyph instance, and one cover.
        assert len(commands) == 2
        stencil, cover = commands
        n_glyphs = sum(1 for ch in text if not ch.isspace())
        assert stencil.n_instances == n_glyphs
        assert len(stencil.shapes) == n_glyphs
        assert cover.n_instances == 1
        fused = Renderer(Configuration(), 256, 256).render(commands)
        assert np.array_equal(mono, fused)

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_translucent_color_matches_monolith(self, font):
        """Translucent text is where per-glyph covers diverge from the
        monolith (overlap double-paints); the fused form must match the
        monolith exactly even then."""
        from contrast_renderer.renderer import (
            Configuration, DrawCommand, RenderOperation, Renderer)
        from contrast_renderer.text import (
            shape_of_text, text_commands_fused)

        layout = self._layout(30.0)
        text = "AVA To fi"
        t = np.diag(
            [2.0 / 200.0, 2.0 / 200.0, 1.0, 1.0]
        ).astype(np.float32)
        t[0, 3] = -1.0
        t[1, 3] = 0.2
        shape = shape_of_text(font.face, layout, text)
        mono = Renderer(Configuration(), 128, 128).render([
            DrawCommand(RenderOperation.STENCIL, shape, t),
            DrawCommand(
                RenderOperation.COLOR, shape, t,
                color=(0.9, 0.4, 0.2, 0.5),
            ),
        ])
        fused = Renderer(Configuration(), 128, 128).render(
            text_commands_fused(
                font.face, layout, text, t, color=(0.9, 0.4, 0.2, 0.5)
            )
        )
        assert np.array_equal(mono, fused)
