"""CFF (OpenType .otf) outline support.

The reference's text feature parses CFF outlines through ttf-parser
(src/text.rs:25); here `ttf.Face` dispatches to `cff.py`.  Test fonts
are synthesized with fontTools (test-only tool), and outlines are
verified against fontTools's own Type 2 charstring interpreter as an
independent oracle.  A real CFF font with local subroutines (a pygame
test fixture, if installed) cross-checks every glyph.
"""

import io
import os

import numpy as np
import pytest

pytest.importorskip("fontTools")

from fontTools.fontBuilder import FontBuilder
from fontTools.misc.psCharStrings import T2CharString
from fontTools.pens.recordingPen import RecordingPen
from fontTools.pens.t2CharStringPen import T2CharStringPen
from fontTools.ttLib import TTFont

from contrast_renderer.error import UnsupportedFontFormat
from contrast_renderer.text import Font, paths_of_glyph
from contrast_renderer.ttf import Face

PYGAME_OTF = (
    "/opt/venv/lib/python3.12/site-packages/pygame/tests/fixtures/"
    "fonts/test_fixed.otf"
)


class RecBuilder:
    """Records ttf.Face outline callbacks in RecordingPen's shape."""

    def __init__(self):
        self.ops = []
        self._start = None
        self._cur = None

    def move_to(self, x, y):
        self.ops.append(("moveTo", ((x, y),)))
        self._start = self._cur = (x, y)

    def line_to(self, x, y):
        self.ops.append(("lineTo", ((x, y),)))
        self._cur = (x, y)

    def quad_to(self, x1, y1, x, y):
        self.ops.append(("qCurveTo", ((x1, y1), (x, y))))
        self._cur = (x, y)

    def curve_to(self, x1, y1, x2, y2, x, y):
        self.ops.append(("curveTo", ((x1, y1), (x2, y2), (x, y))))
        self._cur = (x, y)

    def close(self):
        self.ops.append(("closePath", ()))


def _assert_outlines_match(got_ops, want_ops, label=""):
    """Compare our callback stream to RecordingPen's value stream.

    fontTools' T2 interpreter emits an explicit closing lineTo back to
    the contour start when the last point differs; ours relies on the
    fill's implicit contour closing (as the reference's OutlineBuilder
    does).  Normalize by dropping a lineTo-to-start directly preceding
    closePath on both sides."""

    def normalize(ops):
        out = []
        start = None
        for op, args in ops:
            if op == "moveTo":
                start = args[0]
            if (
                op == "closePath"
                and out
                and out[-1][0] == "lineTo"
                and start is not None
                and np.allclose(out[-1][1][0], start, atol=1e-6)
            ):
                out.pop()
            out.append((op, args))
        return out

    got = normalize(got_ops)
    want = normalize(want_ops)
    assert len(got) == len(want), (
        f"{label}: {len(got)} ops vs oracle {len(want)}\n{got}\n{want}"
    )
    for (g_op, g_args), (w_op, w_args) in zip(got, want):
        assert g_op == w_op, f"{label}: {g_op} vs {w_op}"
        ga = np.asarray(g_args, np.float64).reshape(-1)
        wa = np.asarray(w_args, np.float64).reshape(-1)
        assert np.allclose(ga, wa, atol=1e-6), (
            f"{label}: {g_op} {g_args} vs {w_args}"
        )


def build_otf(charstrings_extra=None, draw_fns=None, upem=1000):
    """Synthesize a minimal OTF: .notdef + the given glyphs, mapped to
    their single-character names."""
    draw_fns = draw_fns or {}
    charstrings_extra = charstrings_extra or {}
    order = [".notdef"] + sorted(draw_fns) + sorted(charstrings_extra)
    fb = FontBuilder(upem, isTTF=False)
    fb.setupGlyphOrder(order)
    fb.setupCharacterMap(
        {ord(g): g for g in list(draw_fns) + list(charstrings_extra)}
    )
    charstrings = {".notdef": T2CharStringPen(600, None).getCharString()}
    for name, fn in draw_fns.items():
        pen = T2CharStringPen(600, None)
        fn(pen)
        charstrings[name] = pen.getCharString()
    charstrings.update(charstrings_extra)
    fb.setupCFF("TestCFF", {}, charstrings, {})
    fb.setupHorizontalMetrics({g: (600, 50) for g in order})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "TestCFF", "styleName": "Regular"})
    fb.setupOS2()
    fb.setupPost()
    buf = io.BytesIO()
    fb.save(buf)
    return buf.getvalue()


def _oracle_ops(font_bytes, glyph_name):
    tt = TTFont(io.BytesIO(font_bytes))
    pen = RecordingPen()
    tt["CFF "].cff[0].CharStrings[glyph_name].draw(pen)
    return pen.value


def _our_ops(font_bytes, glyph_name):
    face = Face(font_bytes)
    # Resolve the glyph id via the font's glyph order (fontTools) so the
    # comparison does not depend on our cmap.
    gid = TTFont(io.BytesIO(font_bytes)).getGlyphID(glyph_name)
    rec = RecBuilder()
    face.outline_glyph(gid, rec)
    return rec.ops


class TestCFFOutlines:
    def test_lines_and_cubics_roundtrip(self):
        def draw_a(pen):
            pen.moveTo((100, 100))
            pen.lineTo((500, 100))
            pen.lineTo((500, 500))
            pen.lineTo((100, 500))
            pen.closePath()

        def draw_b(pen):
            pen.moveTo((100, 0))
            pen.curveTo((150, 200), (450, 600), (300, 700))
            pen.curveTo((250, 650), (120, 380), (100, 300))
            pen.closePath()
            # Second contour: a counter.
            pen.moveTo((200, 200))
            pen.lineTo((200, 300))
            pen.curveTo((250, 330), (300, 280), (280, 210))
            pen.closePath()

        data = build_otf(draw_fns={"A": draw_a, "B": draw_b})
        for g in ("A", "B"):
            _assert_outlines_match(
                _our_ops(data, g), _oracle_ops(data, g), g
            )

    def test_specialized_operators_match_oracle(self):
        """Hand-assembled charstrings per Type 2 operator family,
        cross-checked against fontTools's interpreter."""
        progs = {
            # hlineto/vlineto alternation, odd and even counts.
            "C": [100, 100, "rmoveto", 50, 40, 30, "hlineto",
                  25, 35, "vlineto", "endchar"],
            # vvcurveto with leading dx1; hhcurveto with leading dy1.
            "D": [100, 100, "rmoveto",
                  13, 10, 20, 30, 40, 10, 20, 30, 40, "vvcurveto",
                  7, 10, 20, 30, 40, "hhcurveto", "endchar"],
            # vhcurveto with trailing 5th arg; rcurveline; rlinecurve.
            "E": [50, 50, "rmoveto",
                  10, 20, 30, 40, 50, 60, 70, 80, 15, "vhcurveto",
                  5, 6, 7, 8, 9, 10, 11, 12, "rcurveline",
                  3, 4, 5, 6, 1, 2, 3, 4, 5, 6, "rlinecurve",
                  "endchar"],
            # Stems + hintmask skipping; width argument present (601).
            "F": [601, 20, 40, 100, 40, "hstemhm", 30, 50, "vstemhm",
                  "hintmask", b"\xf0",
                  80, 80, "rmoveto", 200, "hlineto", 100, "vlineto",
                  "endchar"],
            # The flex family.
            "G": [100, 400, "rmoveto",
                  10, 20, 30, 40, 50, -20, 30, -40, 20, -10, 10, 30, 50,
                  "flex",
                  20, 30, 40, 50, 60, 70, 80, "hflex",
                  10, 20, 30, 40, 50, 60, 70, -30, 80, "hflex1",
                  11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, "flex1",
                  "endchar"],
        }
        charstrings = {
            name: T2CharString(program=prog) for name, prog in progs.items()
        }
        data = build_otf(charstrings_extra=charstrings)
        for g in progs:
            _assert_outlines_match(
                _our_ops(data, g), _oracle_ops(data, g), g
            )

    def test_face_integration(self):
        """glyph_index / bounding box / paths_of_glyph over a CFF face."""

        def draw_a(pen):
            pen.moveTo((100, 100))
            pen.lineTo((500, 100))
            pen.lineTo((300, 500))
            pen.closePath()

        data = build_otf(draw_fns={"A": draw_a})
        font = Font("synthetic-otf", data)
        gid = font.face.glyph_index("A")
        assert gid is not None
        paths = paths_of_glyph(font.face, gid)
        assert len(paths) == 1
        bbox = font.face.glyph_bounding_box(gid)
        assert bbox == (100, 100, 500, 500)
        assert font.face.glyph_hor_advance(gid) == 600

    @pytest.mark.skipif(
        not os.path.exists(PYGAME_OTF), reason="pygame OTF fixture absent"
    )
    def test_real_font_with_local_subrs_matches_oracle(self):
        """Every glyph of a real CFF font (378 local subroutine calls,
        biased indices) decodes identically to fontTools."""
        with open(PYGAME_OTF, "rb") as fh:
            data = fh.read()
        face = Face(data)
        tt = TTFont(io.BytesIO(data))
        cs = tt["CFF "].cff[0].CharStrings
        n_checked = 0
        for name in tt.getGlyphOrder():
            want = RecordingPen()
            cs[name].draw(want)
            rec = RecBuilder()
            face.outline_glyph(tt.getGlyphID(name), rec)
            _assert_outlines_match(rec.ops, want.value, name)
            n_checked += 1
        assert n_checked > 300

    def test_unsupported_formats_fail_loudly(self):
        def draw_a(pen):
            pen.moveTo((0, 0))
            pen.lineTo((10, 0))
            pen.closePath()

        data = build_otf(draw_fns={"A": draw_a})
        with pytest.raises(UnsupportedFontFormat):
            Face(data.replace(b"CFF ", b"CFF2"))
        with pytest.raises(UnsupportedFontFormat):
            Face(data.replace(b"CFF ", b"XYZ "))

    def test_div_operator_matches_oracle(self):
        """`div` (12 12) — common in CFF fonts converted from Type 1,
        where fractional operand values are expressed as quotients; the
        result must stay on the stack as an operand (TN #5177 §4.4)."""
        progs = {
            "H": [0, 0, "rmoveto",
                  201, 3, "div", 20, "rlineto",
                  100, 8, "div", 50, "rlineto", "endchar"],
        }
        charstrings = {
            name: T2CharString(program=prog) for name, prog in progs.items()
        }
        data = build_otf(charstrings_extra=charstrings)
        _assert_outlines_match(_our_ops(data, "H"), _oracle_ops(data, "H"))

    def test_arithmetic_and_storage_operators(self):
        """Direct interpreter test of the Type 2 arithmetic, storage and
        conditional escape operators (TN #5177 §4.4-4.5)."""
        from contrast_renderer.cff import _Type2Interp

        def esc(b1):
            return bytes((12, b1))

        def num(v):
            if isinstance(v, float) and v != int(v):
                import struct as _s

                return b"\xff" + _s.pack(">i", int(round(v * 65536)))
            v = int(v)
            assert -32768 <= v <= 32767
            import struct as _s

            return b"\x1c" + _s.pack(">h", v)

        RLINETO = bytes((5,))
        RMOVETO = bytes((21,))
        ENDCHAR = bytes((14,))
        code = (
            num(0) + num(0) + RMOVETO
            # add/sub → line(70, 75)
            + num(30) + num(40) + esc(10)
            + num(90) + num(15) + esc(11) + RLINETO
            # mul/sqrt → line(40, 25)
            + num(5) + num(8) + esc(24) + num(625) + esc(26) + RLINETO
            # abs/neg → line(34, -44)
            + num(-34) + esc(9) + num(44) + esc(14) + RLINETO
            # dup → line(25, 25)
            + num(25) + esc(27) + RLINETO
            # exch → line(9, 7)
            + num(7) + num(9) + esc(28) + RLINETO
            # drop → line(5, 6)
            + num(5) + num(6) + num(99) + esc(18) + RLINETO
            # put/get → line(33, 12)
            + num(33) + num(5) + esc(20) + num(5) + esc(21)
            + num(12) + RLINETO
            # ifelse (v1 <= v2 → s1) → line(1, 2); (v1 > v2 → s2) kept
            + num(1) + num(7) + num(3) + num(4) + esc(22)
            + num(2) + RLINETO
            + num(8) + num(1) + num(4) + num(3) + esc(22)
            + num(2) + RLINETO  # line(1, 2) again (s2=1 selected)
            # and/or/not/eq → line(1, 1), line(0, 1)
            + num(2) + num(3) + esc(3) + num(0) + num(4) + esc(4)
            + RLINETO
            + num(5) + esc(5) + num(6) + num(6) + esc(15) + RLINETO
            # index (copy 2nd-from-top) → line(77, 88, 77) pairs off:
            # stack [77, 88, index(1)=77] is odd; use explicit pair
            + num(77) + num(88) + num(1) + esc(29) + num(99) + RLINETO
            # roll(3, 1): [a b c] → [c a b]; line pairs (30,10),(20, n)
            + num(10) + num(20) + num(30) + num(3) + num(1) + esc(30)
            + num(40) + RLINETO
            + ENDCHAR
        )
        rec = RecBuilder()
        interp = _Type2Interp([], [], rec)
        interp.run(code)
        lines = [a for op, a in rec.ops if op == "lineTo"]
        deltas = []
        cur = (0.0, 0.0)
        for ((x, y),) in lines:
            deltas.append((x - cur[0], y - cur[1]))
            cur = (x, y)
        assert deltas == [
            (70.0, 75.0),       # add, sub
            (40.0, 25.0),       # mul, sqrt
            (34.0, -44.0),      # abs, neg
            (25.0, 25.0),       # dup
            (9.0, 7.0),         # exch
            (5.0, 6.0),         # drop
            (33.0, 12.0),       # put, get
            (1.0, 2.0),         # ifelse v1<=v2 → s1
            (1.0, 2.0),         # ifelse v1>v2 → s2
            (1.0, 1.0),         # and, or
            (0.0, 1.0),         # not, eq
            (77.0, 88.0),       # index leaves [77, 88, 77, 99]
            (77.0, 99.0),
            (30.0, 10.0),       # roll: [10 20 30] → [30 10 20]
            (20.0, 40.0),
        ]

    def test_bounding_box_floors_negative_minima(self):
        """The bbox must be a superset of the ink (SAT glyph culling
        relies on it): fractional negative minima floor, maxima ceil."""
        progs = {
            "K": [T2CharString(program=[
                -21, 2, "div", -37, 10, "div", "rmoveto",  # (-10.5, -3.7)
                102, 5, "div", 0, "rlineto",               # → (9.9, -3.7)
                0, 77, 10, "div", "rlineto",               # → (9.9, 4.0)
                "endchar",
            ])][0],
        }
        data = build_otf(charstrings_extra=progs)
        face = Face(data)
        gid = TTFont(io.BytesIO(data)).getGlyphID("K")
        assert face.glyph_bounding_box(gid) == (-11, -4, 10, 4)
