"""Text: font faces, glyph outlines → paths, layout and caret geometry.

Mirrors the reference's optional text subsystem (src/text.rs) on top of
the pure-Python TTF reader (`ttf.py`): glyph outlines become Paths (one
per contour, src/text.rs:60-94), strings are laid out with kerning,
line breaking and alignment (src/text.rs:145-230), and `TextGeometry`
provides caret/hit-testing math (src/text.rs:266-347).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .path import (
    IntegralCubicCurveSegment,
    IntegralQuadraticCurveSegment,
    LineSegment,
    Path,
)
from .ttf import Face
from .utils import ga2d

REPLACEMENT_CHARACTER = "�"


class Font:
    """Heap-owned font face (reference src/text.rs:10-38)."""

    def __init__(self, name: str, font_data: bytes):
        self._name = name
        self.face = Face(bytes(font_data), 0)

    def name(self) -> str:
        return self._name

    def __repr__(self):
        return f"Font({self._name!r})"


class _OutlineBuilder:
    """Maps outline callbacks to Path pushes, one Path per contour
    (reference src/text.rs:60-94)."""

    def __init__(self):
        self.path = Path()
        self.paths: List[Path] = []

    def move_to(self, x, y):
        self.path.start = np.array([x, y], dtype=np.float64)

    def line_to(self, x, y):
        self.path.push_line(LineSegment([(x, y)]))

    def quad_to(self, x1, y1, x, y):
        self.path.push_integral_quadratic_curve(
            IntegralQuadraticCurveSegment([(x1, y1), (x, y)])
        )

    def curve_to(self, x1, y1, x2, y2, x, y):
        self.path.push_integral_cubic_curve(
            IntegralCubicCurveSegment([(x1, y1), (x2, y2), (x, y)])
        )

    def close(self):
        path, self.path = self.path, Path()
        self.paths.append(path)


def paths_of_glyph(face: Face, glyph_id: int) -> List[Path]:
    """Paths of a glyph in font units (reference src/text.rs:97-104)."""
    builder = _OutlineBuilder()
    if face.outline_glyph(glyph_id, builder):
        return builder.paths
    return []


class Orientation(enum.Enum):
    """Axis and direction of text flow (reference src/text.rs:107-117)."""

    RIGHT_TO_LEFT = "right_to_left"
    LEFT_TO_RIGHT = "left_to_right"
    TOP_TO_BOTTOM = "top_to_bottom"
    BOTTOM_TO_TOP = "bottom_to_top"


class Alignment(enum.Enum):
    """Where the origin of the text is (reference src/text.rs:119-130)."""

    BEGIN = "begin"
    BASELINE = "baseline"
    CENTER = "center"
    END = "end"


@dataclass
class Layout:
    """Geometric layout of a text (reference src/text.rs:132-143)."""

    size: float
    orientation: Orientation = Orientation.LEFT_TO_RIGHT
    major_alignment: Alignment = Alignment.CENTER
    minor_alignment: Alignment = Alignment.CENTER


def _calculate_aligned_positions(face: Face, layout: Layout, text: str):
    """Kerned, aligned glyph positions per line
    (reference src/text.rs:145-230).

    Returns (extent [2], offset [2], lines: list of (line_range_end,
    [(position [2], glyph_id), ...])).  Positions are in font units.
    """
    replacement_glyph = face.glyph_index(REPLACEMENT_CHARACTER)
    orientation_map = {
        Orientation.RIGHT_TO_LEFT: (0, -1, -1),
        Orientation.LEFT_TO_RIGHT: (0, 1, -1),
        Orientation.TOP_TO_BOTTOM: (1, 1, -1),
        Orientation.BOTTOM_TO_TOP: (1, 1, 1),
    }
    major_axis, sign_x, sign_y = orientation_map[layout.orientation]
    if major_axis == 0:
        line_minor_extent = face.height()
        line_gap = face.line_gap()
    else:
        line_minor_extent = face.vertical_height() or 0
        line_gap = face.vertical_line_gap() or 0
    lines = []
    line_major_extent = 0
    extent = [0, 0]
    glyph_positions = []
    prev_glyph_id = None
    index = 0
    for char in text:
        index += 1
        position = extent.copy()
        position[major_axis] = line_major_extent
        if char == "\n":
            glyph_positions.append((position, 0))
            lines.append((index, glyph_positions))
            glyph_positions = []
            extent[major_axis] = max(extent[major_axis], line_major_extent)
            extent[1 - major_axis] += line_minor_extent + line_gap
            line_major_extent = 0
            prev_glyph_id = None
        else:
            glyph_id = face.glyph_index(char)
            if glyph_id is None:
                glyph_id = replacement_glyph or 0
            if prev_glyph_id is not None:
                kerning = face.glyphs_kerning(prev_glyph_id, glyph_id)
                if kerning is not None:
                    line_major_extent += kerning
            prev_glyph_id = glyph_id
            if major_axis == 0:
                advance = face.glyph_hor_advance(glyph_id)
            else:
                advance = face.glyph_ver_advance(glyph_id)
            if advance is not None:
                line_major_extent += advance
            glyph_positions.append((position, glyph_id))
    position = extent.copy()
    position[major_axis] = line_major_extent
    glyph_positions.append((position, 0))
    lines.append((index + 1, glyph_positions))
    extent[major_axis] = max(extent[major_axis], line_major_extent)
    extent[1 - major_axis] += line_minor_extent

    offset = [0, 0]
    if layout.minor_alignment is Alignment.BEGIN:
        offset[1 - major_axis] = -face.descender
    elif layout.minor_alignment is Alignment.BASELINE:
        offset[1 - major_axis] = 0
    elif layout.minor_alignment is Alignment.CENTER:
        offset[1 - major_axis] = (face.x_height() or 0) // 2
    else:
        offset[1 - major_axis] = -line_minor_extent
    for _line_range_end, positions in lines:
        line_extent = positions[-1][0][major_axis]
        line_offset = offset.copy()
        if layout.major_alignment is Alignment.BEGIN:
            line_offset[major_axis] = -extent[major_axis] // 2
        elif layout.major_alignment in (Alignment.BASELINE, Alignment.CENTER):
            line_offset[major_axis] = -line_extent // 2
        else:
            line_offset[major_axis] = (
                extent[major_axis] // 2 - line_extent
            )
        line_offset[1 - major_axis] -= (
            extent[1 - major_axis] - line_minor_extent
        ) // 2
        for position, _glyph_id in positions:
            position[0] = sign_x * (position[0] + line_offset[0])
            position[1] = sign_y * (position[1] + line_offset[1])
    return extent, [sign_x * offset[0], sign_y * offset[1]], lines


def paths_of_text(
    face: Face,
    layout: Layout,
    text: str,
    clipping_area: Optional[np.ndarray] = None,
) -> List[Path]:
    """Arrange a string into glyph paths (reference src/text.rs:232-263).

    Glyphs completely outside the convex `clipping_area` (homogeneous
    points, clockwise) are discarded.
    """
    _extent, _offset, lines = _calculate_aligned_positions(face, layout, text)
    scale = layout.size / face.height()
    result: List[Path] = []
    # Outline cache: a glyph's paths are parsed once and copied per
    # instance (repeated glyphs dominate real text).
    outline_cache = {}
    for _line_range_end, glyph_positions in lines:
        for (x, y), glyph_id in glyph_positions[:-1]:
            if clipping_area is not None:
                bbox = face.glyph_bounding_box(glyph_id)
                if bbox is not None:
                    aabb = [
                        (bbox[0] + x) * scale,
                        (bbox[1] + y) * scale,
                        (bbox[2] + x) * scale,
                        (bbox[3] + y) * scale,
                    ]
                    if not ga2d.do_convex_polygons_overlap(
                        ga2d.aabb_to_convex_polygon(aabb), clipping_area
                    ):
                        continue
            protos = outline_cache.get(glyph_id)
            if protos is None:
                protos = paths_of_glyph(face, glyph_id)
                outline_cache[glyph_id] = protos
            offset = (x * scale, y * scale)
            for proto in protos:
                result.append(proto.copy_affine(scale, offset))
    return result


def glyph_triangle_table(face: Face, glyph_id: int):
    """(TriangleTable, hull vertices) of one glyph in font units,
    cached on the face.

    Tessellation commutes with affine maps (the Loop-Blinn implicit
    weights are affine-invariant), so a glyph is tessellated once and
    stamped per instance by transforming only the triangle positions.
    """
    cache = getattr(face, "_glyph_table_cache", None)
    if cache is None:
        cache = {}
        face._glyph_table_cache = cache
    entry = cache.get(glyph_id)
    if entry is None:
        from . import native
        from .convex_hull import andrew
        from .fill import FillBuilder
        from .renderer import _is_glyph_style, _native_fill_batch

        proto_hull: List = []
        paths = paths_of_glyph(face, glyph_id)
        if (
            paths
            and native.available()
            and all(_is_glyph_style(p) for p in paths)
        ):
            table = _native_fill_batch(paths, proto_hull)
        else:
            builder = FillBuilder()
            for path in paths:
                builder.add_path(proto_hull, path)
            table = builder.build()
        hull = np.asarray(proto_hull, np.float64).reshape(-1, 2)
        if len(hull) >= 3:
            hull = andrew(hull)
        entry = (table, hull)
        cache[glyph_id] = entry
    return entry


def shape_of_text(
    face: Face,
    layout: Layout,
    text: str,
    clipping_area: Optional[np.ndarray] = None,
):
    """Arrange a string directly into a renderer Shape.

    The production path for large texts: where
    ``Shape(paths_of_text(...))`` re-tessellates every glyph instance
    (the reference's Shape::from_paths does the same per-instance work,
    renderer.rs:177-249), this uses the per-glyph triangle-table cache
    and stamps instances by translating pre-tessellated tables —
    a 10k-glyph page builds in well under a second.  Output coverage is
    identical up to f32 rounding of the affine transform order.
    """
    from .renderer import Shape
    from .vertex import TriangleTable

    _extent, _offset, lines = _calculate_aligned_positions(face, layout, text)
    scale = layout.size / face.height()
    by_glyph = {}
    for _line_range_end, glyph_positions in lines:
        for (x, y), glyph_id in glyph_positions[:-1]:
            if clipping_area is not None:
                bbox = face.glyph_bounding_box(glyph_id)
                if bbox is not None:
                    aabb = [
                        (bbox[0] + x) * scale,
                        (bbox[1] + y) * scale,
                        (bbox[2] + x) * scale,
                        (bbox[3] + y) * scale,
                    ]
                    if not ga2d.do_convex_polygons_overlap(
                        ga2d.aabb_to_convex_polygon(aabb), clipping_area
                    ):
                        continue
            by_glyph.setdefault(glyph_id, []).append((x, y))
    tables = []
    hull_parts = []
    for glyph_id, positions in by_glyph.items():
        table, ghull = glyph_triangle_table(face, glyph_id)
        if not len(table):
            continue
        offsets = np.asarray(positions, np.float64) * scale  # (m, 2)
        m = len(offsets)
        xy = (
            table.xy.astype(np.float64)[None] * scale
            + offsets[:, None, None, :]
        ).reshape(-1, 3, 2).astype(np.float32)
        tables.append(
            TriangleTable(
                xy=xy,
                aux=np.tile(table.aux, (m, 1, 1)),
                kind=np.tile(table.kind, m),
                meta=np.tile(table.meta, (m, 1)),
            )
        )
        if len(ghull):
            hull_parts.append(
                (ghull[None] * scale + offsets[:, None, :]).reshape(-1, 2)
            )
    return Shape.from_triangle_table(
        TriangleTable.concatenate(tables),
        np.concatenate(hull_parts) if hull_parts else np.zeros((0, 2)),
    )


def glyph_shape(face: Face, glyph_id: int):
    """Renderer Shape of one glyph in FONT UNITS, cached on the face.

    One tessellation serves every size and every instance: scale and
    pen position live in the per-instance transform (the reference
    keeps per-glyph vertex buffers and draws them instanced,
    text.rs:97-104 + renderer.rs:462-466).  Returns None for glyphs
    with no outline (spaces, empty glyphs)."""
    cache = getattr(face, "_glyph_shape_cache", None)
    if cache is None:
        cache = {}
        face._glyph_shape_cache = cache
    if glyph_id not in cache:
        from .renderer import Shape

        table, ghull = glyph_triangle_table(face, glyph_id)
        cache[glyph_id] = (
            Shape.from_triangle_table(table, ghull)
            if len(table)
            else None
        )
    return cache[glyph_id]


def _flag_overlapping_boxes(boxes: np.ndarray) -> np.ndarray:
    """Bool mask of boxes (N, 4 = x0, y0, x1, y1) that overlap at least
    one other box (closed-box test), by an x-sweep with an active list
    pruned by x1 — near-linear for laid-out text, whose ink boxes
    rarely overlap."""
    n = len(boxes)
    flagged = np.zeros(n, bool)
    order = np.argsort(boxes[:, 0], kind="stable")
    active: List[int] = []
    for idx in order:
        x0 = boxes[idx, 0]
        active = [j for j in active if boxes[j, 2] >= x0]
        for j in active:
            if not (boxes[idx, 3] < boxes[j, 1]
                    or boxes[j, 3] < boxes[idx, 1]):
                flagged[idx] = True
                flagged[j] = True
        active.append(idx)
    return flagged


def text_commands(
    face: Face,
    layout: Layout,
    text: str,
    transform: np.ndarray,
    color=(0.0, 0.0, 0.0, 1.0),
    clipping_area: Optional[np.ndarray] = None,
    clip_depth: int = 0,
    alpha_layer: int = 0,
) -> list:
    """Instanced draw commands for a string: one (STENCIL, COLOR) pair
    per unique glyph with an (N, 4, 4) per-instance transform stack —
    the reference's instanced draw over per-glyph vertex buffers
    (text.rs:97-104, renderer.rs:462-466).

    Where ``shape_of_text`` stamps every instance into one monolithic
    triangle table (10k glyphs → a 296k-triangle shape whose binning
    re-runs in full on any camera change), this form bins each unique
    glyph's triangles once per command: real text reuses ~100 unique
    glyphs across thousands of instances, so binning geometry shrinks
    by ~instances/unique.

    Pixel semantics: same-glyph instances whose projected cover boxes
    overlap on screen — or whose projection crosses the near plane —
    are split out of the instanced pair into sequential ones, so an
    instanced pair is always pixel-exact against the sequential walk.
    Instances of DIFFERENT glyphs render as separate commands in glyph
    order (first occurrence); where their covers overlap (combining
    marks, extreme kerning) the covers composite sequentially rather
    than under the monolith's joint nonzero winding — identical
    per-sample output for opaque source-over color, slightly darker
    overlap for translucent color.

    ``transform``: the (4, 4) layout→clip matrix shared by the whole
    string (pen position and ``layout.size`` scaling compose into each
    instance's transform here).
    """
    from .renderer import DrawCommand, RenderOperation

    transform = np.asarray(transform, np.float64)
    if transform.shape != (4, 4):
        raise ValueError("text_commands takes a single (4, 4) transform")
    _extent, _offset, lines = _calculate_aligned_positions(
        face, layout, text
    )
    scale = layout.size / face.height()
    by_glyph: dict = {}
    for _line_range_end, glyph_positions in lines:
        for (x, y), glyph_id in glyph_positions[:-1]:
            if clipping_area is not None:
                bbox = face.glyph_bounding_box(glyph_id)
                if bbox is not None:
                    aabb = [
                        (bbox[0] + x) * scale,
                        (bbox[1] + y) * scale,
                        (bbox[2] + x) * scale,
                        (bbox[3] + y) * scale,
                    ]
                    if not ga2d.do_convex_polygons_overlap(
                        ga2d.aabb_to_convex_polygon(aabb), clipping_area
                    ):
                        continue
            by_glyph.setdefault(glyph_id, []).append((x, y))

    w_eps = 1e-6
    commands = []
    for glyph_id, positions in by_glyph.items():
        shape = glyph_shape(face, glyph_id)
        if shape is None:
            continue
        offsets = np.asarray(positions, np.float64) * scale  # (m, 2)
        m = len(offsets)
        # Per-instance model→clip: glyph font units p ↦
        # transform · (scale·p + offset).
        stack = np.broadcast_to(transform, (m, 4, 4)).copy()
        stack[:, :, 0] = transform[:, 0] * scale
        stack[:, :, 1] = transform[:, 1] * scale
        stack[:, :, 3] = (
            transform[:, 3]
            + offsets[:, 0:1] * transform[:, 0]
            + offsets[:, 1:2] * transform[:, 1]
        )
        stack32 = np.ascontiguousarray(stack.astype(np.float32))

        # Screen cover boxes of every instance (vectorized): the
        # glyph's convex ink hull under each instance transform.
        hull = np.asarray(shape.convex_hull, np.float64)
        if len(hull):
            pts = hull[None] * scale + offsets[:, None, :]  # layout units
            hom = np.concatenate(
                [
                    pts,
                    np.zeros(pts.shape[:-1] + (1,)),
                    np.ones(pts.shape[:-1] + (1,)),
                ],
                axis=-1,
            )  # (m, h, 4)
            clip = hom @ transform.T
            w = clip[..., 3]
            ok = np.all(w > w_eps, axis=-1)
            with np.errstate(invalid="ignore", divide="ignore"):
                ndc = clip[..., :2] / w[..., None]
            ok &= np.all(np.isfinite(ndc), axis=(-2, -1))
            boxes = np.concatenate(
                [ndc.min(axis=1), ndc.max(axis=1)], axis=-1
            )
        else:
            ok = np.zeros(m, bool)
            boxes = np.zeros((m, 4))

        sequential = ~ok
        if ok.any():
            flagged = np.zeros(m, bool)
            valid_ix = np.flatnonzero(ok)
            flags = _flag_overlapping_boxes(boxes[valid_ix])
            flagged[valid_ix] = flags
            sequential |= flagged
        grouped = np.flatnonzero(~sequential)

        if len(grouped) >= 2:
            tf = stack32[grouped]
            commands.append(
                DrawCommand(
                    RenderOperation.STENCIL, shape, tf,
                    clip_depth=clip_depth, alpha_layer=alpha_layer,
                )
            )
            commands.append(
                DrawCommand(
                    RenderOperation.COLOR, shape, tf, color=color,
                    clip_depth=clip_depth, alpha_layer=alpha_layer,
                )
            )
            singles = np.flatnonzero(sequential)
        else:
            singles = np.arange(m)
        for i in singles:
            commands.append(
                DrawCommand(
                    RenderOperation.STENCIL, shape, stack32[i],
                    clip_depth=clip_depth, alpha_layer=alpha_layer,
                )
            )
            commands.append(
                DrawCommand(
                    RenderOperation.COLOR, shape, stack32[i], color=color,
                    clip_depth=clip_depth, alpha_layer=alpha_layer,
                )
            )
    return commands


def text_commands_fused(
    face: Face,
    layout: Layout,
    text: str,
    transform: np.ndarray,
    color=(0.0, 0.0, 0.0, 1.0),
    clipping_area: Optional[np.ndarray] = None,
    clip_depth: int = 0,
    alpha_layer: int = 0,
) -> list:
    """ONE instanced multi-shape STENCIL (every glyph instance in one
    draw stream over the per-glyph cached tables) + ONE whole-string
    cover: the monolith's two-command kernel walk at the instanced
    path's build cost.

    Semantics are EXACTLY the monolith's (``Shape(paths_of_text(...))``
    / ``shape_of_text``): all instances' winding accumulates in the
    shared stencil before the single cover applies the nonzero rule
    over the string's ink bounding box — the reference's one
    stencil-then-cover over the whole text shape (renderer.rs:187-209,
    267-355).  Use this for single-paint text (the common case); use
    ``text_commands`` when instances need individual covers (per-glyph
    colors, incremental redraw).

    Why it exists: per-glyph command pairs make per-(tile, command)
    entry ranges a few rows long, so the kernel walk cannot batch wide;
    one multi-shape command has monolith-length contiguous ranges and
    tessellates each unique glyph once.
    """
    from .path import Path
    from .renderer import DrawCommand, RenderOperation, Shape

    transform = np.asarray(transform, np.float64)
    if transform.shape != (4, 4):
        raise ValueError(
            "text_commands_fused takes a single (4, 4) transform"
        )
    _extent, _offset, lines = _calculate_aligned_positions(
        face, layout, text
    )
    scale = layout.size / face.height()
    shapes = []
    offsets = []
    ink_lo = np.array([np.inf, np.inf])
    ink_hi = np.array([-np.inf, -np.inf])
    for _line_range_end, glyph_positions in lines:
        for (x, y), glyph_id in glyph_positions[:-1]:
            if clipping_area is not None:
                bbox = face.glyph_bounding_box(glyph_id)
                if bbox is not None:
                    aabb = [
                        (bbox[0] + x) * scale,
                        (bbox[1] + y) * scale,
                        (bbox[2] + x) * scale,
                        (bbox[3] + y) * scale,
                    ]
                    if not ga2d.do_convex_polygons_overlap(
                        ga2d.aabb_to_convex_polygon(aabb), clipping_area
                    ):
                        continue
            shape = glyph_shape(face, glyph_id)
            if shape is None:
                continue
            shapes.append(shape)
            offsets.append((x, y))
            hull = np.asarray(shape.convex_hull, np.float64)
            if len(hull):
                pts = hull * scale + np.asarray((x, y)) * scale
                ink_lo = np.minimum(ink_lo, pts.min(axis=0))
                ink_hi = np.maximum(ink_hi, pts.max(axis=0))
    if not shapes:
        return []
    offsets = np.asarray(offsets, np.float64) * scale  # (N, 2)
    n = len(offsets)
    stack = np.broadcast_to(transform, (n, 4, 4)).copy()
    stack[:, :, 0] = transform[:, 0] * scale
    stack[:, :, 1] = transform[:, 1] * scale
    stack[:, :, 3] = (
        transform[:, 3]
        + offsets[:, 0:1] * transform[:, 0]
        + offsets[:, 1:2] * transform[:, 1]
    )
    stack32 = np.ascontiguousarray(stack.astype(np.float32))
    # The cover: the string's ink bounding box in layout units (the
    # monolith's convex hull is likewise the cover region; a box is
    # its cheap superset — cover cost is per covered tile either way).
    center = (ink_lo + ink_hi) * 0.5
    half = np.maximum((ink_hi - ink_lo) * 0.5, 1e-3)
    cover = Shape([Path.from_rect(tuple(center), tuple(half))])
    t32 = np.ascontiguousarray(transform.astype(np.float32))
    return [
        DrawCommand(
            RenderOperation.STENCIL, shapes, stack32,
            clip_depth=clip_depth, alpha_layer=alpha_layer,
        ),
        DrawCommand(
            RenderOperation.COLOR, cover, t32, color=color,
            clip_depth=clip_depth, alpha_layer=alpha_layer,
        ),
    ]


@dataclass
class TextGeometry:
    """Bounding box and per-line glyph positions for caret math
    (reference src/text.rs:265-347)."""

    major_axis: int
    half_extent: Tuple[float, float]
    lines: List[Tuple[int, List[Tuple[float, float]]]]

    @classmethod
    def new(cls, face: Face, layout: Layout, text: str) -> "TextGeometry":
        major_axis = (
            0
            if layout.orientation
            in (Orientation.RIGHT_TO_LEFT, Orientation.LEFT_TO_RIGHT)
            else 1
        )
        scale = layout.size / face.height()
        extent, offset, lines = _calculate_aligned_positions(face, layout, text)
        return cls(
            major_axis=major_axis,
            half_extent=(extent[0] * scale * 0.5, extent[1] * scale * 0.5),
            lines=[
                (
                    line_range_end,
                    [
                        (
                            (position[0] - offset[0]) * scale,
                            (position[1] - offset[1]) * scale,
                        )
                        for position, _glyph in positions
                    ],
                )
                for line_range_end, positions in lines
            ],
        )

    def line_index_from_char_index(self, char_index: int) -> int:
        for i, (line_range_end, _positions) in enumerate(self.lines):
            if line_range_end > char_index:
                return i
        raise IndexError(char_index)

    def char_index_from_position(self, cursor: Tuple[float, float]) -> int:
        minor_half_extent = self.half_extent[1 - self.major_axis]
        line_index = int(
            min(
                max(
                    (minor_half_extent - cursor[1 - self.major_axis])
                    * len(self.lines)
                    / (minor_half_extent * 2.0),
                    0.0,
                ),
                len(self.lines) - 1,
            )
        )
        positions = self.lines[line_index][1]
        found = len(positions) - 1
        for i, (prev, nxt) in enumerate(zip(positions, positions[1:])):
            if (prev[self.major_axis] + nxt[self.major_axis]) * 0.5 > cursor[
                self.major_axis
            ]:
                found = i
                break
        base = 0 if line_index == 0 else self.lines[line_index - 1][0]
        return found + base

    def advance_char_index_by_line_index(
        self, char_index: int, relative_line_index: int
    ) -> int:
        line_index = self.line_index_from_char_index(char_index)
        if relative_line_index < 0 and line_index == 0:
            return 0
        if (
            relative_line_index > 0
            and line_index == len(self.lines) - 1
        ):
            return self.lines[-1][0] - 1
        line_range_end, positions = self.lines[line_index]
        cursor = list(
            positions[char_index + len(positions) - line_range_end]
        )
        line_minor_extent = (
            self.half_extent[1 - self.major_axis] * 2.0 / len(self.lines)
        )
        cursor[1 - self.major_axis] -= line_minor_extent * relative_line_index
        return self.char_index_from_position(tuple(cursor))


def byte_offset_of_char_index(string: str, char_index: int) -> int:
    """Byte offset of a char index in the UTF-8 encoding
    (reference src/text.rs:349-352)."""
    return len(string[:char_index].encode("utf-8"))
