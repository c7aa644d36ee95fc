"""The rendering interface: Configuration, Shape, Renderer.

The JAX replacement for the reference's wgpu runtime
(src/renderer.rs).  A frame is a sequence of draw commands — the same
operations as the reference's `RenderOperation`
(renderer.rs:143-160): Stencil, Clip, UnClip, Color, SaveAlphaContext,
ScaleAlphaContext, RestoreAlphaContext.

Execution is staged for the reference's update economics
(renderer.rs:63-117, 360-376 update buffers in place; we cache instead):

1. *Scene packing* (host, cached): the shapes' triangle tables and
   hulls are padded, stacked and uploaded once per shape set.
2. *prepare* (XLA, cached by transforms): per-command triangle setup
   and tile binning — reruns only when instance transforms change.
3. *rasterize* (Pallas through Triton, every frame): one kernel walks
   the command list per tile with winding/clip/color/alpha state held
   in registers (see ops/coverage.py).  Per-frame host traffic is only
   the small command-color / clip-depth / dash-descriptor tables, so
   dash-phase animation streams a few hundred bytes like the
   reference's partial buffer write.
"""

from __future__ import annotations

import enum
import hashlib
import logging
import math
import threading
import time
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

logger = logging.getLogger("contrast_renderer")

import jax
import jax.numpy as jnp
import numpy as np

from . import dynamic_stroke as ds
from . import native
from .convex_hull import andrew, outer_polygon
from .error import (
    ClipStackOverflow,
    DynamicStrokeOptionsIndexOutOfBounds,
    NumberOfStencilBitsIsUnsupported,
    TooManyNestedOpacityGroups,
    require_finite,
)
from .fill import FillBuilder
from .ops import coverage
from .path import DynamicStrokeOptions, Path, SegmentType
from .stroke import StrokeBuilder
from .vertex import (
    KIND_INTEGRAL_QUADRATIC, KIND_SOLID, KIND_STROKE_LINE, TriangleTable,
)


class RenderOperation(enum.IntEnum):
    """What a draw command does (reference renderer.rs:143-160)."""

    STENCIL = 0
    CLIP = 1
    UNCLIP = 2
    COLOR = 3
    SAVE_ALPHA_CONTEXT = 4
    SCALE_ALPHA_CONTEXT = 5
    RESTORE_ALPHA_CONTEXT = 6


#: Blend factors for :class:`BlendComponent` — the full wgpu::BlendFactor
#: set (reference Configuration.blending is an arbitrary wgpu BlendState,
#: renderer.rs:381).  ``constant`` / ``one_minus_constant`` read the
#: runtime blend-constant color (``Renderer.set_blend_constant``, wgpu's
#: set_blend_constant); ``src_alpha_saturated`` is min(αs, 1−αd) on RGB
#: and 1 on alpha.  wgpu's Src1* dual-source factors don't exist here:
#: there is no second color output to source from.
BLEND_FACTORS = (
    "zero",
    "one",
    "src_alpha",
    "one_minus_src_alpha",
    "dst_alpha",
    "one_minus_dst_alpha",
    "src_alpha_saturated",
    "constant",
    "one_minus_constant",
)
#: wgpu::CompareFunction names accepted by Configuration.depth_compare
#: (reference renderer.rs:387-390).
DEPTH_COMPARE_FUNCTIONS = (
    "never",
    "less",
    "equal",
    "less_equal",
    "greater",
    "not_equal",
    "greater_equal",
    "always",
)
#: Blend operations (wgpu::BlendOperation).  Per wgpu/WebGPU semantics
#: `min`/`max` ignore the blend factors.
BLEND_OPERATIONS = ("add", "subtract", "reverse_subtract", "min", "max")


@dataclass(frozen=True)
class BlendComponent:
    """src/dst factor + operation for one channel group
    (wgpu::BlendComponent): ``out = op(src·src_factor, dst·dst_factor)``
    on premultiplied values."""

    src_factor: str = "one"
    operation: str = "add"
    dst_factor: str = "one_minus_src_alpha"

    def __post_init__(self):
        if self.src_factor not in BLEND_FACTORS:
            raise ValueError(f"unknown blend factor {self.src_factor!r}")
        if self.dst_factor not in BLEND_FACTORS:
            raise ValueError(f"unknown blend factor {self.dst_factor!r}")
        if self.operation not in BLEND_OPERATIONS:
            raise ValueError(f"unknown blend operation {self.operation!r}")


@dataclass(frozen=True)
class BlendState:
    """A full wgpu-style blend state: independent color and alpha
    components (reference Configuration.blending, renderer.rs:381).

    Pass as ``Configuration(blending=BlendState(...))``; the named
    string modes remain available as shorthands for the three states
    the reference's examples use."""

    color: BlendComponent = BlendComponent()
    alpha: BlendComponent = BlendComponent()

    def canonical(self):
        """Hashable static encoding consumed by the kernel builder."""
        c, a = self.color, self.alpha
        return (
            (c.src_factor, c.operation, c.dst_factor),
            (a.src_factor, a.operation, a.dst_factor),
        )


#: Gradient stop budget per paint (compiled into the kernel's unrolled
#: piecewise interpolation; richer ramps compose from multiple covers).
MAX_GRADIENT_STOPS = 4


def _normalize_stops(color0, color1, stops):
    """(offsets (4,), colors (4, 4)) from either the 2-color shorthand
    or an explicit ``stops`` sequence of (offset, rgba)."""
    if stops is None:
        stops = ((0.0, color0), (1.0, color1))
    if not 2 <= len(stops) <= MAX_GRADIENT_STOPS:
        raise ValueError(
            f"gradients take 2..{MAX_GRADIENT_STOPS} stops, got {len(stops)}"
        )
    offsets = np.asarray([s[0] for s in stops], np.float32)
    if np.any(np.diff(offsets) < 0.0):
        raise ValueError("gradient stop offsets must be non-decreasing")
    if offsets[0] < 0.0 or offsets[-1] > 1.0:
        # The kernel clamps t to [0, 1]; stops outside it are
        # unreachable or degenerate — reject at construction.
        raise ValueError("gradient stop offsets must lie in [0, 1]")
    colors = np.asarray([s[1] for s in stops], np.float32)
    if colors.shape != (len(stops), 4):
        raise ValueError("gradient stop colors must be RGBA")
    pad = MAX_GRADIENT_STOPS - len(stops)
    offsets = np.concatenate([offsets, np.repeat(offsets[-1:], pad)])
    colors = np.concatenate([colors, np.repeat(colors[-1:], pad, axis=0)])
    return offsets, colors


@dataclass(frozen=True)
class LinearGradient:
    """Linear gradient paint for COLOR covers (an extension:
    the reference's color cover is solid-only, shaders.wgsl:304-309;
    custom paints there require user pipelines).

    ``start``/``end`` are model-space points (projected with the draw's
    transform, so the gradient tracks instancing and camera motion);
    the paint ramps from ``color0`` at/before ``start`` to ``color1``
    at/after ``end``, interpolated per MSAA sample and then
    premultiplied.  ``stops`` (a sequence of up to
    ``MAX_GRADIENT_STOPS`` ``(offset, rgba)`` pairs along the axis,
    offsets non-decreasing in [0, 1]) replaces the 2-color shorthand
    for multi-stop ramps.  Pass as
    ``DrawCommand(color=LinearGradient(...))``."""

    start: Tuple[float, float]
    end: Tuple[float, float]
    color0: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    color1: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    stops: object = None
    kind = 1

    def __post_init__(self):
        self.stop_table()  # validate stop count/order at construction

    def points(self):
        return np.asarray([self.start, self.end], np.float32)

    def stop_table(self):
        return _normalize_stops(self.color0, self.color1, self.stops)


@dataclass(frozen=True)
class RadialGradient:
    """Radial gradient paint: ``color0`` at ``center`` ramping to
    ``color1`` at/beyond the rim point ``edge`` (model space — the rim
    point, rather than a scalar radius, projects correctly under the
    draw transform).  ``stops`` as in :class:`LinearGradient`, offsets
    measured center→rim."""

    center: Tuple[float, float]
    edge: Tuple[float, float]
    color0: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    color1: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    stops: object = None
    kind = 2

    def __post_init__(self):
        self.stop_table()  # validate stop count/order at construction

    def points(self):
        return np.asarray([self.center, self.edge], np.float32)

    def stop_table(self):
        return _normalize_stops(self.color0, self.color1, self.stops)


class UserPaint:
    """User-defined paint: a JAX-traceable function compiled into the
    color cover's composite — the reference's "Customizable (User
    Defined) Shaders" feature line (README.md:28-33), where a user
    builds custom wgpu fragment pipelines against the library's stencil
    setup (the crate re-exports wgpu, lib.rs:4-7).  Here the custom
    stage is a function of screen position traced into the same fused
    kernel the built-in paints use, so it pays no extra pass.

    ``fn(px, py, anchor) -> (r, g, b, a)``:

    - ``px``/``py``: float32 sample-position arrays (MSAA samples ×
      tile pixels); elementwise jax.numpy only (no data-dependent
      Python control flow — the function is traced once per compiled
      frame program).
    - ``anchor``: four scalars (x0, y0, x1, y1) — the two model-space
      ``points`` projected through the draw's transform per instance,
      exactly like gradient endpoints, giving the function a model
      frame that tracks instancing and camera motion.
    - returns straight (non-premultiplied) RGBA components
      broadcastable against ``px``; the kernel premultiplies by the
      returned alpha and feeds the active blend state, like the
      built-in gradients.

    Two UserPaints sharing the same ``fn`` object share compiled code
    (the anchor stays per-draw data); distinct functions compile their
    own branch.  Pass as ``DrawCommand(color=UserPaint(...))``.
    """

    kind = USER_PAINT_KIND = 3

    def __init__(self, fn, points=((0.0, 0.0), (1.0, 0.0))):
        self.fn = fn
        self._points = np.asarray(points, np.float32)
        if self._points.shape != (2, 2):
            raise ValueError("UserPaint points must be two (x, y) pairs")

    def points(self):
        return self._points


def _paint_kind(color) -> int:
    return getattr(color, "kind", 0)


def _spec_paint(color):
    """FrameSpec.paints entry for a command color: the builtin kind
    int, or the UserPaint object itself (its ``fn`` identity is part
    of the compiled program)."""
    kind = _paint_kind(color)
    return color if kind >= UserPaint.kind else kind


#: The named shorthands as BlendStates.
NAMED_BLEND_STATES = {
    "back_to_front": BlendState(
        BlendComponent("one", "add", "one_minus_src_alpha"),
        BlendComponent("one", "add", "one_minus_src_alpha"),
    ),
    "front_to_back": BlendState(
        BlendComponent("one_minus_dst_alpha", "add", "one"),
        BlendComponent("one_minus_dst_alpha", "add", "one"),
    ),
    "additive": BlendState(
        BlendComponent("one", "add", "one"),
        BlendComponent("one", "add", "one"),
    ),
}


@dataclass
class Configuration:
    """Configurable renderer parameters (reference renderer.rs:379-405).

    `msaa_sample_count` ∈ {1, 2, 4, 8, 16} (standard sample patterns);
    up to 2**clip_nesting_counter_bits nested clip shapes; the winding
    rule is nonzero modulo 2**winding_counter_bits (1 bit = even-odd);
    up to `alpha_layer_count` nested transparency groups.

    Reference fields that do not exist here, and why:

    - ``cull_mode`` (renderer.rs:385): back-face culling is a GPU
      rasterizer knob; the coverage kernel accumulates signed winding
      from both orientations, which is the same arithmetic the
      stencil front/back increment/decrement pair implements.
    - ``depth_stencil_format`` (renderer.rs:386): the per-sample depth
      state is always f32; there is no texture format to choose.
    - ``color_attachment_in_stencil_pass`` (renderer.rs:396-398): a
      wgpu workaround for backends that require a color attachment;
      stencil commands here are pure array updates.

    ``depth_compare`` / ``depth_write_enabled`` (renderer.rs:387-392)
    DO exist: as in the reference, only the color cover tests/writes
    depth (every other reference pipeline is Always/no-write,
    renderer.rs:601-841).  Fragment depth is the draw transform's NDC z
    evaluated per sample; the buffer clears to 1.0 each frame (the
    showcase render pass's LoadOp::Clear(1.0)).  The default
    ("always", False) compiles the depth machinery out — note the
    reference showcase itself runs LessEqual + write
    (examples/showcase/main.rs:46-49), under which its later-drawn
    far-plane grid instances are occluded by the near center instance's
    ink, unlike plain command-order compositing.
    """

    msaa_sample_count: int = 4
    clip_nesting_counter_bits: int = 4
    winding_counter_bits: int = 4
    alpha_layer_count: int = 0
    #: "back_to_front": premultiplied-alpha OVER (the showcase's blend
    #: state, examples/showcase/main.rs:30-45); "front_to_back":
    #: src·(1-dstAlpha) accumulation — required by the opacity-group
    #: machinery, whose save/scale/restore algebra (renderer.rs:756-861)
    #: treats frame alpha as accumulated occlusion; "additive":
    #: src ONE + dst ONE (the reference's blending is a user-configured
    #: wgpu blend state, renderer.rs:381 — these are the three states
    #: its users employ).  Any other (src, op, dst) combination is
    #: expressed by passing a :class:`BlendState` instead of a name.
    blending: object = "back_to_front"
    #: wgpu CompareFunction for the color cover's depth test
    #: (renderer.rs:387-390).  One of "never" / "less" / "equal" /
    #: "less_equal" / "greater" / "not_equal" / "greater_equal" /
    #: "always".
    depth_compare: str = "always"
    #: Whether the color cover writes fragment depth back
    #: (renderer.rs:389-390).
    depth_write_enabled: bool = False

    def __post_init__(self):
        if isinstance(self.blending, str):
            if self.blending not in NAMED_BLEND_STATES:
                raise ValueError(f"unknown blending {self.blending!r}")
        elif not isinstance(self.blending, BlendState):
            raise ValueError(
                "blending must be a named mode or a BlendState, got "
                f"{self.blending!r}"
            )
        if (
            self.winding_counter_bits == 0
            or self.clip_nesting_counter_bits + self.winding_counter_bits > 8
        ):
            raise NumberOfStencilBitsIsUnsupported(
                f"clip={self.clip_nesting_counter_bits} winding={self.winding_counter_bits}"
            )
        if self.msaa_sample_count not in coverage.SAMPLE_PATTERNS:
            raise ValueError(
                "msaa_sample_count must be one of "
                f"{sorted(coverage.SAMPLE_PATTERNS)}"
            )
        if self.depth_compare not in DEPTH_COMPARE_FUNCTIONS:
            raise ValueError(
                f"depth_compare must be one of {DEPTH_COMPARE_FUNCTIONS}, "
                f"got {self.depth_compare!r}"
            )


_GLYPH_SEGMENTS = (SegmentType.LINE, SegmentType.INTEGRAL_QUADRATIC_CURVE)
#: Minimum glyph-style path count before the native batch tessellator
#: takes over from the per-path Python builder.
_NATIVE_FILL_THRESHOLD = 8


def _is_glyph_style(path: Path) -> bool:
    return all(st in _GLYPH_SEGMENTS for st in path.segment_types)


def _native_fill_batch(paths, proto_hull):
    """Tessellate glyph-style paths (lines + integral quadratics — all
    TTF outlines) with the native C++ kernel in one batched call; the
    output is bit-equivalent to FillBuilder's (tests/test_native.py)."""
    offsets = [0]
    starts, kinds, points = [], [], []
    for p in paths:
        starts.append(p.start)
        for segment_type, segment in p.iter_segments():
            cps = segment.control_points
            if segment_type is SegmentType.LINE:
                kinds.append(0)
                points.append([cps[0][0], cps[0][1], 0.0, 0.0])
            else:
                kinds.append(1)
                points.append([cps[0][0], cps[0][1], cps[1][0], cps[1][1]])
        offsets.append(len(kinds))
    solid_xy, curve_xy, curve_aux, hull_pts = native.tessellate_quadratic_paths(
        np.asarray(offsets, np.int64),
        np.asarray(starts, np.float64),
        np.asarray(kinds, np.uint8),
        np.asarray(points, np.float64),
    )
    proto_hull.extend(hull_pts)
    n_solid, n_curve = len(solid_xy), len(curve_xy)
    aux = np.zeros((n_solid + n_curve, 3, 4), np.float32)
    aux[n_solid:, :, :3] = curve_aux
    return TriangleTable(
        xy=np.concatenate([solid_xy, curve_xy]).astype(np.float32),
        aux=aux,
        kind=np.concatenate(
            [
                np.full(n_solid, KIND_SOLID, np.int32),
                np.full(n_curve, KIND_INTEGRAL_QUADRATIC, np.int32),
            ]
        ),
        meta=np.zeros((n_solid + n_curve, 2), np.float32),
    )


class Shape:
    """A set of paths always rendered together
    (reference Shape, renderer.rs:163-249).

    Tessellates stroked and filled paths into one triangle table (stroke
    triangles first, preserving the reference's draw order,
    renderer.rs:275-336) plus the convex hull used by the cover
    operations.  Large batches of glyph-style fills (lines + integral
    quadratics) go through the native C++ tessellator when available.
    """

    _uid_counter = iter(range(1, 1 << 62))

    def __init__(
        self,
        paths: Sequence[Path],
        dynamic_stroke_options: Sequence[DynamicStrokeOptions] = (),
        use_native: bool = True,
    ):
        # Unique, never-recycled identity: id() can be reused after GC,
        # which would alias a new Shape onto a stale scene-cache entry.
        self._uid = next(Shape._uid_counter)
        self._geometry_version = -1
        self.update_paths(paths, dynamic_stroke_options, use_native)

    def update_paths(
        self,
        paths: Sequence[Path],
        dynamic_stroke_options: Sequence[DynamicStrokeOptions] = (),
        use_native: bool = True,
    ):
        """Re-tessellate this Shape in place (the reference's Shape
        recycling, renderer.rs:216-227): renderers notice via the
        geometry version and re-upload only this shape's tables."""
        proto_hull: List = []
        stroke_builder = StrokeBuilder()
        fill_builder = FillBuilder()
        fill_paths = [p for p in paths if p.stroke_options is None]
        native_fills = ()
        if (
            use_native
            and len(fill_paths) >= _NATIVE_FILL_THRESHOLD
            and native.available()
            and all(_is_glyph_style(p) for p in fill_paths)
        ):
            native_fills = fill_paths
        for path in paths:
            if path.stroke_options is not None:
                if path.stroke_options.dynamic_stroke_options_group >= len(
                    dynamic_stroke_options
                ):
                    raise DynamicStrokeOptionsIndexOutOfBounds(
                        f"group {path.stroke_options.dynamic_stroke_options_group}"
                    )
                stroke_builder.add_path(proto_hull, path)
            elif not native_fills:
                fill_builder.add_path(proto_hull, path)
        tables = [stroke_builder.build()]
        if native_fills:
            tables.append(_native_fill_batch(native_fills, proto_hull))
        tables.append(fill_builder.build())
        self.triangles = TriangleTable.concatenate(tables)
        # SafeFloat-equivalent boundary validation (safe_float.rs:44-52):
        # non-finite path coordinates must fail loudly here instead of
        # flowing silently into binning.
        require_finite(self.triangles.xy, "path coordinates")
        require_finite(self.triangles.aux, "curve weights")
        # Cover region: the convex hull, decimated to a bounded-size
        # outer polygon (cover cost per boundary tile is linear in hull
        # edge count; a superset region renders identically).
        self.convex_hull = outer_polygon(
            andrew(
                np.asarray(proto_hull).reshape(-1, 2)
                if proto_hull
                else np.zeros((0, 2))
            )
        )
        self.dynamic_stroke_options = list(dynamic_stroke_options)
        self.descriptors = ds.StrokeDescriptorTable.from_options(
            self.dynamic_stroke_options
        )
        self._geometry_version += 1

    @classmethod
    def from_triangle_table(
        cls,
        triangles: TriangleTable,
        hull_points: np.ndarray,
        dynamic_stroke_options: Sequence[DynamicStrokeOptions] = (),
    ) -> "Shape":
        """Construct a Shape from pre-tessellated geometry.

        The fast path for instanced/cached tessellation (e.g.
        text.shape_of_text's per-glyph triangle-table cache): affine
        transforms commute with Loop-Blinn tessellation — the implicit
        weights are affine-invariant — so a glyph tessellated once can
        be stamped per instance by transforming only ``xy``
        (the reference's analogue is reusing vertex buffers across
        instanced draws, renderer.rs:216-227, 462-466)."""
        shape = cls.__new__(cls)
        shape._uid = next(cls._uid_counter)
        shape._geometry_version = 0
        shape.triangles = triangles
        require_finite(triangles.xy, "triangle coordinates")
        require_finite(triangles.aux, "curve weights")
        pts = np.asarray(hull_points, np.float64).reshape(-1, 2)
        shape.convex_hull = outer_polygon(
            andrew(pts if len(pts) else np.zeros((0, 2)))
        )
        shape.dynamic_stroke_options = list(dynamic_stroke_options)
        shape.descriptors = ds.StrokeDescriptorTable.from_options(
            shape.dynamic_stroke_options
        )
        return shape

    def set_dynamic_stroke_options(
        self, index: int, options: DynamicStrokeOptions
    ):
        """Update one descriptor group (dash pattern / phase animation)
        without re-tessellating (reference renderer.rs:360-376)."""
        if index >= len(self.dynamic_stroke_options):
            raise DynamicStrokeOptionsIndexOutOfBounds(str(index))
        self.dynamic_stroke_options[index] = options
        self.descriptors = ds.StrokeDescriptorTable.from_options(
            self.dynamic_stroke_options
        )


@dataclass
class DrawCommand:
    """One step of a frame (the reference's Shape::render call with a
    RenderOperation and an instance range, renderer.rs:267-355).

    ``transform`` may be a single (4, 4) matrix or an (N, 4, 4) stack —
    the reference's instanced draw with instance-rate transform/color
    attributes (renderer.rs:462-466): a stencil command accumulates
    winding from all N instances' triangles before any cover runs; a
    cover command replays its N per-instance hull covers in instance
    order.  ``color`` is then (4,) (shared) or (N, 4) (per instance).
    """

    operation: RenderOperation
    #: One Shape shared by all instances, or a SEQUENCE of Shapes (one
    #: per instance): a single draw stream over many vertex buffers —
    #: the reference's per-glyph buffers under one instanced pipeline
    #: (renderer.rs:462-466 + text.rs:97-104).  A multi-shape STENCIL
    #: command walks as one kernel unit with contiguous per-tile entry
    #: ranges (monolith-speed batching with per-shape geometry reuse);
    #: a multi-shape cover replays per-instance hulls like any
    #: instanced cover.
    shape: object
    transform: np.ndarray  # (4, 4) or (N, 4, 4) row-major model→clip
    color: object = (0.0, 0.0, 0.0, 1.0)  # (4,) or (N, 4)
    clip_depth: int = 0  # reference set_clip_depth (renderer.rs:931-938)
    alpha_layer: int = 0

    @property
    def n_instances(self) -> int:
        t = np.asarray(self.transform)
        return 1 if t.ndim == 2 else int(t.shape[0])

    @property
    def shapes(self):
        """The command's shapes as a list (len 1 or n_instances)."""
        return (
            list(self.shape)
            if isinstance(self.shape, (list, tuple))
            else [self.shape]
        )


def _optimize_commands(commands):
    """Fuse each SaveAlphaContext + ScaleAlphaContext pair over the
    identical cover into one kernel pass (coverage.OP_SAVE_SCALE).

    The opacity-group prologue is always this adjacent pair on one
    full-group cover (reference renderer.rs:767-828 issues them
    back-to-back on the same shape); the fused op snapshots frame alpha
    and rewrites it in a single per-sample read-modify-write, halving
    the prologue's per-sample work and removing one command-walk step per
    covered tile.

    Returns ``(optimized, keep_rows)`` where ``keep_rows`` indexes the
    surviving (command, instance) transform rows within the *original*
    draw-row layout (identity when nothing fused) — callers that accept
    caller-built transform stacks gather through it.
    """
    out, keep = [], []
    row = 0
    i = 0
    while i < len(commands):
        c = commands[i]
        if (
            i + 1 < len(commands)
            and c.operation == RenderOperation.SAVE_ALPHA_CONTEXT
            and commands[i + 1].operation
            == RenderOperation.SCALE_ALPHA_CONTEXT
        ):
            s = commands[i + 1]
            if (
                c.shape is s.shape
                and c.clip_depth == s.clip_depth
                and c.alpha_layer == s.alpha_layer
                # Single-instance only: with N overlapping instance
                # covers, the unfused sequence snapshots ALL pre-scale
                # alpha before any scaling, but the fused op would
                # interleave save/scale per instance.
                and c.n_instances == 1
                and s.n_instances == 1
                and np.array_equal(
                    np.asarray(c.transform, np.float32),
                    np.asarray(s.transform, np.float32),
                )
            ):
                out.append(replace(s, operation=coverage.OP_SAVE_SCALE))
                keep.extend(
                    range(row + c.n_instances,
                          row + c.n_instances + s.n_instances)
                )
                row += c.n_instances + s.n_instances
                i += 2
                continue
        out.append(c)
        keep.extend(range(row, row + c.n_instances))
        row += c.n_instances
        i += 1
    keep_rows = (
        None if len(keep) == row else np.asarray(keep, np.int32)
    )
    return out, keep_rows


#: Minimum clip-space w for every hull point before a cover's screen
#: box is considered well-defined (near-plane crossers never fuse).
_FUSE_W_EPS = 1e-6


def _cover_box(shape: "Shape", transform) -> Optional[Tuple[float, ...]]:
    """Screen-space AABB of a command's cover region (the decimated
    outer hull polygon projected by the command transform), or None
    when the projection is not well-defined (near-plane crossing /
    non-finite).  Triangular geometry and the per-sample cover mask are
    both contained in the hull polygon, so containment survives the
    projective map while every w stays positive."""
    hull = shape.convex_hull
    if len(hull) == 0:
        return None
    t = np.asarray(transform, np.float64)
    if t.ndim != 2:
        return None
    ones = np.ones((len(hull), 1))
    clip = np.concatenate(
        [hull, np.zeros((len(hull), 1)), ones], axis=1
    ) @ t.T
    w = clip[:, 3]
    if not np.all(w > _FUSE_W_EPS):
        return None
    ndc = clip[:, :2] / w[:, None]
    if not np.all(np.isfinite(ndc)):
        return None
    return (
        float(ndc[:, 0].min()), float(ndc[:, 1].min()),
        float(ndc[:, 0].max()), float(ndc[:, 1].max()),
    )


def _boxes_disjoint(a, b) -> bool:
    # Closed-box test: touching boxes count as overlapping (a shared
    # boundary could in principle carry the same sample point).
    return (
        a[2] < b[0] or b[2] < a[0] or a[3] < b[1] or b[3] < a[1]
    )


def _solid_rgba(color) -> Optional[Tuple[float, ...]]:
    if _paint_kind(color):
        return None
    arr = np.asarray(color, np.float32).reshape(-1)
    return tuple(float(x) for x in arr) if arr.shape == (4,) else None


def _fusable_pair(commands, i, check_transforms=True):
    """The (STENCIL, COLOR) pair at positions ``i``, ``i+1`` if the two
    commands form a single-instance stencil-then-cover of the same
    shape under the same clip/alpha state, else None.

    ``check_transforms=False`` defers the stencil==cover transform
    equality to the caller — FrameProgram detects runs structurally at
    build time and validates the actual transform rows per call (its
    transforms are runtime inputs)."""
    if i + 1 >= len(commands):
        return None
    c, s = commands[i], commands[i + 1]
    if (
        c.operation == RenderOperation.STENCIL
        and s.operation == RenderOperation.COLOR
        and c.shape is s.shape
        and c.n_instances == 1
        and s.n_instances == 1
        and c.clip_depth == s.clip_depth
        and c.alpha_layer == s.alpha_layer
        and (
            not check_transforms
            or np.array_equal(
                np.asarray(c.transform, np.float32),
                np.asarray(s.transform, np.float32),
            )
        )
    ):
        return (c, s)
    return None


def _collect_fusable_run(commands, i, check_transforms=True):
    """Collect the maximal run of fusable (STENCIL, COLOR) pairs
    starting at ``i`` that share shape identity, clip depth, alpha
    layer, and compatible colors (all solid, or all the identical
    Paint object).  Returns ``(run, next_i)`` where ``run`` is a list
    of (stencil, color) tuples ([] when no pair starts at ``i``) and
    ``next_i`` is the index of the first command after the run."""
    first = _fusable_pair(commands, i, check_transforms)
    if first is None:
        return [], i
    key_shape = first[0].shape
    key_clip = first[0].clip_depth
    key_layer = first[0].alpha_layer
    first_solid = _solid_rgba(first[1].color)
    run = []
    while True:
        pair = _fusable_pair(commands, i, check_transforms)
        if pair is None or pair[0].shape is not key_shape:
            break
        if (
            pair[0].clip_depth != key_clip
            or pair[0].alpha_layer != key_layer
        ):
            break
        solid = _solid_rgba(pair[1].color)
        if (first_solid is None) != (solid is None):
            break
        if solid is None and pair[1].color is not first[1].color:
            break
        run.append(pair)
        i += 2
    return run, i


def _fuse_instance_runs(commands):
    """Auto-instancing: collapse consecutive single-instance
    (Stencil, Color) pairs over the same shape/clip/alpha state into
    instanced draws — the reference's ``instance_range 0..n`` draw
    (renderer.rs:267, 462-466) — wherever that is pixel-exact.

    The per-instance loop and the instanced draw differ only where
    instance covers interact: the instanced stencil accumulates ALL
    instances' winding before any cover runs, so a cover that overlaps
    a later instance's geometry would paint (and reset) winding that
    the sequential loop had not yet stamped.  Pairs therefore fuse
    under a greedy disjointness rule: walking the run in order, a pair
    joins the current group iff its projected cover box is disjoint
    from every box already in the group; otherwise it starts a new
    group.  Groups emit in walk order, covers replay in instance
    order, and all cross-group/cross-command interactions (blending,
    clip, depth, bulk winding) happen exactly where the sequential
    walk had them — the grouping changes per-tile walk length, not
    pixels.  Pairs whose projection is not well-defined (near-plane
    crossing) never fuse.

    Per-instance solid colors stack into the command's (N, 4) color;
    gradient paints fuse only when every pair shares the identical
    Paint object (its model-space endpoints broadcast per instance).

    Applied by ``Renderer.render`` per call with the current
    transforms, so the decision is always sound for the frame being
    rendered.  ``FrameProgram`` fuses through the same structural
    detection but re-validates disjointness at every call with the
    runtime transform stack, falling back to the sequential program
    when camera motion brings covers into contact (see
    FrameProgram._fused_rows_if_valid).
    """
    n = len(commands)
    out = []
    i = 0
    fused_any = False
    while i < n:
        run, next_i = _collect_fusable_run(commands, i)
        if not run:
            out.append(commands[i])
            i += 1
            continue
        i = next_i
        if len(run) < 2:
            out.extend(run[0])
            continue
        # Greedy disjoint grouping in walk order.
        boxes = [_cover_box(p[0].shape, p[0].transform) for p in run]
        groups = []
        current = []
        current_boxes = []
        for pair, box in zip(run, boxes):
            if box is not None and all(
                _boxes_disjoint(box, b) for b in current_boxes
            ):
                current.append(pair)
                current_boxes.append(box)
            else:
                if current:
                    groups.append(current)
                current = [pair]
                # A boxless (near-plane) pair may never accept
                # neighbours: poison its group with an everything-box.
                current_boxes = [
                    box if box is not None
                    else (-np.inf, -np.inf, np.inf, np.inf)
                ]
        if current:
            groups.append(current)
        for group in groups:
            if len(group) == 1:
                out.extend(group[0])
                continue
            fused_any = True
            transforms = np.ascontiguousarray(
                np.stack([
                    np.asarray(p[0].transform, np.float32)
                    for p in group
                ])
            )
            if _paint_kind(group[0][1].color):
                color = group[0][1].color
            else:
                color = np.ascontiguousarray(
                    np.stack([
                        np.asarray(p[1].color, np.float32).reshape(4)
                        for p in group
                    ])
                )
            out.append(replace(group[0][0], transform=transforms))
            out.append(
                replace(group[0][1], transform=transforms, color=color)
            )
    return out, fused_any


class _FusionRun:
    """One structural run of fusable (STENCIL, COLOR) pairs inside a
    FrameProgram's optimized command list (see _structural_runs)."""

    __slots__ = (
        "start", "pairs", "shape", "stencil_rows", "cover_rows", "escape",
    )


def _structural_runs(commands):
    """Maximal fusable runs of >= 2 pairs in the optimized command
    list (transform values excluded from the structural test — a
    FrameProgram's transforms are runtime inputs).  Returns a list of
    _FusionRun with opt-layout row indices per pair."""
    rows_before = np.cumsum([0] + [c.n_instances for c in commands])
    runs = []
    i = 0
    n = len(commands)
    while i < n:
        run, next_i = _collect_fusable_run(
            commands, i, check_transforms=False
        )
        if len(run) < 2:
            i = next_i if run else i + 1
            continue
        r = _FusionRun()
        r.start = i
        r.pairs = run
        r.shape = run[0][0].shape
        r.stencil_rows = rows_before[np.arange(i, next_i, 2)].astype(
            np.int64
        )
        r.cover_rows = r.stencil_rows + 1
        r.escape = _run_overlap_escape(run)
        runs.append(r)
        i = next_i
    return runs


#: Near-plane eps of the HOST cover model.  Must be ≤ BOTH kernel
#: epsilons — the cover hull clip (coverage.py make_prepare,
#: ``eps = 1e-5``) and the stencil triangle clip (``w_eps = 1e-6``) —
#: so the host polygon is a SUPERSET of everything instance i can
#: touch on screen: its cover region (clipped at 1e-5 ⊆ the 1e-6
#: region) and its stencil winding (triangles ⊆ hull in clip space,
#: both clipped at 1e-6, containment survives projection).  Fusion
#: soundness needs winding containment, not just cover containment:
#: covers zero winding only inside their own hull, so an instance
#: whose near-eps sliver winding escaped a smaller host polygon could
#: light up a groupmate's cover where the sequential walk paints
#: nothing.  Disjointness of supersets implies disjointness of the
#: real regions; near-eps projections blow up to huge coordinates and
#: simply refuse to fuse — conservative, never wrong.
_NEAR_CLIP_EPS = 1e-6


def _clip_poly_near(hclip):
    """Sutherland–Hodgman clip of one homogeneous polygon (h, 4)
    against ``w > _NEAR_CLIP_EPS``, projected to NDC — the containing
    model of the kernel's cover and stencil clips (see _NEAR_CLIP_EPS).
    Returns (k, 2) with k possibly < 3 (empty cover)."""
    eps = _NEAR_CLIP_EPS
    out = []
    h = len(hclip)
    for i in range(h):
        a, b = hclip[i], hclip[(i + 1) % h]
        wa, wb = a[3], b[3]
        if wa > eps:
            out.append(a)
        if (wa > eps) != (wb > eps):
            t = (eps - wa) / (wb - wa)
            out.append(a + t * (b - a))
    if len(out) < 3:
        return np.zeros((0, 2))
    out = np.asarray(out)
    return out[:, :2] / out[:, 3:4]


def _run_boxes(shape: "Shape", transforms):
    """Projected covers of one shape under a stack of transforms:
    ``(boxes (m, 4) NDC min/max, ok (m,) bool, polys (m, h+1, 2))`` —
    ok is False only where the transform itself is non-finite.
    ``polys`` are the projected hull polygons clipped against the near
    plane at _NEAR_CLIP_EPS — a convex SUPERSET of both the cover
    region the kernel rasterizes and the stencil winding it deposits
    (the boxes are the polygons' conservative AABBs).  A hull fully
    behind w = eps touches nothing on screen: its box is the empty
    interval (+inf mins, −inf maxes, disjoint from everything) and its
    polygon degenerates to a point (orientation sign 0, so escape
    groups conservatively reject it)."""
    hull = np.asarray(shape.convex_hull, np.float64)
    m = len(transforms)
    if len(hull) == 0:
        return np.zeros((m, 4)), np.zeros(m, bool), np.zeros((m, 1, 2))
    hom = np.concatenate(
        [hull, np.zeros((len(hull), 1)), np.ones((len(hull), 1))], axis=1
    )
    clip = np.einsum(
        "mrk,hk->mhr", np.asarray(transforms, np.float64), hom
    )
    ok = np.all(np.isfinite(clip), axis=(1, 2))
    w = clip[..., 3]
    front = w > _NEAR_CLIP_EPS
    all_front = np.all(front, axis=-1) & ok
    with np.errstate(invalid="ignore", divide="ignore"):
        ndc = clip[..., :2] / np.where(
            front[..., None], w[..., None], 1.0
        )
    h = hull.shape[0]
    # One extra slot: clipping a convex polygon against a single plane
    # adds at most one vertex; unused slots repeat a vertex (degenerate
    # edges are inert in the SAT and contribute zero signed area).
    polys = np.concatenate([ndc, ndc[:, :1]], axis=1)
    boxes = np.concatenate([ndc.min(axis=1), ndc.max(axis=1)], axis=-1)
    for i in np.nonzero(~all_front & ok)[0]:
        p = _clip_poly_near(clip[i])
        if len(p) == 0:
            boxes[i] = (np.inf, np.inf, -np.inf, -np.inf)
            polys[i] = 0.0
            continue
        boxes[i] = (*p.min(axis=0), *p.max(axis=0))
        polys[i, : len(p)] = p
        polys[i, len(p):] = p[-1]
    return boxes, ok, polys


def _convex_polys_disjoint(pa, pb) -> bool:
    """Strict separating-axis test between two convex screen polygons
    of either winding: True iff some edge line of one polygon has the
    whole other polygon STRICTLY on its outer side.  Touching polygons
    count as overlapping (a shared boundary could carry the same sample
    point); degenerate polygons conservatively count as overlapping."""
    for first, second in ((pa, pb), (pb, pa)):
        e = np.roll(first, -1, axis=0) - first
        nx, ny = e[:, 1], -e[:, 0]
        c = -(nx * first[:, 0] + ny * first[:, 1])
        centroid = first.mean(axis=0)
        side = nx * centroid[0] + ny * centroid[1] + c
        flip = np.where(side > 0.0, -1.0, 1.0)
        nx, ny, c = nx * flip, ny * flip, c * flip
        d = (
            nx[:, None] * second[None, :, 0]
            + ny[:, None] * second[None, :, 1]
            + c[:, None]
        )
        if bool(np.any(np.all(d > 0.0, axis=1))):
            return True
    return False


def _covers_disjoint(boxes, polys, i, j) -> bool:
    """Exact cover disjointness of pair ``i`` vs ``j``: the cheap AABB
    test first, the polygon SAT only when the boxes touch (covers are
    the hull polygons, so box contact alone does not make them
    interact — e.g. rotated grid cells whose AABBs overlap while the
    cells stay apart)."""
    if _boxes_disjoint(boxes[i], boxes[j]):
        return True
    return _convex_polys_disjoint(polys[i], polys[j])


def _poly_orientation_signs(polys):
    """Sign of the signed area of each projected hull polygon (m, h, 2)
    — the orientation parity of each instance's screen mapping."""
    x, y = polys[..., 0], polys[..., 1]
    area2 = np.sum(
        x * np.roll(y, -1, axis=1) - np.roll(x, -1, axis=1) * y, axis=1
    )
    return np.sign(area2)


def _is_mach_op(o) -> bool:
    """Whether op ``o`` is clip/alpha machinery (see _gate_spans)."""
    return o in (
        coverage.OP_CLIP, coverage.OP_UNCLIP, coverage.OP_SAVE_ALPHA,
        coverage.OP_SCALE_ALPHA, coverage.OP_RESTORE_ALPHA,
        coverage.OP_SAVE_SCALE,
    )


def _machinery_alphas(c):
    """Per-instance opacity tuple of a machinery cover's color, or
    None when it is not a plain color."""
    if _paint_kind(c.color):
        return None
    a = np.asarray(c.color, np.float64)
    if a.ndim == 1:
        a = a[None, :]
    if a.ndim != 2 or a.shape[-1] != 4:
        return None
    try:
        return tuple(
            np.broadcast_to(a[:, 3], (c.n_instances,)).tolist()
        )
    except ValueError:
        return None


def _gate_spans(commands, spec) -> tuple:
    """Static clip/alpha bracket analysis feeding coverage's per-tile
    machinery gating (FrameSpec.gate_spans).

    On a tile where NO content draw of the whole frame lands, frame
    alpha is exactly 0.0 under every machinery op, and a complete
    bracket — clip stencil + CLIP … UNCLIP back to the entry depth, or
    SAVE(+SCALE)/SAVE_SCALE … RESTORE on one layer — is then BIT-EXACT
    identity on the color buffer: the save/scale/restore chain over
    a0 = 0 computes fl(1−g) − fl((1−0)·fl(1−g)) = 0 with no rounding
    slack, and clip ops never touch color.  So `prepare` may drop the
    machinery from such tiles (usually leaving them on the empty-tile
    fast path).  Content activity is deliberately FRAME-wide, not
    span-wide: with content anywhere in the tile, frame alpha can be
    nonzero and the float composition would differ from identity by
    rounding, so those tiles keep their machinery.  The reference gets
    the analogous saving from hardware early-stencil rejection
    (renderer.rs:692-729).

    This discharges every proof obligation that is static:

    - depth protocol, simulated from 0: each CLIP opens at cur+1 with
      its feeding machinery stencils at cur (clip-gated winding keeps
      every promotion inside the enclosing clip region), each UNCLIP
      closes at cur−1 on the SAME shape with the same instance count
      (the closer's hulls contain exactly the opener's promotions);
    - alpha protocol: SAVE/SAVE_SCALE … RESTORE pair on one layer and
      one shape with the SAME group opacity (the reverse-subtract
      undoes exactly one scale by g), issued at the SAME clip depth
      under the SAME open-clip state (the kernel masks every alpha op
      with clipb == its depth — a restore issued after the bracket's
      unclip would apply nowhere while its save applied somewhere);
      nested saves must use distinct layers (a shadowed layer slot
      would feed the outer restore the inner save's snapshot);
    - machinery stencils: winding consumed exclusively by machinery
      covers (so skipping both leaves nothing half-consumed).

    Hull coincidence — equal transform rows between paired commands —
    is runtime state and is returned as ``row_pairs`` for prepare's
    traced per-frame check.  Returns () — gate nothing — on ANY
    deviation from the protocol; gating is an optimization, never a
    semantics change.
    """
    ops = spec.ops
    C = len(ops)
    openers = (
        coverage.OP_CLIP, coverage.OP_SAVE_ALPHA, coverage.OP_SAVE_SCALE
    )
    if not any(o in openers for o in ops):
        return ()
    machinery_ops = (
        coverage.OP_CLIP, coverage.OP_UNCLIP, coverage.OP_SAVE_ALPHA,
        coverage.OP_SCALE_ALPHA, coverage.OP_RESTORE_ALPHA,
        coverage.OP_SAVE_SCALE,
    )
    draws = coverage.draw_tables(spec)
    row_base = draws.row_base

    alphas_of = _machinery_alphas
    mach = [o in machinery_ops for o in ops]
    for i, o in enumerate(ops):
        if o == coverage.OP_STENCIL:
            consumers = []
            j = i + 1
            while j < C and ops[j] != coverage.OP_STENCIL:
                consumers.append(j)
                j += 1
            mach[i] = bool(consumers) and all(mach[j] for j in consumers)

    def rows(i):
        return range(int(row_base[i]), int(row_base[i + 1]))

    cur = 0
    clip_stack = []
    alpha_stack = []
    spans = []
    pairs = []
    start = None
    for i, c in enumerate(commands):
        o = ops[i]
        if o == coverage.OP_STENCIL:
            if mach[i] and c.clip_depth != cur:
                return ()
            continue
        if start is None and o in openers:
            s = i
            while s > 0 and ops[s - 1] == coverage.OP_STENCIL and mach[s - 1]:
                s -= 1
            start = s
            pairs = []
        if o == coverage.OP_CLIP:
            if c.clip_depth != cur + 1:
                return ()
            clip_stack.append(i)
            cur += 1
        elif o == coverage.OP_UNCLIP:
            if not clip_stack or c.clip_depth != cur - 1:
                return ()
            j = clip_stack.pop()
            if (
                spec.cmd_shape[j] != spec.cmd_shape[i]
                or commands[j].n_instances != c.n_instances
            ):
                return ()
            pairs += list(zip(rows(j), rows(i)))
            cur -= 1
        elif o in (coverage.OP_SAVE_ALPHA, coverage.OP_SAVE_SCALE):
            g = alphas_of(c) if o == coverage.OP_SAVE_SCALE else None
            if o == coverage.OP_SAVE_SCALE and g is None:
                return ()
            if any(top[1] == c.alpha_layer for top in alpha_stack):
                return ()
            # The kernel masks every alpha op with clipb == its depth:
            # record the issue-time clip state so scale/restore are
            # provably issued under the identical mask.
            clip_state = (c.clip_depth, tuple(clip_stack))
            alpha_stack.append([i, c.alpha_layer, g, clip_state])
        elif o == coverage.OP_SCALE_ALPHA:
            if not alpha_stack:
                return ()
            top = alpha_stack[-1]
            g = alphas_of(c)
            if (
                top[2] is not None
                or g is None
                or top[3] != (c.clip_depth, tuple(clip_stack))
                or spec.cmd_shape[top[0]] != spec.cmd_shape[i]
                or commands[top[0]].n_instances != c.n_instances
            ):
                return ()
            top[2] = g
            pairs += list(zip(rows(top[0]), rows(i)))
        elif o == coverage.OP_RESTORE_ALPHA:
            if not alpha_stack:
                return ()
            j, layer, g, clip_state = alpha_stack.pop()
            if (
                c.alpha_layer != layer
                or g is None
                or alphas_of(c) != g
                or clip_state != (c.clip_depth, tuple(clip_stack))
                or spec.cmd_shape[j] != spec.cmd_shape[i]
                or commands[j].n_instances != c.n_instances
            ):
                return ()
            pairs += list(zip(rows(j), rows(i)))
        elif start is None and mach[i]:
            # Machinery outside any span (stray SCALE etc.): bail.
            return ()
        if start is not None and not clip_stack and not alpha_stack:
            spans.append((start, i + 1, tuple(pairs)))
            start = None
            pairs = []
    if clip_stack or alpha_stack:
        return ()
    ucmd = draws.unit_cmd
    # Frame-wide content (see the bit-exactness argument above): every
    # unit of a non-machinery command, anywhere in the frame.
    content_u = tuple(
        int(u) for u in range(len(ucmd)) if not mach[ucmd[u]]
    )
    if not content_u:
        return ()
    out = []
    for s, e, rp in spans:
        mach_u = tuple(
            int(u)
            for u in range(len(ucmd))
            if s <= ucmd[u] < e and mach[ucmd[u]]
        )
        if mach_u:
            out.append((content_u, mach_u, rp))
    return tuple(out)


#: Blend states under which painting the SAME opaque color twice at a
#: sample equals painting it once (canonical (src, op, dst) forms of
#: back_to_front source-over and front_to_back) — the precondition of
#: the uniform-opaque-color fusion escape, _run_overlap_escape.
def _idempotent_blend(blending) -> bool:
    canonical = (
        blending if isinstance(blending, str) else blending.canonical()
    )
    return canonical in ("back_to_front", "front_to_back")


def _run_overlap_escape(pairs) -> bool:
    """True when every pair of a fusable run paints the SAME opaque
    solid color — then the fused instanced draw is pixel-exact even
    where covers overlap (given an idempotent blend state, no depth
    state, and uniform orientation parity, checked per frame):

    Overlap changes only WHICH cover paints a shared sample and HOW
    MANY times — with one opaque color under an idempotent blend both
    are invisible, and winding borrowed across instances cannot cancel
    when every instance maps with the same orientation sign.  This is
    what makes dense grids (the showcase's 46 rounded cells, whose
    hulls genuinely interleave) fuse as ONE instanced draw across a
    whole camera orbit — the reference's unconditional
    instance_range 0..n draw (renderer.rs:267, 462-466), with the
    soundness conditions made explicit."""
    first = _solid_rgba(pairs[0][1].color)
    if first is None or first[3] != 1.0:
        return False
    return all(
        _solid_rgba(c.color) == first for _, c in pairs[1:]
    )


def _greedy_box_groups(boxes, ok, polys):
    """Greedy disjoint grouping in walk order (the rule of
    _fuse_instance_runs, sharpened to exact hull-polygon disjointness):
    a pair joins the current group iff its cover is well-defined and
    disjoint from every cover already in the group.  Returns a tuple of
    tuples of pair indices."""
    groups = []
    current = []
    for i in range(len(boxes)):
        if ok[i] and all(
            _covers_disjoint(boxes, polys, i, j) for j in current
        ):
            current.append(i)
        else:
            if current:
                groups.append(tuple(current))
            current = [i]
            if not ok[i]:
                # A boxless (near-plane) pair may never accept
                # neighbours: close its group immediately.
                groups.append(tuple(current))
                current = []
    if current:
        groups.append(tuple(current))
    return tuple(groups)


def _greedy_box_groups_multi(per_stack, ok):
    """_greedy_box_groups across a MOTION: a pair joins the current
    group only if its cover is well-defined and disjoint from every
    member in EVERY transform stack (``per_stack``: one
    ``(boxes, polys)`` per frame of the motion).  The resulting
    grouping stays valid for the whole camera path, so one compiled
    variant serves every frame."""
    groups = []
    current = []
    for i in range(len(ok)):
        if ok[i] and all(
            _covers_disjoint(boxes, polys, i, j)
            for j in current
            for boxes, polys in per_stack
        ):
            current.append(i)
        else:
            if current:
                groups.append(tuple(current))
            current = [i]
            if not ok[i]:
                groups.append(tuple(current))
                current = []
    if current:
        groups.append(tuple(current))
    return tuple(groups)


class _FusionPlan:
    """A concrete grouping of a FrameProgram's structural runs: the
    fused command list, the opt-layout→fused-layout row gather, and
    per fused group the rows to re-validate each call."""

    __slots__ = ("commands", "gather", "groups", "signature")


def _plan_for_groups(commands, runs, groupings):
    """Fused command list for one grouping choice.

    ``groupings[k]`` is ``(groups, escape)`` for ``runs[k]``: a tuple
    of tuples of pair indices (from _greedy_box_groups, or one
    all-pairs group under the overlap escape) plus whether the escape
    validation regime applies.  Groups of >= 2 pairs become one
    instanced (STENCIL, COLOR) pair — the reference's
    ``instance_range 0..n`` draw (renderer.rs:267, 462-466); singleton
    groups keep their original sequential pair.  Returns None when no
    group fuses (the sequential program is the plan)."""
    rows_before = np.cumsum([0] + [c.n_instances for c in commands])
    run_at = {r.start: (r, g) for r, g in zip(runs, groupings)}
    out = []
    gather = []
    groups_meta = []
    fused_any = False
    i = 0
    n = len(commands)
    while i < n:
        hit = run_at.get(i)
        if hit is None:
            gather.extend(range(rows_before[i], rows_before[i + 1]))
            out.append(commands[i])
            i += 1
            continue
        r, (grouping, escape) = hit
        for group in grouping:
            if len(group) < 2:
                for gi in group:
                    s, c = r.pairs[gi]
                    out.append(s)
                    out.append(c)
                    gather.append(int(r.stencil_rows[gi]))
                    gather.append(int(r.cover_rows[gi]))
                continue
            fused_any = True
            idx = list(group)
            transforms = np.ascontiguousarray(
                np.stack([
                    np.asarray(r.pairs[gi][0].transform, np.float32)
                    for gi in idx
                ])
            )
            first_color = r.pairs[0][1].color
            if _paint_kind(first_color):
                color = first_color
            else:
                color = np.ascontiguousarray(
                    np.stack([
                        np.asarray(
                            r.pairs[gi][1].color, np.float32
                        ).reshape(4)
                        for gi in idx
                    ])
                )
            out.append(replace(r.pairs[idx[0]][0], transform=transforms))
            out.append(
                replace(
                    r.pairs[idx[0]][1], transform=transforms, color=color
                )
            )
            srows = [int(r.stencil_rows[gi]) for gi in idx]
            crows = [int(r.cover_rows[gi]) for gi in idx]
            gather.extend(srows)
            gather.extend(crows)
            groups_meta.append(
                (
                    r.shape,
                    np.asarray(srows, np.int64),
                    np.asarray(crows, np.int64),
                    escape,
                )
            )
        i = r.start + 2 * len(r.pairs)
    if not fused_any:
        return None
    plan = _FusionPlan()
    plan.commands = out
    plan.gather = np.asarray(gather, np.int32)
    plan.groups = groups_meta
    plan.signature = tuple(
        (escape,) + tuple(tuple(g) for g in grouping)
        for grouping, escape in groupings
    )
    return plan


class _SceneArrays:
    """Padded, stacked, device-resident geometry for a set of shapes."""

    def __init__(self, shapes: Sequence[Shape]):
        t_max = max(1, max(len(s.triangles) for s in shapes))
        h_max = max(4, max(len(s.convex_hull) for s in shapes))

        def pad_tables(shape):
            t = shape.triangles
            pad = t_max - len(t)
            xy = np.concatenate([t.xy, np.zeros((pad, 3, 2), np.float32)])
            aux = np.concatenate([t.aux, np.zeros((pad, 3, 4), np.float32)])
            kind = np.concatenate([t.kind, np.zeros(pad, np.int32)])
            meta = np.concatenate([t.meta, np.zeros((pad, 2), np.float32)])
            hull = shape.convex_hull.astype(np.float32)
            if len(hull) == 0:
                hull = np.zeros((1, 2), np.float32)
            hull = np.concatenate(
                [hull, np.repeat(hull[-1:], h_max - len(hull), axis=0)]
            )
            return xy, aux, kind, meta, hull

        padded = [pad_tables(s) for s in shapes]
        gbase = np.cumsum(
            [0] + [len(s.descriptors.phase) for s in shapes[:-1]]
        ).astype(np.int32)
        self.t_max = t_max
        self.h_max = h_max
        self.n_shapes = len(shapes)
        #: Whether any shape carries stroke geometry (line/joint rows):
        #: False compiles the stroke classes out of the kernel walk
        #: (coverage.FrameSpec.has_strokes).  Every shape pads its
        #: descriptor table to at least one group, so the group count
        #: cannot tell.
        self.has_strokes = any(
            bool((np.asarray(s.triangles.kind) >= KIND_STROKE_LINE).any())
            for s in shapes
        )
        self.xy = jnp.asarray(np.stack([p[0] for p in padded]))
        self.aux = jnp.asarray(np.stack([p[1] for p in padded]))
        self.kind = jnp.asarray(np.stack([p[2] for p in padded]))
        self.meta = jnp.asarray(np.stack([p[3] for p in padded]))
        self.hull = jnp.asarray(np.stack([p[4] for p in padded]))
        self.gbase = jnp.asarray(gbase)

    @property
    def arrays(self):
        return (self.xy, self.aux, self.kind, self.meta, self.gbase, self.hull)


def _next_pow2(n: int) -> int:
    out = 1
    while out < n:
        out *= 2
    return out


#: Shrink-to-fit headroom: persistent frame programs size their binning
#: buffers at next-pow2(settle-frame count × this margin) so small
#: camera motion doesn't immediately trigger a deferred-growth rebuild.
FIT_MARGIN = 1.5

#: Shrink-to-fit floors for (tile, global, tile-global, clip-pool)
#: capacities — below these the dense per-tile blocks are cheap anyway.
FIT_FLOORS = (32, 64, 16, 16)


def _fit_capacity(count: int, floor_: int, ceiling: int) -> int:
    """Shared shrink-to-fit policy of FrameProgram and the sharded
    frame programs: next-pow2(count · FIT_MARGIN), floored and clamped
    to the renderer's (grow-converged) ceiling."""
    return min(
        ceiling, max(floor_, _next_pow2(int(count * FIT_MARGIN) + 1))
    )


#: In-plane rotation (radians) of the capacity-settling probe frame:
#: 45° maximally misaligns the scene with the tile grid.
SETTLE_PROBE_ANGLE = math.pi / 4


def _rotated_probe_commands(commands):
    """A copy of ``commands`` with every transform pre-rotated in clip
    space, used as a SECOND capacity-settling frame.

    An axis-aligned scene bins optimistically: tiles fully covered by a
    rect go through the trivial-accept bulk-winding path and list NO
    per-tile entries, so the settle frame's ``max_tile_entries`` badly
    under-predicts what camera motion will need.  Settling takes the worst counters
    of the natural frame AND this rotated probe so a persistent frame
    program sized by shrink-to-fit survives camera motion without
    tripping the deferred-growth rebuild (and its transiently
    under-populated frames) on the first orbit frame.  Motions the
    probe cannot anticipate (e.g. an extreme zoom-out concentrating the
    whole scene into one tile) still regrow through the deferred
    rebuild."""
    c = math.cos(SETTLE_PROBE_ANGLE)
    s = math.sin(SETTLE_PROBE_ANGLE)
    rot = np.array(
        [[c, -s, 0.0, 0.0],
         [s, c, 0.0, 0.0],
         [0.0, 0.0, 1.0, 0.0],
         [0.0, 0.0, 0.0, 1.0]],
        np.float32,
    )
    out = []
    for cmd in commands:
        t = np.asarray(cmd.transform, np.float32)
        rt = rot @ t if t.ndim == 2 else np.einsum(
            "ij,njk->nik", rot, t
        )
        out.append(replace(cmd, transform=rt))
    return out


class Renderer:
    """Executes frames of draw commands on the device
    (replaces reference Renderer, renderer.rs:408-884)."""

    def __init__(
        self,
        config: Configuration,
        width: int,
        height: int,
        tile_size=None,
        tile_capacity: int = 256,
        interpret=None,
        strict_capacity: bool = True,
        fill_batch=None,
        stroke_batch: int = 1,
        auto_instance: bool = True,
    ):
        self.config = config
        self.width = int(width)
        self.height = int(height)
        #: Tile height in pixels (a power of two; None = the
        #: FrameSpec default).  Tiles are (tile_h × tile_w): one kernel
        #: program each, with the tile's per-sample state in registers.
        self.tile_h = (
            coverage.FrameSpec.tile_h if tile_size is None
            else int(tile_size)
        )
        self.tile_w = coverage.FrameSpec.tile_w
        self.tile_capacity = int(tile_capacity)
        #: Fill entries evaluated per kernel walk iteration.
        self.fill_batch = (
            coverage.NB if fill_batch is None else int(fill_batch)
        )
        #: Stroke entries evaluated per kernel walk iteration.
        self.stroke_batch = max(1, int(stroke_batch))
        self._global_capacity = 1024
        # Per-tile big-triangle rows are materialized for every tile
        # whether used or not — start small; the overflow machinery
        # grows it (scenes of small triangles never pay for unused
        # slots).
        self._tile_global_capacity = 32
        self._clip_pool = 64
        self._interpret = interpret
        #: strict_capacity=True synchronizes on the binning overflow
        #: counters whenever transforms change, guaranteeing no dropped
        #: triangles.  False defers the check one frame (overlapped with
        #: rendering): an animated scene that outgrows its buffers may
        #: show one under-populated frame before capacities regrow —
        #: the right trade for interactive camera motion.
        self.strict_capacity = bool(strict_capacity)
        self._pending_overflow = []
        self._frame_index = 0
        self._executors = {}
        self._executors_carry = {}
        self._scene_cache = {}
        self._prepared_cache = {}
        #: Content-keyed cache of small device-resident runtime arrays
        #: (command tables, descriptors, transforms): unchanged arrays
        #: are not re-uploaded every frame; the reference's analogue is
        #: its update-in-place buffers (renderer.rs:63-117).
        self._upload_cache = {}
        #: Auto-instancing (see _fuse_instance_runs): render() collapses
        #: consecutive per-instance (Stencil, Color) pairs into
        #: instanced draws wherever their cover boxes are disjoint —
        #: pixel-exact, decided per call with the current transforms.
        #: Disable to force the literal sequential walk (and for
        #: fused-vs-sequential equality tests).
        self.auto_instance = bool(auto_instance)
        self._fuse_cache = {}
        #: Runtime blend-constant color for the ``constant`` /
        #: ``one_minus_constant`` blend factors (wgpu
        #: set_blend_constant; default transparent black as wgpu's).
        self.blend_constant = (0.0, 0.0, 0.0, 0.0)
        #: Digests of transform stacks already validated finite (a
        #: 10k-instance stack costs ~0.5 ms to re-validate per frame).
        self._finite_ok = {}
        #: Memoized _gate_spans results (see _spec) — the analysis
        #: walks every instance row in Python and render() derives a
        #: spec per frame.
        self._gate_cache = {}
        #: Per-stage counters of the last rendered frame (observability).
        self.stats = {}
        #: Binning-capacity growths (each one recompiles the frame).
        self.capacity_growths = 0

    # ------------------------------------------------------------------

    def resize(self, width: int, height: int):
        """Change the framebuffer size (reference
        resize_internal_buffers, renderer.rs:892-929).  Compiled frame
        programs are per-resolution; scene uploads survive."""
        if (int(width), int(height)) == (self.width, self.height):
            return
        self.width = int(width)
        self.height = int(height)
        self._executors.clear()
        self._executors_carry.clear()
        self._prepared_cache.clear()

    def set_blend_constant(self, color):
        """Set the blend-constant color read by the ``constant`` /
        ``one_minus_constant`` blend factors (wgpu
        RenderPass::set_blend_constant).  A runtime input: changing it
        re-uploads a few bytes, never recompiles."""
        color = np.asarray(color, np.float32).reshape(-1)
        if color.shape != (4,):
            raise ValueError("blend constant must be RGBA")
        require_finite(color, "blend constant")
        self.blend_constant = tuple(float(c) for c in color)

    def _blend_constant_arg(self):
        """The packer's blend-constant argument: the runtime color when
        the configured blend state references it, else None (cmd_f then
        stays at its 20-column layout)."""
        blending = (
            self.config.blending
            if isinstance(self.config.blending, str)
            else self.config.blending.canonical()
        )
        return (
            self.blend_constant
            if coverage.blend_uses_constant(blending)
            else None
        )

    def _interpret_flag(self) -> bool:
        if self._interpret is None:
            self._interpret = coverage.interpret_for_platform(
                jax.default_backend()
            )
        return self._interpret

    def _validate(self, commands):
        config = self.config
        for command in commands:
            if isinstance(command.shape, (list, tuple)) and len(
                command.shape
            ) != command.n_instances:
                raise ValueError(
                    f"multi-shape command carries {len(command.shape)} "
                    f"shapes for {command.n_instances} instances"
                )
            if command.clip_depth >= (1 << config.clip_nesting_counter_bits):
                raise ClipStackOverflow(str(command.clip_depth))
            if command.operation in (
                RenderOperation.SAVE_ALPHA_CONTEXT,
                RenderOperation.SCALE_ALPHA_CONTEXT,
                RenderOperation.RESTORE_ALPHA_CONTEXT,
            ) and command.alpha_layer >= config.alpha_layer_count:
                raise TooManyNestedOpacityGroups(str(command.alpha_layer))
            if _paint_kind(command.color):
                if command.operation != RenderOperation.COLOR:
                    raise ValueError(
                        "gradient paints apply only to Color commands"
                    )
                continue
            color = np.asarray(command.color)
            if color.ndim == 2 and color.shape[0] not in (
                1, command.n_instances
            ):
                raise ValueError(
                    f"per-instance color count {color.shape[0]} does not "
                    f"match {command.n_instances} instances"
                )

    @staticmethod
    def _pack_transforms(commands) -> np.ndarray:
        """Stack every command's instance transforms into the (R, 4, 4)
        draw-row layout of coverage.draw_tables."""
        rows = [
            np.asarray(c.transform, np.float32).reshape(-1, 4, 4)
            for c in commands
        ]
        return np.ascontiguousarray(np.concatenate(rows))

    def _unique_shapes(self, commands):
        shapes = []
        shape_index = {}
        for command in commands:
            for shape in command.shapes:
                if id(shape) not in shape_index:
                    shape_index[id(shape)] = len(shapes)
                    shapes.append(shape)
        return shapes, shape_index

    @staticmethod
    def _cmd_shape_entry(command, shape_index):
        """FrameSpec.cmd_shape entry for one command: an int, or a
        per-instance tuple for multi-shape commands."""
        if isinstance(command.shape, (list, tuple)):
            return tuple(shape_index[id(s)] for s in command.shape)
        return shape_index[id(command.shape)]

    def _scene_arrays(self, shapes) -> Tuple[tuple, _SceneArrays]:
        key = tuple((s._uid, s._geometry_version) for s in shapes)
        scene = self._scene_cache.get(key)
        if scene is None:
            scene = _SceneArrays(shapes)
            if len(self._scene_cache) >= 8:
                self._scene_cache.pop(next(iter(self._scene_cache)))
            self._scene_cache[key] = scene
        return key, scene

    def _spec(self, ops, cmd_shape, cmd_inst, scene,
              paints=(), commands=None) -> coverage.FrameSpec:
        spec = coverage.FrameSpec(
            width=self.width,
            height=self.height,
            ops=ops,
            cmd_shape=cmd_shape,
            cmd_inst=cmd_inst,
            paints=paints if any(paints) else (),
            n_shapes=scene.n_shapes,
            t_max=scene.t_max,
            h_max=scene.h_max,
            samples=self.config.msaa_sample_count,
            winding_bits=self.config.winding_counter_bits,
            n_layers=self.config.alpha_layer_count,
            blending=(
                self.config.blending
                if isinstance(self.config.blending, str)
                else self.config.blending.canonical()
            ),
            depth_compare=self.config.depth_compare,
            depth_write=self.config.depth_write_enabled,
            tile_h=self.tile_h,
            tile_w=self.tile_w,
            capacity=self.tile_capacity,
            global_capacity=self._global_capacity,
            tile_global_capacity=self._tile_global_capacity,
            clip_pool=self._clip_pool,
            fill_batch=self.fill_batch,
            stroke_batch=self.stroke_batch,
            has_strokes=scene.has_strokes,
            interpret=self._interpret_flag(),
        )
        if commands is not None and any(
            o in (
                coverage.OP_CLIP, coverage.OP_SAVE_ALPHA,
                coverage.OP_SAVE_SCALE,
            )
            for o in ops
        ):
            # Memoized: the analysis result is a pure function of the
            # pre-gate spec plus the per-command clip/layer/opacity
            # fields it reads — render() calls _spec per frame, and
            # draw_tables is O(total instance rows) in Python.
            gkey = (
                spec,
                tuple(
                    (
                        c.clip_depth,
                        c.alpha_layer,
                        _machinery_alphas(c) if _is_mach_op(o) else None,
                    )
                    for o, c in zip(ops, commands)
                ),
            )
            gates = self._gate_cache.get(gkey)
            if gates is None:
                gates = _gate_spans(commands, spec)
                if len(self._gate_cache) >= 32:
                    self._gate_cache.pop(next(iter(self._gate_cache)))
                self._gate_cache[gkey] = gates
            if gates:
                spec = replace(spec, gate_spans=gates)
        return spec

    def _get_executors(self, spec):
        execs = self._executors.get(spec)
        if execs is None:
            execs = (
                jax.jit(coverage.make_prepare(spec)),
                jax.jit(coverage.make_rasterize(spec)),
            )
            self._executors[spec] = execs
        return execs

    def _get_rasterize_carry(self, spec):
        """Rasterize + per-frame completion probe in ONE dispatch:
        returns (image, carry + sum(image[..., 3])), so throughput
        harnesses chain this instead of launching a separate probe."""
        fn = self._executors_carry.get(spec)
        if fn is None:
            rasterize = coverage.make_rasterize(spec)

            def step(carry, prepared, cmd_i, cmd_f, desc_f, desc_i):
                image = rasterize(prepared, cmd_i, cmd_f, desc_f, desc_i)
                probe = image[..., 3]
                if probe.dtype != jnp.float32:  # packed-uint8 output
                    probe = probe.astype(jnp.float32)
                return image, carry + jnp.sum(probe)

            fn = jax.jit(step)
            self._executors_carry[spec] = fn
        return fn

    @staticmethod
    def _pack_descriptors(shapes):
        tables = [s.descriptors for s in shapes]
        n = sum(len(t.phase) for t in tables)
        desc_f = np.zeros((max(1, n), coverage.DESC_F), np.float32)
        desc_i = np.zeros((max(1, n), coverage.DESC_I), np.int32)
        base = 0
        for t in tables:
            g = len(t.phase)
            desc_f[base:base + g, 0:4] = t.gap_start
            desc_f[base:base + g, 4:8] = t.gap_end
            desc_f[base:base + g, 8] = t.phase
            desc_i[base:base + g, 0:4] = t.end_caps
            desc_i[base:base + g, 4:8] = t.start_caps
            desc_i[base:base + g, 8] = t.last_interval
            desc_i[base:base + g, 9] = t.dashed
            desc_i[base:base + g, 10] = t.join
            desc_i[base:base + g, 11] = t.solid_start_cap
            desc_i[base:base + g, 12] = t.solid_end_cap
            base += g
        return desc_f, desc_i

    @staticmethod
    def _pack_commands_runtime(commands, blend_constant=None):
        """cmd_i is per command; cmd_f holds one color row per *cover
        draw* — the (command, instance) expansion of every non-stencil
        command, in the order coverage.draw_tables enumerates them (the
        reference's instance-rate color attribute, renderer.rs:462-466).

        ``blend_constant`` (RGBA or None): when the blend state uses
        constant factors, the runtime constant is appended as cmd_f
        columns 20:24 (broadcast to every row).

        User paints pack as code ``UserPaint.kind + i`` with ``i`` the
        first-appearance index of the paint's ``fn`` in the command
        walk — the same ordering coverage.make_rasterize derives from
        FrameSpec.paints, so the runtime dispatch and the compiled
        branches agree.
        """
        user_codes = {}

        def paint_code(color):
            kind = _paint_kind(color)
            if kind < UserPaint.kind:
                return kind
            return UserPaint.kind + user_codes.setdefault(
                id(color.fn), len(user_codes)
            )

        cmd_i = np.array(
            [
                [int(c.operation), c.clip_depth, c.alpha_layer,
                 paint_code(c.color)]
                for c in commands
            ],
            np.int32,
        )
        # cmd_f row layout (width 20): columns [0:16] = up to 4 gradient
        # stop colors (RGBA each; [0:4] doubles as the solid color the
        # alpha-group ops read), [16:20] = stop offsets.  Solid rows
        # broadcast their color to all stops (every piecewise delta is
        # then zero).
        rows = []
        for c in commands:
            if c.operation == RenderOperation.STENCIL:
                continue
            if _paint_kind(c.color) >= UserPaint.kind:
                # User paints read px/py/anchor, not the stop table.
                rows.append(np.zeros((c.n_instances, 20), np.float32))
                continue
            if _paint_kind(c.color):
                offsets, colors = c.color.stop_table()
                row = np.concatenate([colors.reshape(-1), offsets])[None]
                rows.append(np.broadcast_to(row, (c.n_instances, 20)))
                continue
            color = np.asarray(c.color, np.float32).reshape(-1, 4)
            color = (
                np.broadcast_to(color, (c.n_instances, 4))
                if color.shape[0] == 1
                else color
            )
            rows.append(
                np.concatenate(
                    [
                        np.tile(color, (1, coverage.MAX_STOPS)),
                        np.zeros(
                            (len(color), coverage.MAX_STOPS), np.float32
                        ),
                    ],
                    axis=1,
                )
            )
        cmd_f = (
            np.ascontiguousarray(np.concatenate(rows), dtype=np.float32)
            if rows
            else np.zeros((1, 20), np.float32)
        )
        if blend_constant is not None:
            const = np.broadcast_to(
                np.asarray(blend_constant, np.float32), (len(cmd_f), 4)
            )
            cmd_f = np.ascontiguousarray(
                np.concatenate([cmd_f, const], axis=1)
            )
        return cmd_i, cmd_f

    @staticmethod
    def _pack_paints(commands):
        """Model-space gradient endpoints, one (2, 2) row per cover
        draw (coverage.draw_tables order), or None when every paint is
        solid."""
        if not any(_paint_kind(c.color) for c in commands):
            return None
        rows = []
        for c in commands:
            if c.operation == RenderOperation.STENCIL:
                continue
            pts = (
                c.color.points()
                if _paint_kind(c.color)
                else np.zeros((2, 2), np.float32)
            )
            rows.append(np.broadcast_to(pts[None], (c.n_instances, 2, 2)))
        return np.ascontiguousarray(np.concatenate(rows), dtype=np.float32)

    def _dev_cached(self, name: str, arr: np.ndarray, digest=None):
        """Device copy of `arr`, re-uploaded only when its bytes change.

        Keyed on a 16-byte BLAKE2 digest rather than the raw bytes: the
        digest is computed in one pass over the buffer (no bytes()
        copy for contiguous arrays) and the dict never retains or
        re-compares megabyte keys — pass ``digest`` when the caller
        already hashed the buffer this frame.  render()-path only —
        FrameProgram packs its tables once at build time."""
        if digest is None:
            digest = hashlib.blake2b(
                arr if arr.flags["C_CONTIGUOUS"] else arr.tobytes(),
                digest_size=16,
            ).digest()
        key = (name, arr.shape, arr.dtype.str, digest)
        dev = self._upload_cache.get(key)
        if dev is None:
            if len(self._upload_cache) >= 64:
                self._upload_cache.pop(next(iter(self._upload_cache)))
            dev = jax.device_put(arr)
            self._upload_cache[key] = dev
        return dev

    def _auto_instanced(self, commands):
        """Memoized _fuse_instance_runs: the grouping is a pure function
        of command structure, transforms, and colors, so static frames
        (the common case) pay one digest instead of re-projecting hulls
        every call.  The key captures every input the fused output
        embeds — transform VALUES included, so a camera change re-derives
        the grouping (always sound for the frame being rendered)."""
        # Structural pre-scan: fusion only ever collapses ADJACENT
        # single-instance (STENCIL, COLOR) pairs of one shape; frames
        # without one (e.g. a 10k-instance multi-shape text frame)
        # skip the digest/grouping machinery entirely — its key alone
        # costs ~1 ms at that instance count.
        if not any(
            commands[i].operation == RenderOperation.STENCIL
            and commands[i].n_instances == 1
            and commands[i + 1].operation == RenderOperation.COLOR
            and commands[i + 1].n_instances == 1
            and commands[i].shape is commands[i + 1].shape
            for i in range(len(commands) - 1)
        ):
            return commands
        structure = tuple(
            (
                int(c.operation),
                tuple(
                    (s._uid, s._geometry_version) for s in c.shapes
                ),
                c.clip_depth, c.alpha_layer, c.n_instances,
                # Gradient paints fuse by object identity; their stop
                # tables/endpoints are re-read from the (shared) object
                # at pack time, so id() is sufficient here.
                id(c.color) if _paint_kind(c.color) else None,
            )
            for c in commands
        )
        blob = hashlib.blake2b(digest_size=16)
        blob.update(self._pack_transforms(commands))
        for c in commands:
            if not _paint_kind(c.color):
                blob.update(np.asarray(c.color, np.float32).tobytes())
        key = (structure, blob.digest())
        hit = self._fuse_cache.get(key)
        if hit is None:
            fused, fused_any = _fuse_instance_runs(commands)
            hit = fused if fused_any else commands
            if len(self._fuse_cache) >= 8:
                self._fuse_cache.pop(next(iter(self._fuse_cache)))
            self._fuse_cache[key] = hit
        return hit

    def _grow_capacities(self, overflow, limits) -> bool:
        grew = self._grow_capacities_once(overflow, limits)
        self.capacity_growths += int(grew)
        return grew

    def _grow_capacities_once(self, overflow, limits) -> bool:
        grew = False
        if overflow[0] > limits[0]:
            self.tile_capacity = _next_pow2(int(overflow[0]))
            grew = True
        if overflow[1] > limits[1]:
            self._global_capacity = _next_pow2(int(overflow[1]))
            grew = True
        if overflow[2] > limits[2]:
            self._tile_global_capacity = _next_pow2(int(overflow[2]))
            grew = True
        if overflow[3] > limits[3]:
            self._clip_pool = _next_pow2(int(overflow[3]))
            grew = True
        return grew

    # ------------------------------------------------------------------

    def _prepare_frame(self, commands):
        """Validate, optimize and bin one frame: returns ``(spec,
        (prepared, cmd_i, cmd_f, desc_f, desc_i))``, the raster stage's
        inputs.  The binning stage (and its cache) is shared between
        the float and packed-u8 output modes; only the raster stage
        compiles per mode."""
        self._validate(commands)
        commands, _ = _optimize_commands(commands)
        if self.auto_instance:
            commands = self._auto_instanced(commands)
        self._frame_index += 1
        if self._pending_overflow:
            # Deferred capacity checks: consume counters whose D2H copy
            # already landed without blocking (no forced sync per
            # frame).  A counter two frames old is force-synced (by then
            # the async copy has landed anyway), so capacity growth lags
            # at most 2 frames.
            grew = False
            keep = []
            for overflow_arr, limits, born in self._pending_overflow:
                ready = getattr(overflow_arr, "is_ready", lambda: True)()
                if ready or self._frame_index - born >= 2:
                    grew |= self._grow_capacities(
                        np.asarray(overflow_arr), limits
                    )
                else:
                    keep.append((overflow_arr, limits, born))
            self._pending_overflow = keep
            if grew:
                self._prepared_cache.clear()
        shapes, shape_index = self._unique_shapes(commands)
        scene_key, scene = self._scene_arrays(shapes)
        ops = tuple(int(c.operation) for c in commands)
        cmd_shape = tuple(
            self._cmd_shape_entry(c, shape_index) for c in commands
        )
        inst = tuple(c.n_instances for c in commands)
        cmd_inst = inst if any(n != 1 for n in inst) else ()
        paints = tuple(_spec_paint(c.color) for c in commands)
        paint_model = self._pack_paints(commands)
        transforms = self._pack_transforms(commands)
        # One digest serves the finite-check memo, the prepared-cache
        # key, and the upload cache — re-hashing/copying a 10k-instance
        # stack (650 KB) several times per frame is real overhead.
        tf_digest = hashlib.blake2b(
            transforms, digest_size=16
        ).digest()
        if tf_digest not in self._finite_ok:
            require_finite(transforms, "command transforms")
            if len(self._finite_ok) >= 64:
                self._finite_ok.pop(next(iter(self._finite_ok)))
            self._finite_ok[tf_digest] = True
        desc_f, desc_i = self._pack_descriptors(shapes)
        # Dash statics (dashed flag, interval count) route stroke
        # entries to specialized kernel bodies at binning time; phase
        # and gap animation stay runtime inputs of the raster stage.
        desc_static = np.ascontiguousarray(desc_i[:, [9, 8]])

        for _attempt in range(4):
            spec = self._spec(
                ops, cmd_shape, cmd_inst, scene, paints,
                commands=commands,
            )
            prepare = self._get_executors(spec)[0]
            pkey = (
                spec, scene_key, tf_digest, desc_static.tobytes(),
                None if paint_model is None else paint_model.tobytes(),
            )
            cached = self._prepared_cache.get(pkey)
            if (
                cached is not None
                and self.strict_capacity
                and "max_tile_entries" not in cached[1]
            ):
                # The entry was cached by a non-strict render and lacks
                # the binning counters a strict caller (FrameProgram's
                # settle frame sizing shrink-to-fit) needs — recompute.
                cached = None
            if cached is not None:
                prepared, self.stats = cached
            else:
                paint_args = (
                    ()
                    if paint_model is None
                    else (self._dev_cached("paints", paint_model),)
                )
                prepared = prepare(
                    *scene.arrays,
                    self._dev_cached(
                        "transforms", transforms, digest=tf_digest
                    ),
                    self._dev_cached("desc_static", desc_static),
                    *paint_args,
                )
                limits = (
                    spec.capacity,
                    spec.global_capacity,
                    spec.tile_global_capacity,
                    spec.clip_pool,
                )
                stats = {
                    "commands": len(commands),
                    "shapes": len(shapes),
                    "triangles_per_shape": scene.t_max,
                    "tiles": spec.n_tiles,
                }
                if self.strict_capacity:
                    overflow = np.asarray(prepared.overflow)
                    stats.update(
                        max_tile_entries=int(overflow[0]),
                        global_triangles=int(overflow[1]),
                        max_tile_globals=int(overflow[2]),
                        near_plane_crossings=int(overflow[3]),
                    )
                    self.stats = stats
                    logger.debug("prepare: %s", self.stats)
                    if self._grow_capacities(overflow, limits):
                        continue
                else:
                    # Deferred check: the counters transfer while this
                    # frame renders and are inspected next frame.
                    try:
                        prepared.overflow.copy_to_host_async()
                    except AttributeError:
                        pass
                    self._pending_overflow.append(
                        (prepared.overflow, limits, self._frame_index)
                    )
                    self.stats = stats
                if len(self._prepared_cache) >= 8:
                    self._prepared_cache.pop(next(iter(self._prepared_cache)))
                self._prepared_cache[pkey] = (prepared, self.stats)
            break
        else:
            raise RuntimeError("tile binning capacity did not converge")

        cmd_i, cmd_f = self._pack_commands_runtime(
            commands, self._blend_constant_arg()
        )
        return spec, (
            prepared,
            self._dev_cached("cmd_i", cmd_i),
            self._dev_cached("cmd_f", cmd_f),
            self._dev_cached("desc_f", desc_f),
            self._dev_cached("desc_i", desc_i),
        )

    def render(
        self,
        commands: Sequence[DrawCommand],
        background=None,
        to_host: bool = True,
        as_uint8: bool = False,
        srgb: bool = False,
        carry=None,
        uint8_kernel: bool = False,
    ):
        """Render a frame; returns (H, W, 4) premultiplied RGBA float32
        (or uint8 with ``as_uint8=True`` — quantized on device, cutting
        the host transfer 4×).

        ``uint8_kernel=True`` resolves to packed RGBA8 INSIDE the
        raster kernel (the presentation path — the reference renders
        into an 8-bit unorm swapchain surface,
        application_framework.rs:172-183 — bit-identical to quantizing
        the float output) while keeping the cached-binning economics of
        this method — the fast path for a static camera presenting
        8-bit frames.  Binning results are shared with the
        float path; ``background``/``srgb`` are not supported in this
        mode (quantization already happened in the kernel).

        The compiled program is cached by the frame's static signature
        (command structure, padded table sizes); the binning stage is
        additionally cached by the instance transforms, so animating
        colors/clip depths/dash phases re-runs only the raster kernel.

        ``to_host=False`` returns the device array without a host copy —
        the equivalent of the reference presenting on-GPU.

        ``carry`` (scalar, implies ``to_host=False``): returns
        ``(image, carry + sum(image[..., 3]))`` computed in the frame's
        dispatch — a per-frame completion probe with no extra program
        launch for throughput harnesses.
        """
        if uint8_kernel and (background is not None or srgb):
            raise ValueError(
                "uint8_kernel does not compose with background/srgb"
            )
        spec, runtime_args = self._prepare_frame(commands)
        raster_spec = replace(spec, out_uint8=True) if uint8_kernel else spec
        rasterize = self._get_executors(raster_spec)[1]
        if carry is not None:
            return self._get_rasterize_carry(raster_spec)(
                jnp.asarray(carry, jnp.float32), *runtime_args
            )
        image = rasterize(*runtime_args)
        if uint8_kernel:
            # Already packed RGBA8 in the kernel; nothing left to do.
            return image if not to_host else np.asarray(image)
        if as_uint8:
            if srgb:
                # Rendering/blending stay linear (the reference
                # pipeline); sRGB-encode only at presentation
                # (utils.rs:204-225).
                if background is not None:
                    image = self._composite(
                        image, jnp.asarray(background, jnp.float32)
                    )
                image = self._quantize_srgb(image)
            elif background is not None:
                image = self._composite_quantize(
                    image, jnp.asarray(background, jnp.float32)
                )
            else:
                image = self._quantize(image)
            return image if not to_host else np.asarray(image)
        if not to_host:
            return image
        image = np.asarray(image)
        if background is not None:
            alpha = image[..., 3:4]
            image = image + np.asarray(background, np.float32) * (1.0 - alpha)
        return image

    def compile_frame(
        self, commands: Sequence[DrawCommand], uint8_output: bool = False
    ) -> "FrameProgram":
        """Compile a fused single-dispatch frame program for this
        command structure (see :class:`FrameProgram`).
        ``uint8_output=True`` resolves to packed RGBA8 inside the
        kernel — the presentation path."""
        return FrameProgram(self, commands, uint8_output=uint8_output)

    @staticmethod
    @jax.jit
    def _quantize(image):
        return (jnp.clip(image, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)

    @staticmethod
    @jax.jit
    def _composite(image, background):
        return image + background * (1.0 - image[..., 3:4])

    @staticmethod
    @jax.jit
    def _composite_quantize(image, background):
        alpha = image[..., 3:4]
        image = image + background * (1.0 - alpha)
        return (jnp.clip(image, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)

    @staticmethod
    @jax.jit
    def _quantize_srgb(image):
        """uint8 with sRGB-encoded RGB (alpha stays linear) — for
        presenting to sRGB surfaces / image files (the reference's
        utils.rs:204-225 conversion, applied device-side; rendering and
        blending stay linear, matching the reference pipeline)."""
        image = jnp.clip(image, 0.0, 1.0)
        rgb = image[..., :3]
        rgb = jnp.where(
            rgb > 0.0031308,
            1.055 * rgb ** jnp.float32(1.0 / 2.4) - 0.055,
            12.92 * rgb,
        )
        image = jnp.concatenate([rgb, image[..., 3:]], axis=-1)
        return (image * 255.0 + 0.5).astype(jnp.uint8)


class _ProgramVariant:
    """One compiled command-walk variant of a FrameProgram: the
    sequential walk, or the auto-instanced fused walk.  Holds the
    variant's FrameSpec, jitted step functions, and packed command
    tables (jax.jit is lazy — an undispatched variant never compiles).
    """

    __slots__ = (
        "spec", "opt_commands", "step", "step_carry", "step_sequence",
        "paint_model", "packed_constant", "cmd_i", "cmd_f",
    )


class FrameProgram:
    """A fused frame step for a fixed command structure: binning +
    raster kernel compiled as ONE jitted program with the instance
    transforms as a runtime input.

    `Renderer.render` dispatches prepare and rasterize separately and
    keys its binning cache on the transform bytes — ideal for static
    cameras (binning never re-runs), but a moving camera pays two
    dispatches plus host cache bookkeeping per frame.  This program is the reference's cheap-camera
    path (the camera is just a matrix, examples/showcase/main.rs:255-274):
    per frame the host sends a (C, 4, 4) transform stack and receives
    the frame in a single dispatch.

    Dash-phase animation keeps working through
    `Shape.set_dynamic_stroke_options`: descriptor tables are re-packed
    (tiny, host-side) every call and passed as runtime inputs.

    Binning overflow is checked asynchronously one frame behind (the
    `strict_capacity=False` contract): a growing scene may render one
    under-populated frame, then capacities regrow and the program
    recompiles.
    """

    def __init__(self, renderer: Renderer, commands: Sequence[DrawCommand],
                 uint8_output: bool = False):
        self._renderer = renderer
        self._commands = list(commands)
        #: Resolve to packed RGBA8 inside the raster kernel (the
        #: swapchain-presentation layout; reference surfaces are 8-bit,
        #: application_framework.rs).  Skips the float de-tiling
        #: transpose and the separate quantize pass and writes 1/4 the
        #: output bytes; frames come back (H, W, 4) uint8, bit-identical
        #: to Renderer._quantize of the float path.
        self._uint8 = bool(uint8_output)
        renderer._validate(self._commands)
        # The kernel walks the *optimized* command list (SAVE+SCALE
        # pairs fused); caller-supplied transform stacks stay in the
        # original one-row-per-draw layout and are gathered through
        # _keep_rows in __call__.
        opt, self._keep_rows = _optimize_commands(self._commands)
        self._opt_commands = opt
        self._shapes, _ = renderer._unique_shapes(opt)
        #: Auto-instancing (the render()-path _fuse_instance_runs, but
        #: with transforms as runtime inputs): fusable runs are
        #: detected structurally here; each call greedily groups them
        #: by cover disjointness under the frame's actual transforms
        #: and dispatches a per-grouping compiled variant (bounded
        #: cache), falling back to the sequential walk otherwise.
        self._runs = _structural_runs(opt) if renderer.auto_instance else []
        # Settle binning capacities with strict prepares so the
        # compiled program starts at converged sizes.  Two probe
        # orientations: the natural frame under-counts per-tile entries
        # for axis-aligned scenes (trivial-accept bulk winding lists no
        # entries for fully covered tiles), so a rotated probe frame
        # contributes the worst counters camera motion will approach
        # (see _rotated_probe_commands).
        was_strict = renderer.strict_capacity
        renderer.strict_capacity = True
        try:
            renderer.render(self._commands, to_host=False)
            natural_stats = dict(renderer.stats)
            merged_stats = dict(natural_stats)
            renderer.render(
                _rotated_probe_commands(self._commands), to_host=False
            )
            for key in (
                "max_tile_entries", "global_triangles",
                "max_tile_globals", "near_plane_crossings",
            ):
                if key in renderer.stats:
                    merged_stats[key] = max(
                        merged_stats.get(key, 0), renderer.stats[key]
                    )
            # The merged counters size this program's capacities below;
            # the renderer's public stats go back to the natural frame's
            # (code reading stats after compile_frame must not see
            # probe-inflated counters no real frame produced).  Note the
            # rotated probe may still have grown the renderer's own
            # capacity ceilings — intentional, so a future program
            # settles at sizes that survive camera motion.
            renderer.stats = natural_stats
        finally:
            renderer.strict_capacity = was_strict
        stats = merged_stats
        # Shrink-to-fit: the settle frame's counters say what the scene
        # actually uses; the renderer's defaults (sized for arbitrary
        # scenes) can be several times larger.  Oversized capacities
        # cost every frame — the binning stage materializes
        # O(n_tiles × K) dense rows and the kernel DMAs (K, 32)-float
        # blocks per tile whether used or not — so the program runs at
        # next-pow2(count · 1.5) with sensible floors; a camera sweep
        # that exceeds them regrows through the deferred-overflow
        # rebuild below (one recompile, never a wrong frame beyond the
        # OVERFLOW_MAX_LAG under-population window).
        self._caps = {
            "capacity": _fit_capacity(
                stats.get("max_tile_entries", renderer.tile_capacity),
                FIT_FLOORS[0], renderer.tile_capacity,
            ),
            "global_capacity": _fit_capacity(
                stats.get("global_triangles", renderer._global_capacity),
                FIT_FLOORS[1], renderer._global_capacity,
            ),
            "tile_global_capacity": _fit_capacity(
                stats.get(
                    "max_tile_globals", renderer._tile_global_capacity
                ),
                FIT_FLOORS[2], renderer._tile_global_capacity,
            ),
            "clip_pool": _fit_capacity(
                stats.get("near_plane_crossings", renderer._clip_pool),
                FIT_FLOORS[3], renderer._clip_pool,
            ),
        }
        self._pending = []
        self._frame = 0
        #: Background fused-variant compilation (see _try_fused): the
        #: lock guards _fused_variants/_compiling against the worker
        #: threads; the generation counter invalidates workers that
        #: outlive a _build() rebuild.
        self._fuse_lock = threading.Lock()
        self._compiling = set()
        self._generation = 0
        self._build()

    def _build(self):
        renderer = self._renderer
        _, scene = renderer._scene_arrays(self._shapes)
        self._scene = scene
        self._seq = self._build_variant(self._opt_commands)
        # The program's observable spec is the sequential variant's
        # (fused ones differ only in command structure).
        self._spec = self._seq.spec
        #: grouping signature -> (plan, variant); rebuilt empty so new
        #: capacities apply to every future fused compile.  Mutated by
        #: the background compile workers under _fuse_lock; bumping the
        #: generation orphans workers from the previous build.
        with self._fuse_lock:
            self._generation += 1
            self._fused_variants = {}
            self._compiling = set()
        #: Derived-signature hit counts for the compile hysteresis in
        #: _try_fused (insertion-ordered, oldest evicted).
        self._sig_counts = {}
        self._plan = None
        if self._runs:
            plan = self._derive_plan(
                Renderer._pack_transforms(self._opt_commands)
            )
            if plan is not None:
                self._plan = plan
                variant = self._build_variant(plan.commands)
                with self._fuse_lock:
                    self._fused_variants[plan.signature] = (plan, variant)

    def _variant_spec(self, opt_commands) -> coverage.FrameSpec:
        """The FrameSpec one command-walk variant compiles against
        (shared by _build_variant and the plan_for_motion capacity
        scout)."""
        renderer = self._renderer
        scene = self._scene
        _, shape_index = renderer._unique_shapes(opt_commands)
        ops = tuple(int(c.operation) for c in opt_commands)
        cmd_shape = tuple(
            Renderer._cmd_shape_entry(c, shape_index)
            for c in opt_commands
        )
        paints = tuple(_spec_paint(c.color) for c in opt_commands)
        inst = tuple(c.n_instances for c in opt_commands)
        cmd_inst = inst if any(n != 1 for n in inst) else ()
        spec = renderer._spec(
            ops, cmd_shape, cmd_inst, scene, paints,
            commands=opt_commands,
        )
        spec = replace(spec, **self._caps)
        if self._uint8:
            spec = replace(spec, out_uint8=True)
        return spec

    def _build_variant(self, opt_commands) -> "_ProgramVariant":
        """Compile one command-walk variant (jit is lazy: a variant
        never dispatched never compiles)."""
        renderer = self._renderer
        scene = self._scene
        spec = self._variant_spec(opt_commands)
        prepare = coverage.make_prepare(spec)
        rasterize = coverage.make_rasterize(spec)

        def step(scene_arrays, transforms, desc_static, cmd_i, cmd_f,
                 desc_f, desc_i, paint_model):
            prepared = prepare(
                *scene_arrays, transforms, desc_static, paint_model
            )
            image = rasterize(prepared, cmd_i, cmd_f, desc_f, desc_i)
            return image, prepared.overflow

        def step_carry(carry, scene_arrays, transforms, desc_static,
                       cmd_i, cmd_f, desc_f, desc_i, paint_model):
            image, overflow = step(scene_arrays, transforms, desc_static,
                                   cmd_i, cmd_f, desc_f, desc_i,
                                   paint_model)
            # Fold the completion probe into the frame program: a real
            # data dependency per frame in ONE dispatch.
            probe = image[..., 3]
            if probe.dtype != jnp.float32:  # packed-uint8 programs
                probe = probe.astype(jnp.float32)
            return image, overflow, carry + jnp.sum(probe)

        def step_sequence(scene_arrays, transforms_seq, desc_static,
                          cmd_i, cmd_f, desc_f, desc_i, paint_model,
                          as_uint8):
            # One dispatch renders the whole (B, R, 4, 4) sequence via
            # lax.scan — per-frame launch overhead amortizes across B
            # frames; offline
            # animation rendering at device speed.
            def body(carry, tf):
                image, overflow = step(scene_arrays, tf, desc_static,
                                       cmd_i, cmd_f, desc_f, desc_i,
                                       paint_model)
                if image.dtype == jnp.uint8:  # kernel-packed already
                    out = image
                else:
                    out = Renderer._quantize(image) if as_uint8 else image
                return jnp.maximum(carry, overflow), out

            worst, frames = jax.lax.scan(
                body, jnp.zeros((4,), jnp.int32), transforms_seq
            )
            return frames, worst

        v = _ProgramVariant()
        v.spec = spec
        v.opt_commands = opt_commands
        v.step = jax.jit(step)
        v.step_carry = jax.jit(step_carry)
        v.step_sequence = jax.jit(
            step_sequence, static_argnames=("as_uint8",)
        )
        v.paint_model = Renderer._pack_paints(opt_commands)
        # cmd_f carries the blend constant (if the state uses one) as a
        # runtime column; _refresh_cmd_f re-packs it per call when
        # Renderer.set_blend_constant changed it — wgpu's dynamic
        # render-pass state (renderer.rs:381 + RenderPass::
        # set_blend_constant), no retrace (same shapes).
        v.packed_constant = renderer._blend_constant_arg()
        cmd_i, cmd_f = Renderer._pack_commands_runtime(
            opt_commands, v.packed_constant
        )
        v.cmd_i = jnp.asarray(cmd_i)
        v.cmd_f = jnp.asarray(cmd_f)
        return v

    def _variants(self):
        # Snapshot under the lock: background compile workers install
        # entries concurrently, and iterating the live dict would raise
        # "dictionary changed size during iteration" mid-animation.
        with self._fuse_lock:
            fused = tuple(v for _, v in self._fused_variants.values())
        return (self._seq,) + fused

    def _ensure_constant(self, v):
        """Re-pack one variant's cmd_f when the renderer's blend
        constant changed since its last pack (tiny host-side numpy; the
        compiled program takes cmd_f as a runtime input, so animating
        the constant never rebuilds or retraces)."""
        constant = self._renderer._blend_constant_arg()
        if constant != v.packed_constant:
            v.packed_constant = constant
            _, cmd_f = Renderer._pack_commands_runtime(
                v.opt_commands, constant
            )
            v.cmd_f = jnp.asarray(cmd_f)

    def _refresh_cmd_f(self):
        for v in self._variants():
            self._ensure_constant(v)

    def _escape_allowed(self, r) -> bool:
        """Whether the uniform-opaque-color overlap escape (see
        _run_overlap_escape) may apply to run ``r`` under this
        renderer's pipeline state: idempotent blend, no depth
        test/write, and winding headroom for the summed instances."""
        config = self._renderer.config
        return (
            r.escape
            and _idempotent_blend(config.blending)
            and config.depth_compare == "always"
            and not config.depth_write_enabled
            and len(r.pairs)
            <= (1 << (config.winding_counter_bits - 1)) - 1
        )

    @staticmethod
    def _rows_equal(transforms, srows, crows) -> bool:
        return np.array_equal(transforms[srows], transforms[crows])

    def _derive_plan(self, transforms):
        """Grouping of every structural run under the given opt-layout
        transforms → a _FusionPlan, or None when nothing fuses.

        Runs eligible for the overlap escape fuse whole (one instanced
        draw) whenever every projection is well-defined with uniform
        orientation parity; other runs group greedily by exact cover
        disjointness (the _fuse_instance_runs rule on runtime values).
        """
        groupings = []
        for r in self._runs:
            boxes, ok, polys = _run_boxes(
                r.shape, transforms[r.stencil_rows]
            )
            # Pairs whose stencil and cover rows differ can never fuse
            # (a fused draw shares one transform row per instance).
            for k, (s, c) in enumerate(
                zip(r.stencil_rows, r.cover_rows)
            ):
                if ok[k] and not np.array_equal(
                    transforms[s], transforms[c]
                ):
                    ok[k] = False
            if self._escape_allowed(r) and ok.all():
                signs = _poly_orientation_signs(polys)
                if signs[0] != 0.0 and np.all(signs == signs[0]):
                    groupings.append(
                        ((tuple(range(len(r.pairs))),), True)
                    )
                    continue
            groupings.append((_greedy_box_groups(boxes, ok, polys), False))
        return _plan_for_groups(self._opt_commands, self._runs, groupings)

    def _plan_transforms_if_valid(self, plan, transforms):
        """The fused-layout transform stack when this frame's
        transforms keep ``plan`` pixel-exact, else None.

        Escape groups (uniform opaque color) need equal stencil/cover
        rows, well-defined projections, and uniform orientation parity;
        disjointness groups additionally need pairwise-disjoint cover
        polygons (the _fuse_instance_runs soundness rule, re-checked
        per frame under camera motion)."""
        for shape, srows, crows, escape in plan.groups:
            if not self._rows_equal(transforms, srows, crows):
                return None
            boxes, ok, polys = _run_boxes(shape, transforms[srows])
            if not ok.all():
                return None
            if escape:
                signs = _poly_orientation_signs(polys)
                if signs[0] == 0.0 or not np.all(signs == signs[0]):
                    return None
                continue
            disjoint = (
                (boxes[:, None, 2] < boxes[None, :, 0])
                | (boxes[None, :, 2] < boxes[:, None, 0])
                | (boxes[:, None, 3] < boxes[None, :, 1])
                | (boxes[None, :, 3] < boxes[:, None, 1])
            )
            np.fill_diagonal(disjoint, True)
            if not disjoint.all():
                # AABB contact: the covers themselves (hull polygons)
                # may still be apart — exact SAT on the touching pairs.
                for i, j in zip(*np.nonzero(~disjoint)):
                    if i < j and not _convex_polys_disjoint(
                        polys[i], polys[j]
                    ):
                        return None
        return np.ascontiguousarray(transforms[plan.gather])

    #: Distinct fused groupings compiled per program (compiles happen
    #: on background threads; see _try_fused).  Camera motion that
    #: keeps re-grouping the scene past this many variants stays on
    #: the sequential walk.
    MAX_FUSED_VARIANTS = 8

    def _try_fused(self, transforms):
        """(variant, fused-layout transforms) for this frame, or None
        to dispatch the sequential walk.

        A frame NEVER blocks on an XLA compile here: the active plan
        re-validates against the frame's transforms; when motion breaks
        its grouping, the other cached groupings are validated (cheap
        host-side hull SAT), and only if none holds is a fresh greedy
        grouping derived and handed to a BACKGROUND compile thread —
        the frame itself dispatches the sequential walk.  Once the
        worker finishes, the grouping serves future frames from the
        cache, so oscillating cameras converge onto a small compiled
        set.  (Compiling synchronously on every grouping change would
        land fresh compiles inside the animation.)"""
        if self._plan is not None:
            tf = self._plan_transforms_if_valid(self._plan, transforms)
            if tf is not None:
                with self._fuse_lock:
                    hit = self._fused_variants.get(self._plan.signature)
                if hit is not None:
                    return hit[1], tf
        with self._fuse_lock:
            cached = list(self._fused_variants.values())
            room = (
                len(self._fused_variants) + len(self._compiling)
                < self.MAX_FUSED_VARIANTS
            )
        for plan, variant in cached:
            if plan is self._plan:
                continue
            tf = self._plan_transforms_if_valid(plan, transforms)
            if tf is not None:
                self._plan = plan
                return variant, tf
        self._plan = None
        if not room:
            return None
        plan = self._derive_plan(transforms)
        if plan is None:
            return None
        # Compile hysteresis: continuous camera motion derives a FRESH
        # grouping almost every frame; compiling each one floods the
        # compile service and the host while the animation runs.  A
        # grouping must be derived twice in the recent window
        # before it earns a background compile — static or oscillating
        # cameras converge in two frames, sweeps stay sequential (use
        # plan_for_motion to pre-compile one grouping valid across a
        # whole camera path).
        sig = plan.signature
        count = self._sig_counts.get(sig, 0) + 1
        self._sig_counts[sig] = count
        if len(self._sig_counts) > 64:
            self._sig_counts.pop(next(iter(self._sig_counts)))
        if count < 2:
            return None
        self._spawn_fused_compile(plan, transforms)
        return None

    def _spawn_fused_compile(self, plan, transforms):
        """Compile ``plan``'s variant on a daemon thread and install it
        in the grouping cache when done.  The worker warms the jit by
        dispatching one frame with this frame's inputs (discarded);
        concurrent in-process dispatch is ordinary JAX async execution.
        A _build() rebuild bumps the generation, orphaning workers whose
        variant was compiled against the previous capacities."""
        with self._fuse_lock:
            if (
                plan.signature in self._compiling
                or plan.signature in self._fused_variants
                or len(self._fused_variants) + len(self._compiling)
                >= self.MAX_FUSED_VARIANTS
            ):
                return
            self._compiling.add(plan.signature)
            generation = self._generation
        variant = self._build_variant(plan.commands)
        renderer = self._renderer
        desc_f, desc_i = Renderer._pack_descriptors(self._shapes)
        desc_static = np.ascontiguousarray(desc_i[:, [9, 8]])
        args = (
            self._scene.arrays,
            np.ascontiguousarray(transforms[plan.gather]),
            renderer._dev_cached("fp_desc_static", desc_static),
            variant.cmd_i,
            variant.cmd_f,
            renderer._dev_cached("fp_desc_f", desc_f),
            renderer._dev_cached("fp_desc_i", desc_i),
            (
                None
                if variant.paint_model is None
                else renderer._dev_cached("fp_paints", variant.paint_model)
            ),
        )

        def work():
            try:
                image, overflow = variant.step(*args)
                jax.block_until_ready(image)
            except Exception:
                logging.getLogger(__name__).exception(
                    "background fused-variant compile failed; the "
                    "grouping stays on the sequential walk"
                )
                with self._fuse_lock:
                    self._compiling.discard(plan.signature)
                return
            with self._fuse_lock:
                self._compiling.discard(plan.signature)
                if self._generation == generation:
                    self._fused_variants[plan.signature] = (plan, variant)

        threading.Thread(
            target=work, name="fused-variant-compile", daemon=True
        ).start()

    def plan_for_motion(self, transforms_seq, wait=True, timeout=600.0):
        """Derive + compile ONE fused grouping that stays pixel-exact
        across every transform stack of ``transforms_seq`` (the frames
        of a camera path), and make it the active plan.

        Continuous camera motion re-groups a scene almost every frame,
        and per-frame groupings would each need their own compile (the
        hysteresis in _try_fused therefore keeps sweeps on the
        sequential walk).  Here the grouping is derived from the WHOLE
        motion — pairs fuse only where their covers are disjoint (or
        the opaque-overlap escape holds) in every given frame — so one
        compiled variant serves the whole path.  Per-frame dispatch
        still re-validates pixel-exactness, so motion beyond the
        scouted path degrades to the sequential walk, never to a wrong
        frame.  This is the analogue of the reference's
        single unconditional instanced draw across its camera orbit
        (examples/showcase/main.rs:236-250, 255-274).

        ``transforms_seq``: iterable of (R, 4, 4) stacks in the public
        (pre-fusion) layout, like ``__call__``.  Returns True when a
        fused plan is active and compiled (when ``wait``); False when
        nothing fuses across the motion."""
        if not self._runs:
            return False
        stacks = []
        for t in transforms_seq:
            t = np.ascontiguousarray(t, np.float32).reshape(-1, 4, 4)
            if self._keep_rows is not None:
                t = t[self._keep_rows]
            stacks.append(t)
        if not stacks:
            return False
        groupings = []
        for r in self._runs:
            per = [
                _run_boxes(r.shape, t[r.stencil_rows]) for t in stacks
            ]
            ok_all = np.logical_and.reduce([ok for _, ok, _ in per])
            for k, (s, c) in enumerate(
                zip(r.stencil_rows, r.cover_rows)
            ):
                if ok_all[k] and not all(
                    np.array_equal(t[s], t[c]) for t in stacks
                ):
                    ok_all[k] = False
            if self._escape_allowed(r) and ok_all.all():
                sign_ok = True
                for _, _, polys in per:
                    signs = _poly_orientation_signs(polys)
                    if signs[0] == 0.0 or not np.all(signs == signs[0]):
                        sign_ok = False
                        break
                if sign_ok:
                    groupings.append(
                        ((tuple(range(len(r.pairs))),), True)
                    )
                    continue
            groupings.append(
                (
                    _greedy_box_groups_multi(
                        [(boxes, polys) for boxes, _, polys in per],
                        ok_all,
                    ),
                    False,
                )
            )
        plan = _plan_for_groups(self._opt_commands, self._runs, groupings)
        if plan is None:
            return False
        # ---- capacity scout across the whole motion ------------------
        # Near-plane-crossing frames clip triangles into the pool and
        # spread huge covers across many tiles; discovering each
        # overflow mid-animation costs a rebuild + foreground recompile
        # per growth.  Scout the binning
        # over the whole path with a prepare-only executor and converge
        # the capacities BEFORE the expensive fused compile — the
        # motion then animates growth-free.
        renderer = self._renderer
        desc_f, desc_i = Renderer._pack_descriptors(self._shapes)
        desc_static = np.ascontiguousarray(desc_i[:, [9, 8]])
        paint_model = Renderer._pack_paints(plan.commands)
        stride = max(1, len(stacks) // 128)
        names = (
            "capacity", "global_capacity", "tile_global_capacity",
            "clip_pool",
        )
        grew_any = False
        for _scout_round in range(6):
            spec = self._variant_spec(plan.commands)
            prep = jax.jit(coverage.make_prepare(spec))
            ds = renderer._dev_cached("fp_desc_static", desc_static)
            pm = (
                None
                if paint_model is None
                else renderer._dev_cached("fp_paints", paint_model)
            )
            overflows = [
                prep(
                    *self._scene.arrays,
                    np.ascontiguousarray(t[plan.gather]), ds, pm,
                ).overflow
                for t in stacks[::stride]
            ]
            worst = np.max(
                np.stack([np.asarray(o) for o in overflows]), axis=0
            )
            grew = False
            for i, name in enumerate(names):
                if int(worst[i]) > self._caps[name]:
                    # Exact fit (pow2-rounded): the scout already saw
                    # the whole path's true worst, and per-tile
                    # capacity is DMA'd every grid step — headroom
                    # here would slow every frame of the motion.
                    self._caps[name] = _next_pow2(int(worst[i]))
                    grew = True
            if not grew:
                break
            renderer._grow_capacities(
                worst,
                (
                    renderer.tile_capacity,
                    renderer._global_capacity,
                    renderer._tile_global_capacity,
                    renderer._clip_pool,
                ),
            )
            grew_any = True
        if grew_any:
            self._build()
        self._plan = plan
        with self._fuse_lock:
            have = plan.signature in self._fused_variants
            if not have and (
                len(self._fused_variants) + len(self._compiling)
                >= self.MAX_FUSED_VARIANTS
            ):
                # An explicit motion plan outranks incidentally-cached
                # groupings: evict the oldest to make room.
                for key in list(self._fused_variants):
                    if key != plan.signature:
                        del self._fused_variants[key]
                        break
        if not have:
            self._spawn_fused_compile(plan, stacks[0])
        if wait:
            return self.wait_fused_compiles(timeout=timeout)
        return True

    def wait_fused_compiles(self, timeout=None):
        """Block until no background fused-variant compile is in
        flight (bounded by ``timeout`` seconds when given).  Benchmark
        harnesses and apps that want jank-free steady state call this
        after a scouting pass over their animation so every grouping
        the motion visits is compiled before timing starts."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._fuse_lock:
                busy = bool(self._compiling)
            if not busy:
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.01)

    #: Frames an unconsumed overflow counter may age before the host
    #: blocks on it.  Overflow only fires when a moving scene outgrows
    #: converged capacities; forcing the fetch every frame serializes
    #: the pipeline on a device round trip, so the fetch is taken when the async copy has
    #: landed and only *forced* after this many frames of lag — the
    #: deferred-capacity contract renders at most this many
    #: under-populated frames while growing.
    OVERFLOW_MAX_LAG = 16

    def _sync(self):
        """Per-call maintenance shared by __call__ and render_sequence:
        consume landed overflow counters (lag-bounded, non-blocking
        while the async copies are in flight) and refresh the scene
        after geometry edits; either may rebuild the program."""
        renderer = self._renderer
        grew = False
        keep = []
        names = (
            "capacity", "global_capacity", "tile_global_capacity",
            "clip_pool",
        )
        for overflow_arr, born in self._pending:
            ready = getattr(overflow_arr, "is_ready", lambda: True)()
            if ready or self._frame - born >= self.OVERFLOW_MAX_LAG:
                worst = np.asarray(overflow_arr)
                # Grow the program's own (shrunk-to-fit) capacities;
                # the renderer's floor capacities grow alongside so a
                # future program settles at the converged sizes.
                for i, name in enumerate(names):
                    if int(worst[i]) > self._caps[name]:
                        # ×2 headroom: a camera sweep that overflowed
                        # once tends to keep growing frame by frame,
                        # and every growth is a rebuild + recompile.
                        self._caps[name] = _next_pow2(int(worst[i]) * 2)
                        grew = True
                renderer._grow_capacities(
                    worst,
                    (
                        renderer.tile_capacity,
                        renderer._global_capacity,
                        renderer._tile_global_capacity,
                        renderer._clip_pool,
                    ),
                )
            else:
                keep.append((overflow_arr, born))
        self._pending = keep
        if grew:
            self._build()

        # Geometry edits (Shape.update_paths) re-enter through the
        # scene cache; a changed padded size rebuilds the program.
        _, scene = renderer._scene_arrays(self._shapes)
        if (scene.t_max, scene.h_max) != (
            self._scene.t_max, self._scene.h_max
        ):
            self._scene = scene
            self._build()
        else:
            self._scene = scene

    def __call__(self, transforms=None, carry=None):
        """Render one frame; returns the device-resident (H, W, 4)
        image.  `transforms`: an (R, 4, 4) row-major model→clip stack
        with one row per (command, instance) draw — R equals the sum of
        the commands' instance counts (defaults to the commands' stored
        transforms).

        `carry`: optional scalar; when given, returns ``(image, carry +
        sum(image[..., 3]))`` computed in the same dispatch — a
        per-frame completion probe with no extra program launch (a
        throughput harness chains it and fetches once at the end).
        """
        renderer = self._renderer
        if transforms is None:
            transforms = Renderer._pack_transforms(self._opt_commands)
        else:
            transforms = np.ascontiguousarray(
                transforms, np.float32
            ).reshape(-1, 4, 4)
            # Validate against the PUBLIC (pre-fusion) layout before the
            # keep_rows gather — a too-long stack would otherwise index
            # in range and silently render with misattributed rows.
            expected = sum(c.n_instances for c in self._commands)
            if transforms.shape[0] != expected:
                raise ValueError(
                    f"expected {expected} transform rows (one per "
                    f"command instance, pre-fusion), got "
                    f"{transforms.shape[0]}"
                )
            if self._keep_rows is not None:
                # Drop the rows of fused-away SAVE covers so the stack
                # matches the optimized draw layout.
                transforms = transforms[self._keep_rows]
        require_finite(transforms, "frame transforms")
        self._frame += 1
        self._sync()
        self._refresh_cmd_f()
        variant = self._seq
        if self._runs:
            fused = self._try_fused(transforms)
            if fused is not None:
                variant, transforms = fused
        # A worker can install a fused variant between _refresh_cmd_f
        # and _try_fused; never dispatch one whose blend constant is
        # the value captured at spawn time.
        self._ensure_constant(variant)
        desc_f, desc_i = Renderer._pack_descriptors(self._shapes)
        desc_static = np.ascontiguousarray(desc_i[:, [9, 8]])
        args = (
            self._scene.arrays,
            transforms,
            renderer._dev_cached("fp_desc_static", desc_static),
            variant.cmd_i,
            variant.cmd_f,
            renderer._dev_cached("fp_desc_f", desc_f),
            renderer._dev_cached("fp_desc_i", desc_i),
            (
                None
                if variant.paint_model is None
                else renderer._dev_cached("fp_paints", variant.paint_model)
            ),
        )
        if carry is None:
            image, overflow = variant.step(*args)
        else:
            image, overflow, carry = variant.step_carry(
                jnp.asarray(carry, jnp.float32), *args
            )
        try:
            overflow.copy_to_host_async()
        except AttributeError:
            pass
        self._pending.append((overflow, self._frame))
        return image if carry is None else (image, carry)

    def render_sequence(self, transforms, as_uint8: bool = True):
        """Render a whole animation segment in ONE device dispatch.

        ``transforms``: (B, R, 4, 4) — one transform stack per frame
        (same per-frame layout as ``__call__``).  Returns the (B, H, W,
        4) device array, uint8 by default (a 4K f32 frame is 132 MB;
        quantizing in the scan keeps B frames resident at 1/4 the HBM
        and the host fetch 4x smaller).

        The per-frame dispatch of ``__call__`` costs a host↔device
        round trip per frame; here that overhead amortizes over B frames (`lax.scan` inside the jit), which is
        the throughput mode for offline/batch animation rendering.
        Binning overflow is reduced (max) across the segment and
        consumed by the same deferred-growth machinery.
        """
        renderer = self._renderer
        transforms = np.ascontiguousarray(transforms, np.float32)
        if transforms.ndim != 4:
            transforms = transforms.reshape(
                len(transforms), -1, 4, 4
            )
        expected = sum(c.n_instances for c in self._commands)
        if transforms.shape[1] != expected:
            raise ValueError(
                f"expected {expected} transform rows per frame (one per "
                f"command instance, pre-fusion), got "
                f"{transforms.shape[1]}"
            )
        if self._keep_rows is not None:
            transforms = transforms[:, self._keep_rows]
        require_finite(transforms, "sequence transforms")
        self._frame += len(transforms)
        self._sync()
        self._refresh_cmd_f()
        variant = self._seq
        if self._runs and self._plan is not None:
            # One program renders the whole scan, so the active fused
            # plan dispatches only when EVERY frame of the segment
            # validates under it.
            fused_frames = [
                self._plan_transforms_if_valid(self._plan, t)
                for t in transforms
            ]
            with self._fuse_lock:
                hit = self._fused_variants.get(self._plan.signature)
            if hit is not None and all(f is not None for f in fused_frames):
                variant = hit[1]
                transforms = np.ascontiguousarray(
                    np.stack(fused_frames)
                )
        self._ensure_constant(variant)
        desc_f, desc_i = Renderer._pack_descriptors(self._shapes)
        desc_static = np.ascontiguousarray(desc_i[:, [9, 8]])
        frames, overflow = variant.step_sequence(
            self._scene.arrays,
            transforms,
            renderer._dev_cached("fp_desc_static", desc_static),
            variant.cmd_i,
            variant.cmd_f,
            renderer._dev_cached("fp_desc_f", desc_f),
            renderer._dev_cached("fp_desc_i", desc_i),
            (
                None
                if variant.paint_model is None
                else renderer._dev_cached("fp_paints", variant.paint_model)
            ),
            as_uint8=bool(as_uint8),
        )
        try:
            overflow.copy_to_host_async()
        except AttributeError:
            pass
        self._pending.append((overflow, self._frame))
        return frames
