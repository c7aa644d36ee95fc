"""The frame executor: tile-resident stencil-and-cover.

This replaces the reference's whole GPU runtime — the 14 wgpu render
pipelines (renderer.rs:593-861), the stencil winding/clip algebra
(renderer.rs:565-582, 692-729), the cover blend states
(renderer.rs:736-861) and the per-sample fragment predicates
(shaders.wgsl:155-300) — with software binning and one raster kernel.

Architecture (two stages, both jitted):

1. ``prepare`` (plain XLA): transforms every stencil command's triangle
   table by its instance matrix (batched, full f32), computes
   screen-space edge/interpolation coefficients, and **bins** triangles
   to pixel tiles.  Binning classifies every (triangle, tile) pair by
   evaluating the three edge functions at the tile corners:

   - *reject* (tile fully outside an edge) — dropped,
   - *trivial accept* of a SOLID triangle (tile fully inside all
     edges) — folded into a per-(tile, command) scalar ``bulk``
     winding delta, so the interiors of large cover fans cost one
     vector add instead of per-sample edge tests,
   - otherwise — an *entry* in the tile's triangle list.

   Small triangles are enumerated directly over their (few) covered
   tiles and compacted by a stable sort; triangles spanning more tiles
   than the slot budget go through a dense (tiles × globals) matrix
   (their count is small — they are the big fans).  Convex-hull cover
   commands get the same corner classification per tile
   (skip / boundary / fully-inside).

2. ``rasterize`` (Pallas through Triton): one program per tile.  The
   per-sample frame state — winding counter, clip depth, premultiplied
   RGBA, alpha layers, depth — is the register-resident carry of the
   *whole command walk*; only the resolved tile is written to device
   memory.  Per tile the kernel walks the active-unit list; stencil
   commands loop over the tile's binned triangle entries (stroke entries
   before fill entries, preserving the reference's draw order,
   renderer.rs:275-336) and evaluate the implicit-curve / dash / cap /
   joint predicates exactly as shaders.wgsl does; cover commands apply
   the winding rule inside the hull and composite/clip/save alpha per the
   reference's stencil and blend states.  `ops/reference.py` runs the
   same walk as plain XLA over all tiles at once.

All arithmetic on the coverage path is explicit f32 multiply-add — the
Loop-Blinn predicates are cancellation sensitive and reduced-precision
(TF32/bf16) products visibly corrupt them.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..path import MAX_DASH_INTERVALS, Cap, Join
from ..vertex import (
    KIND_INTEGRAL_CUBIC,
    KIND_INTEGRAL_QUADRATIC,
    KIND_RATIONAL_CUBIC,
    KIND_RATIONAL_QUADRATIC,
    KIND_SOLID,
    KIND_STROKE_JOINT,
    KIND_STROKE_LINE,
)

TAU = 2.0 * math.pi

OP_STENCIL = 0
OP_CLIP = 1
OP_UNCLIP = 2
OP_COLOR = 3
OP_SAVE_ALPHA = 4
OP_SCALE_ALPHA = 5
OP_RESTORE_ALPHA = 6
#: Fused SAVE then SCALE over the same hull (renderer._optimize_commands):
#: the alpha-group prologue is always this adjacent pair on one cover, and
#: one fused full-screen pass costs half the per-sample traffic of two.
OP_SAVE_SCALE = 7

#: Gradient stop budget (cmd_f row: MAX_STOPS RGBA colors + MAX_STOPS
#: offsets; see renderer.MAX_GRADIENT_STOPS).
MAX_STOPS = 4

#: Standard MSAA sample positions (x, y) within a pixel, y-down.
SAMPLE_PATTERNS = {
    1: np.array([[0.5, 0.5]], np.float32),
    2: np.array([[0.75, 0.75], [0.25, 0.25]], np.float32),
    4: np.array(
        [[0.375, 0.125], [0.875, 0.375], [0.125, 0.625], [0.625, 0.875]],
        np.float32,
    ),
    8: np.array(
        [
            [0.5625, 0.3125], [0.4375, 0.6875], [0.8125, 0.5625],
            [0.3125, 0.1875], [0.1875, 0.8125], [0.0625, 0.4375],
            [0.6875, 0.9375], [0.9375, 0.0625],
        ],
        np.float32,
    ),
    16: np.array(
        [
            [0.5625, 0.5625], [0.4375, 0.3125], [0.3125, 0.625],
            [0.75, 0.4375], [0.1875, 0.375], [0.625, 0.8125],
            [0.8125, 0.6875], [0.6875, 0.1875], [0.375, 0.875],
            [0.5, 0.0625], [0.25, 0.125], [0.125, 0.75],
            [0.03125, 0.5], [0.9375, 0.25], [0.875, 0.9375],
            [0.0625, 0.03125],
        ],
        np.float32,
    ),
}

# Float row layout (one packed row per screen-space triangle).
RF_EDGE = 0        # 0..8: (a, b, c) × 3 oriented edges (inside ⇒ e ≥ 0)
RF_INV_AREA = 9    # 1/|pixel area| (λ_k = ẽ_k · invA)
RF_AW = 10         # 10..21: aux·(1/w), vertex paired with edge k
RF_IW = 22         # 22..24: 1/w, vertex paired with edge k
RF_END_Y = 25      # end-cap provoking texcoord.y
RF_AABB = 26       # 26..29: pixel-space min_x, min_y, max_x, max_y
D_F = 32

# Int row layout.
RI_KIND = 0
RI_CONTRIB = 1
RI_GROUP = 2
RI_FLAGS = 3       # bits 0..2 top-left edge rule, 3 end-cap, 4 joint tip
RI_FILL = 4        # 1 for fill kinds, 0 for strokes
RI_CMD = 5         # originating command index
RI_CLASS = 6       # processing class (CLS_*)
D_I = 8

#: Entries are range-sorted per (tile, command, class) so the kernel
#: runs a specialized, branch-free body per class.  Stroke entries are
#: additionally split by their group's dash mode (solid /
#: single-interval / multi-interval) so no per-entry runtime branch is
#: needed to pick the dash predicate; stroke classes sort before fill
#: classes, preserving the reference's draw order (renderer.rs:275-336).
CLS_LINE_SOLID = 0
CLS_LINE_DASH1 = 1
CLS_LINE_DASHN = 2
CLS_JOINT_SOLID = 3
CLS_JOINT_DASH1 = 4
CLS_JOINT_DASHN = 5
CLS_FILL_SOLID = 6
CLS_FILL_QUAD = 7
CLS_FILL_CUBIC = 8
N_CLASSES = 9
#: Default fill batch: fill entries evaluated per walk iteration (their
#: coefficient loads issue together).  FrameSpec.fill_batch overrides
#: per frame program.
NB = 2
#: Warps per tile program (Triton num_warps; 4 beat 8 on the 1080p
#: showcase, see PERF.md).
NUM_WARPS = 4

FLAG_END_CAP = 8
FLAG_JOINT_TIP = 16

# Descriptor row layout (global dynamic-stroke table).
# floats: 0..3 gap_start, 4..7 gap_end, 8 phase
# ints:   0..3 end_caps, 4..7 start_caps, 8 last_interval, 9 dashed,
#         10 join, 11 solid_start_cap, 12 solid_end_cap
DESC_F = 12
DESC_I = 16


@dataclass(frozen=True)
class FrameSpec:
    """Static signature of a frame program.

    ``ops`` / ``cmd_shape`` / ``cmd_inst`` fix the command structure;
    everything that animates per frame (transforms, colors, clip
    depths, dash descriptors) stays a runtime input, so re-rendering
    with new values reuses the compiled program.
    """

    width: int
    height: int
    ops: tuple            # per-command RenderOperation ints
    #: Per-command shape index — an int shared by the command's
    #: instances, or a per-INSTANCE tuple of shape indices (one draw
    #: stream over many vertex buffers: the reference's per-glyph
    #: buffers under one instanced pipeline, renderer.rs:462-466 +
    #: text.rs:97-104).  A multi-shape stencil command walks as ONE
    #: unit with contiguous per-tile entry ranges — monolith-speed
    #: batching with per-shape geometry reuse.
    cmd_shape: tuple
    n_shapes: int
    t_max: int            # padded triangle count per shape
    h_max: int            # padded hull vertex count per shape
    samples: int
    winding_bits: int
    n_layers: int
    #: Named mode ("back_to_front" / "front_to_back" / "additive") or a
    #: canonical BlendState tuple ((src, op, dst), (src, op, dst)) for
    #: color/alpha — see renderer.BlendState (reference renderer.rs:381).
    blending: object
    #: Per-command instance counts (the reference's instance_range,
    #: renderer.rs:267, 462-466): a stencil command accumulates winding
    #: from all its instances' triangles; a cover command replays its
    #: per-instance hull covers in instance order.  () = all 1.
    cmd_inst: tuple = ()
    #: Per-command paint kinds (0 solid, 1 linear gradient, 2 radial
    #: gradient).  () = all solid; any nonzero compiles the gradient
    #: interpolation into the color cover (an extension — the
    #: reference's color cover is always solid, shaders.wgsl:304-309,
    #: and custom paints require user shaders).
    paints: tuple = ()
    #: Depth compare function of the color cover (wgpu CompareFunction;
    #: reference Configuration.depth_compare, renderer.rs:387-390).  In
    #: the reference ONLY the color cover pipeline carries the
    #: configured depth state — every other pipeline is Always/no-write
    #: (renderer.rs:601-841) — so stencil/clip/alpha ops here never
    #: touch the depth buffer either.  "always" + no write (the
    #: default) compiles the depth machinery out entirely.
    depth_compare: str = "always"
    #: Whether the color cover writes back fragment depth (wgpu
    #: depth_write_enabled, renderer.rs:389-390).
    depth_write: bool = False
    #: Resolve straight to packed RGBA8 in the kernel: each tile writes
    #: one int32 per pixel (R | G<<8 | B<<16 | A<<24, i.e. RGBA8
    #: little-endian — the reference presents to an 8-bit swapchain
    #: surface the same way) at its final mosaic position, so the
    #: float de-tiling transpose, the separate quantize pass, and 3/4
    #: of the output HBM traffic disappear.  Bit-identical to
    #: Renderer._quantize of the float output.
    out_uint8: bool = False
    #: Tile size in pixels (powers of two: Triton arrays are).  One
    #: tile is one kernel program; its per-sample state is the walk's
    #: register carry, so the tile is sized for registers.
    tile_h: int = 16
    tile_w: int = 32
    capacity: int = 256             # per-tile local entry rows
    global_capacity: int = 2048     # big-triangle rows
    tile_global_capacity: int = 128  # per-tile big-triangle entries
    clip_pool: int = 64             # near-plane-crossing triangle slots
    slots_x: int = 2
    slots_y: int = 2
    fill_batch: int = NB            # fill entries evaluated per step
    stroke_batch: int = 1           # stroke entries evaluated per step
    #: Clip/alpha bracket gating (renderer._gate_spans): tuples of
    #: ``(content_units, machinery_units, row_pairs)`` — per outermost
    #: balanced clip/alpha bracket, the FRAME-wide non-machinery unit
    #: indices whose per-tile activity marks the tile as touched, the
    #: machinery unit indices (clip stencils, CLIP/UNCLIP covers,
    #: SAVE/SCALE/RESTORE covers) to drop from untouched tiles, and
    #: the transform-row index pairs that must compare equal at
    #: runtime for the bracket's opener/closer hulls to coincide
    #: (checked traced in `prepare`; unequal rows disable the span's
    #: gating that frame).  On an untouched tile frame alpha is
    #: exactly 0 and the complete bracket is BIT-exact identity on the
    #: color buffer — see renderer._gate_spans for the proof
    #: obligations — so dropping it usually leaves the tile on the
    #: acount == 0 empty fast path.  The reference gets the analogous
    #: saving from hardware early-stencil rejection
    #: (renderer.rs:692-729); a software per-tile walk bins it away.
    gate_spans: tuple = ()
    #: Whether any shape in the scene carries stroke descriptor groups.
    #: False compiles the six stroke classes out of the per-(tile,
    #: command) walk — a scene without stroke groups cannot produce
    #: stroke entries, and the empty-range prologue (two scalar range
    #: reads + a branch, × 6 classes × 2 walks, per active command per
    #: tile) is a real cost for many-command fill scenes (instanced
    #: text).
    has_strokes: bool = True
    interpret: bool = False

    def __post_init__(self):
        for name in ("tile_h", "tile_w"):
            v = getattr(self, name)
            if v < 1 or v & (v - 1):
                raise ValueError(f"{name}={v} must be a power of two")
        # Cache the hash: specs key executor caches and are hashed
        # several times per frame; cmd_shape alone can be a
        # 10k-instance tuple (multi-shape commands), making the
        # default dataclass hash a real per-frame cost.
        object.__setattr__(self, "_hash", None)

    def __hash__(self):
        h = self._hash
        if h is None:
            h = hash(tuple(
                getattr(self, f.name)
                for f in dataclasses.fields(self)
            ))
            object.__setattr__(self, "_hash", h)
        return h
    @property
    def n_commands(self):
        return len(self.ops)

    @property
    def ntx(self):
        return -(-self.width // self.tile_w)

    @property
    def nty(self):
        return -(-self.height // self.tile_h)

    @property
    def n_tiles(self):
        return self.ntx * self.nty


#: Named blend modes as canonical (src_factor, operation, dst_factor)
#: components, matching renderer.NAMED_BLEND_STATES.
_NAMED_BLEND = {
    "back_to_front": ("one", "add", "one_minus_src_alpha"),
    "front_to_back": ("one_minus_dst_alpha", "add", "one"),
    "additive": ("one", "add", "one"),
}


def _canonical_blend(blending):
    """spec.blending → (color_component, alpha_component) tuples."""
    if isinstance(blending, str):
        comp = _NAMED_BLEND[blending]
        return comp, comp
    color, alpha = blending
    return tuple(color), tuple(alpha)


def blend_uses_constant(blending) -> bool:
    """True when the blend state references the runtime blend-constant
    color (wgpu's set_blend_constant); the packer then appends the
    constant to cmd_f and the kernel reads it back."""
    color, alpha = _canonical_blend(blending)
    return any(
        f in ("constant", "one_minus_constant")
        for comp in (color, alpha)
        for f in (comp[0], comp[2])
    )


def _blend_channel(comp, s, d, ca, da, chan=0, const=None):
    """out = op(s·src_factor, d·dst_factor) for one channel, wgpu
    semantics (shaders are premultiplied; `min`/`max` ignore factors).

    `ca`: the draw's scalar source alpha; `da`: the destination alpha
    sampled before this draw touched any channel; `chan`: which channel
    (0-3 — src_alpha_saturated and the constant factors are
    channel-dependent); `const`: the 4 runtime blend-constant scalars
    (present iff the state uses constant factors)."""
    src_f, op, dst_f = comp
    if op == "min":
        return jnp.minimum(s, d)
    if op == "max":
        return jnp.maximum(s, d)

    def factor(name):
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
            # wgpu SrcAlphaSaturated: min(αs, 1−αd) on RGB, 1 on alpha.
            return jnp.minimum(ca, 1.0 - da) if chan < 3 else 1.0
        if name == "constant":
            return const[chan]
        if name == "one_minus_constant":
            return 1.0 - const[chan]
        raise ValueError(f"unknown blend factor {name!r}")

    st = s * factor(src_f) if src_f != "zero" else 0.0
    dt = d * factor(dst_f) if dst_f != "zero" else 0.0
    if op == "add":
        return st + dt
    if op == "subtract":
        return st - dt
    return dt - st  # reverse_subtract


class PreparedFrame(NamedTuple):
    """Device arrays produced by `prepare`, consumed by `rasterize`."""

    #: Per-tile entry rows: K local rows, then Kg big-triangle rows.
    tri_f: jnp.ndarray    # (n_tiles, K+Kg, D_F)
    tri_i: jnp.ndarray    # (n_tiles, K+Kg, D_I)
    off: jnp.ndarray      # (n_tiles, 9C+1) per-(cmd, class) local ranges
    g_off: jnp.ndarray    # (n_tiles, 9C+1) big-triangle ranges (from K)
    bulk: jnp.ndarray     # (n_tiles, C) trivially-accepted solid winding
    cls: jnp.ndarray      # (n_tiles, Rc) cover-draw class 0/1/2
    hbits: jnp.ndarray    # (n_tiles, Rc) crossing hull-line bitmask
    aclist: jnp.ndarray   # (n_tiles, U) active unit indices
    acount: jnp.ndarray   # (n_tiles,)
    hull_lines: jnp.ndarray  # (Rc, Hm, 4) inward-oriented pixel lines
    paint_xy: jnp.ndarray    # (Rc, 4) gradient endpoints in pixels
    zplane: jnp.ndarray      # (Rc, 3) NDC-z = a·px + b·py + c per draw
    overflow: jnp.ndarray    # (4,) max local count, global count,
    #                          max tile globals, near-plane crossings


# ---------------------------------------------------------------------------
# prepare: setup + binning (plain XLA)
# ---------------------------------------------------------------------------


class DrawTables(NamedTuple):
    """Static (compile-time) expansion of the command list into draws.

    A *draw* is one (command, instance) pair.  Stencil draws contribute
    triangle rows; cover draws contribute one hull cover each.  A *unit*
    is one kernel walk step in global draw order: a whole stencil
    command (all its instances' triangles share its entry ranges) or a
    single cover draw.
    """

    inst: np.ndarray        # (C,) per-command instance count
    row_base: np.ndarray    # (C+1,) transform-row offset per command
    s_cmd: np.ndarray       # (Rs,) stencil draw → command
    s_row: np.ndarray       # (Rs,) stencil draw → transform row
    c_cmd: np.ndarray       # (Rc,) cover draw → command
    c_row: np.ndarray       # (Rc,) cover draw → transform row
    unit_cmd: np.ndarray    # (U,) unit → command
    unit_draw: np.ndarray   # (U,) unit → cover draw (-1 for stencil)


def draw_tables(spec: FrameSpec) -> DrawTables:
    C = spec.n_commands
    ops = np.asarray(spec.ops, np.int32)
    inst = np.asarray(
        spec.cmd_inst if spec.cmd_inst else (1,) * C, np.int32
    )
    assert len(inst) == C and (inst >= 1).all()
    row_base = np.concatenate([[0], np.cumsum(inst)]).astype(np.int32)
    s_cmd, s_row, c_cmd, c_row = [], [], [], []
    unit_cmd, unit_draw = [], []
    for c in range(C):
        rows = range(int(row_base[c]), int(row_base[c + 1]))
        if ops[c] == OP_STENCIL:
            s_cmd += [c] * int(inst[c])
            s_row += list(rows)
            unit_cmd.append(c)
            unit_draw.append(-1)
        else:
            for r in rows:
                unit_cmd.append(c)
                unit_draw.append(len(c_cmd))
                c_cmd.append(c)
                c_row.append(r)
    # Bind a dummy draw where a table would be empty, so every kernel
    # operand has a row; no unit references it (the kernel reads stencil ranges only under
    # op == STENCIL and cover state only through unit_draw >= 0).
    if not s_cmd:
        s_cmd, s_row = [0], [0]
    if not c_cmd:
        c_cmd, c_row = [0], [0]
    i32 = np.int32
    return DrawTables(
        inst=inst,
        row_base=row_base,
        s_cmd=np.asarray(s_cmd, i32),
        s_row=np.asarray(s_row, i32),
        c_cmd=np.asarray(c_cmd, i32),
        c_row=np.asarray(c_row, i32),
        unit_cmd=np.asarray(unit_cmd, i32),
        unit_draw=np.asarray(unit_draw, i32),
    )


def _corner_min_max(a, b, c, x0, y0, tw, th):
    """Min/max of the linear function a·x+b·y+c over the tile rectangle
    [x0, x0+tw] × [y0, y0+th] (all broadcastable)."""
    base = a * x0 + b * y0 + c
    lo = base + jnp.minimum(a * tw, 0.0) + jnp.minimum(b * th, 0.0)
    hi = base + jnp.maximum(a * tw, 0.0) + jnp.maximum(b * th, 0.0)
    return lo, hi


def make_prepare(spec: FrameSpec):
    C = spec.n_commands
    draws = draw_tables(spec)
    # Per-draw shape indices (cmd_shape entries are per-command ints or
    # per-instance tuples).
    _row_base = draws.row_base

    def _shape_at(c, r):
        e = spec.cmd_shape[c]
        return e[r - _row_base[c]] if isinstance(e, (tuple, list)) else e

    s_shape_np = np.asarray(
        [_shape_at(c, r) for c, r in zip(draws.s_cmd, draws.s_row)],
        np.int32,
    )
    c_shape_np = np.asarray(
        [_shape_at(c, r) for c, r in zip(draws.c_cmd, draws.c_row)],
        np.int32,
    )
    Rs = len(draws.s_cmd)
    Rc = len(draws.c_cmd)
    U = len(draws.unit_cmd)
    T = spec.t_max
    Hm = spec.h_max
    W, H = spec.width, spec.height
    tw, th = spec.tile_w, spec.tile_h
    ntx, nty, n_tiles = spec.ntx, spec.nty, spec.n_tiles
    K = spec.capacity
    G = spec.global_capacity
    Kg = spec.tile_global_capacity
    mx, my = spec.slots_x, spec.slots_y
    M = mx * my
    def prepare(xy, aux, kind, meta, gbase, hull, transforms, desc_static,
                paint_model=None):
        """xy (Ns,T,3,2) aux (Ns,T,3,4) kind (Ns,T) meta (Ns,T,2)
        gbase (Ns,) hull (Ns,Hm,2) transforms (R,4,4) — one row per
        (command, instance) draw, commands in order
        (see DrawTables / FrameSpec.cmd_inst);
        desc_static (n_groups, 2) = [dashed, last_interval] per stroke
        group — determines each stroke entry's dash class so the kernel
        dispatches statically (re-binning when a pattern's interval
        count changes; phase/gap animation stays runtime);
        paint_model (Rc, 2, 2) optional model-space gradient endpoints
        per cover draw — transformed alongside the hulls so gradients
        track camera motion."""
        f32 = jnp.float32
        i32 = jnp.int32

        # ---- per-stencil-draw triangle setup --------------------------
        s_cmd = jnp.asarray(draws.s_cmd)
        sshape = jnp.asarray(s_shape_np)
        sxy = xy[sshape]                     # (Rs, T, 3, 2)
        saux = aux[sshape]
        stf = transforms[jnp.asarray(draws.s_row)]   # (Rs, 4, 4)

        v = jnp.concatenate(
            [sxy, jnp.zeros(sxy.shape[:-1] + (1,), f32),
             jnp.ones(sxy.shape[:-1] + (1,), f32)], axis=-1,
        )
        clip = jnp.einsum(
            "ctvk,crk->ctvr", v, stf, precision=jax.lax.Precision.HIGHEST
        )

        # ---- flatten to rows (one row per screen triangle) ------------
        N0 = Rs * T
        clip_flat = clip.reshape(N0, 3, 4)
        aux_flat = saux.reshape(N0, 3, 4)
        kind_flat = kind[sshape].reshape(N0)
        meta_flat = meta[sshape].reshape(N0, 2)
        gbase_flat = jnp.repeat(gbase[sshape], T)
        cmd_flat = jnp.repeat(s_cmd, T)

        # ---- near-plane clipping of crossing triangles -----------------
        # The GPU hardware clips primitives against w > 0 before
        # rasterization; triangles crossing the near plane are
        # Sutherland-Hodgman clipped here into up to two sub-triangles
        # (a fixed pool of E slots; overflow is reported so the host can
        # regrow).  Clip-space coordinates and the per-vertex implicit
        # weights both interpolate linearly along a clip-space edge.
        E = spec.clip_pool
        w_eps = jnp.float32(1e-6)
        w_all = clip_flat[..., 3]
        win = w_all > w_eps
        n_in = jnp.sum(win.astype(i32), axis=-1)
        crossing = (n_in >= 1) & (n_in <= 2)
        cross_total = jnp.sum(crossing.astype(i32))
        ckey = jnp.where(crossing, N0 - jnp.arange(N0, dtype=i32), -1)
        _cvals, cidx = jax.lax.top_k(ckey, min(E, N0))
        if E > N0:
            cidx = jnp.pad(cidx, (0, E - N0))
        slot_ok = jnp.arange(E, dtype=i32) < jnp.minimum(cross_total, E)

        attr = jnp.concatenate(
            [clip_flat[cidx], aux_flat[cidx]], axis=-1
        )  # (E, 3, 8)
        wa = attr[..., 3]
        a_in = wa > w_eps
        nxt = attr[:, jnp.asarray([1, 2, 0]), :]
        wb = wa[:, jnp.asarray([1, 2, 0])]
        b_in = wb > w_eps
        denom = jnp.where(wb - wa != 0.0, wb - wa, 1.0)
        t_cross = (w_eps - wa) / denom
        inter = attr + t_cross[..., None] * (nxt - attr)
        # Pin the intersection w to exactly eps: the lerp's rounding can
        # land slightly negative for large |w| endpoints, which would
        # cull the whole sub-triangle downstream.
        inter = inter.at[..., 3].set(w_eps)
        out_v = jnp.stack([attr, inter], axis=2).reshape(E, 6, 8)
        out_ok = jnp.stack([a_in, a_in != b_in], axis=2).reshape(E, 6)
        rank = jnp.cumsum(out_ok.astype(i32), axis=1) - 1
        cnt = jnp.sum(out_ok.astype(i32), axis=1)
        rows_e = jnp.broadcast_to(jnp.arange(E, dtype=i32)[:, None], (E, 6))
        slot = jnp.where(out_ok, jnp.minimum(rank, 4), 4)
        poly = jnp.zeros((E * 5, 8), f32).at[
            (rows_e * 5 + slot).reshape(-1)
        ].set(out_v.reshape(-1, 8), mode="drop").reshape(E, 5, 8)[:, :4]
        in_use = (
            jnp.arange(4, dtype=i32)[None, :] < jnp.minimum(cnt, 4)[:, None]
        )
        poly = jnp.where(in_use[..., None], poly, poly[:, 0:1])
        # Fan: (p0, p1, p2) and (p0, p2, p3); with a 3-vertex polygon the
        # second is degenerate (zero area) and culled downstream.
        tri0 = poly[:, jnp.asarray([0, 1, 2])]
        tri1 = poly[:, jnp.asarray([0, 2, 3])]
        pool_attr = jnp.concatenate([tri0, tri1], axis=0)   # (2E, 3, 8)
        pool_valid = jnp.tile(slot_ok, 2)
        pool_clip = jnp.where(
            pool_valid[:, None, None], pool_attr[..., :4], 0.0
        )
        pool_aux = pool_attr[..., 4:]
        pool_src = jnp.tile(jnp.where(slot_ok, cidx, 0), 2)

        clip_all = jnp.concatenate([clip_flat, pool_clip])   # (N, 3, 4)
        aux_all = jnp.concatenate([aux_flat, pool_aux])
        kind_all = jnp.concatenate([kind_flat, kind_flat[pool_src]])
        meta_all = jnp.concatenate([meta_flat, meta_flat[pool_src]])
        gbase_all = jnp.concatenate([gbase_flat, gbase_flat[pool_src]])
        cmd_of = jnp.concatenate([cmd_flat, cmd_flat[pool_src]])
        # Original crossing rows are superseded by their pool
        # sub-triangles; fully-behind rows fail the w test either way.
        near_ok = jnp.concatenate(
            [jnp.all(win, axis=-1),
             jnp.all(pool_clip[..., 3] > 0.0, axis=-1) & pool_valid]
        )
        n_rows = N0 + 2 * E

        # ---- screen-space projection + edge setup ----------------------
        w = clip_all[..., 3]
        inv_w = jnp.where(w != 0.0, 1.0 / w, 0.0)
        ndc = clip_all[..., :2] * inv_w[..., None]
        px = (ndc[..., 0] + 1.0) * (0.5 * W)
        py = (1.0 - ndc[..., 1]) * (0.5 * H)
        pix = jnp.stack([px, py], axis=-1)   # (N, 3, 2)

        v0, v1, v2 = pix[..., 0, :], pix[..., 1, :], pix[..., 2, :]
        area = (v1[..., 0] - v0[..., 0]) * (v2[..., 1] - v0[..., 1]) - (
            v1[..., 1] - v0[..., 1]
        ) * (v2[..., 0] - v0[..., 0])
        orient = jnp.sign(area)
        finite = jnp.all(jnp.isfinite(pix), axis=(-1, -2)) & jnp.isfinite(area)
        visible = finite & (area != 0.0) & near_ok

        edges = []
        tl_bits = jnp.zeros(area.shape, i32)
        for e_index, (ai, bi) in enumerate(((0, 1), (1, 2), (2, 0))):
            a_v = pix[..., ai, :]
            b_v = pix[..., bi, :]
            ea = -(b_v[..., 1] - a_v[..., 1]) * orient
            eb = (b_v[..., 0] - a_v[..., 0]) * orient
            ec = -(ea * a_v[..., 0] + eb * a_v[..., 1])
            aa = jnp.where(orient[..., None] > 0, a_v, b_v)
            bb = jnp.where(orient[..., None] > 0, b_v, a_v)
            top_left = ((aa[..., 1] == bb[..., 1]) & (bb[..., 0] > aa[..., 0])) | (
                bb[..., 1] > aa[..., 1]
            )
            tl_bits = tl_bits | (top_left.astype(i32) << e_index)
            edges.append(jnp.stack([ea, eb, ec], axis=-1))
        edge = jnp.stack(edges, axis=-2)     # (N, 3, 3)
        inv_area = jnp.where(area != 0.0, 1.0 / jnp.abs(area), 0.0)

        aux_w = aux_all * inv_w[..., None]
        perm = jnp.asarray([2, 0, 1])
        aw = aux_w[..., perm, :]             # aw[k] pairs edge k
        iw = inv_w[..., perm]

        is_fill = kind_all <= KIND_RATIONAL_CUBIC
        contribution = jnp.where(
            visible & is_fill, -orient.astype(i32), 0
        )
        contribution = jnp.where(visible & ~is_fill, 1, contribution)

        group_flags = meta_all[..., 0].astype(i32)
        group = gbase_all + (group_flags & 0xFFFF)
        flags = (
            tl_bits
            | jnp.where((group_flags & 0x10000) != 0, FLAG_END_CAP, 0)
            | jnp.where((group_flags & 0x20000) != 0, FLAG_JOINT_TIP, 0)
        )

        aabb = jnp.concatenate(
            [jnp.min(pix, axis=-2), jnp.max(pix, axis=-2)], axis=-1
        )
        live = (
            (contribution != 0)
            & (aabb[..., 0] <= W) & (aabb[..., 2] >= 0.0)
            & (aabb[..., 1] <= H) & (aabb[..., 3] >= 0.0)
        )
        contribution = jnp.where(live, contribution, 0)

        rows_f = jnp.concatenate(
            [
                edge.reshape(n_rows, 9),
                inv_area[..., None],
                aw.reshape(n_rows, 12),
                iw,
                meta_all[..., 1:2],
                aabb,
                jnp.zeros((n_rows, D_F - 30), f32),
            ],
            axis=-1,
        )
        # Per-group dash mode looked up via a one-hot reduction over the
        # (tiny) group table.
        n_groups = desc_static.shape[0]
        mode_tbl = jnp.where(
            desc_static[:, 0] == 0,
            0,
            jnp.where(desc_static[:, 1] == 0, 1, 2),
        )  # (n_groups,)
        one_hot_grp = (
            group[:, None] == jnp.arange(n_groups, dtype=i32)[None, :]
        )
        dash_mode = jnp.sum(
            jnp.where(one_hot_grp, mode_tbl[None, :], 0), axis=1
        )
        clsk = jnp.where(
            kind_all == KIND_STROKE_LINE, CLS_LINE_SOLID + dash_mode,
            jnp.where(
                kind_all == KIND_STROKE_JOINT, CLS_JOINT_SOLID + dash_mode,
                jnp.where(
                    kind_all == KIND_SOLID, CLS_FILL_SOLID,
                    jnp.where(
                        (kind_all == KIND_INTEGRAL_QUADRATIC)
                        | (kind_all == KIND_RATIONAL_QUADRATIC),
                        CLS_FILL_QUAD, CLS_FILL_CUBIC,
                    ),
                ),
            ),
        )
        rows_i = jnp.stack(
            [
                kind_all,
                contribution,
                group,
                flags,
                is_fill.astype(i32),
                cmd_of,
                clsk,
                jnp.zeros(n_rows, i32),
            ],
            axis=-1,
        )

        live = live.reshape(-1)
        aabb_flat = aabb
        solid_flat = kind_all == KIND_SOLID
        contrib_flat = rows_i[:, RI_CONTRIB]
        class_flat = rows_i[:, RI_CLASS]
        key2_flat = cmd_of * N_CLASSES + class_flat

        tx0 = jnp.clip(jnp.floor(aabb_flat[:, 0] / tw), 0, ntx - 1).astype(i32)
        ty0 = jnp.clip(jnp.floor(aabb_flat[:, 1] / th), 0, nty - 1).astype(i32)
        tx1 = jnp.clip(jnp.floor(aabb_flat[:, 2] / tw), 0, ntx - 1).astype(i32)
        ty1 = jnp.clip(jnp.floor(aabb_flat[:, 3] / th), 0, nty - 1).astype(i32)
        span_ok = ((tx1 - tx0) < mx) & ((ty1 - ty0) < my)
        is_local = live & span_ok
        is_global = live & ~span_ok

        bulk = jnp.zeros((n_tiles, C), i32)

        # ---- local slot enumeration ----------------------------------
        m = jnp.arange(M, dtype=i32)
        etx = tx0[:, None] + (m % mx)[None, :]      # (N, M)
        ety = ty0[:, None] + (m // mx)[None, :]
        in_range = (
            (etx <= tx1[:, None]) & (ety <= ty1[:, None])
            & (etx < ntx) & (ety < nty) & is_local[:, None]
        )
        ex0 = etx.astype(f32) * tw
        ey0 = ety.astype(f32) * th
        reject = jnp.zeros(etx.shape, bool)
        accept = jnp.ones(etx.shape, bool)
        for e_index in range(3):
            a = rows_f[:, 3 * e_index + 0][:, None]
            b = rows_f[:, 3 * e_index + 1][:, None]
            c = rows_f[:, 3 * e_index + 2][:, None]
            lo, hi = _corner_min_max(a, b, c, ex0, ey0, tw, th)
            reject = reject | (hi < 0.0)
            accept = accept & (lo > 0.0)
        valid = in_range & ~reject
        tile_of = ety * ntx + etx
        solid_acc = valid & accept & solid_flat[:, None]
        entry = valid & ~solid_acc

        # Trivial-accept scatter, cond-guarded: most scenes (small
        # triangles only) never fully cover a tile, and the scatter-add
        # costs ~0.5 ms even when every contribution is zero.
        bulk_vals = jnp.where(solid_acc, contrib_flat[:, None], 0)
        bulk = jax.lax.cond(
            jnp.any(solid_acc),
            lambda b: b.at[
                tile_of.reshape(-1), jnp.repeat(cmd_of, M)
            ].add(bulk_vals.reshape(-1), mode="drop"),
            lambda b: b,
            bulk,
        )

        # Stable sort of local entries by (tile, cmd, class) — stroke
        # classes precede fill classes within each command.
        key = (tile_of * C + cmd_of[:, None]) * N_CLASSES + class_flat[:, None]
        big = n_tiles * C * N_CLASSES
        key = jnp.where(entry, key, big).reshape(-1)
        payload = jnp.broadcast_to(
            jnp.arange(n_rows, dtype=i32)[:, None], (n_rows, M)
        ).reshape(-1)
        skey, srow = jax.lax.sort((key, payload), num_keys=1, is_stable=True)

        counts2 = jnp.zeros(n_tiles * N_CLASSES * C, i32).at[
            jnp.where(key < big, key, 0)
        ].add(jnp.where(key < big, 1, 0)).reshape(n_tiles, N_CLASSES * C)
        off = jnp.concatenate(
            [jnp.zeros((n_tiles, 1), i32), jnp.cumsum(counts2, axis=1)],
            axis=1,
        )
        tile_count = off[:, -1]
        # Start of each tile's segment in the sorted order — an
        # exclusive cumsum of the per-tile counts (invalid entries key
        # past every tile and sink to the tail).
        tile_begin = jnp.concatenate(
            [jnp.zeros(1, i32), jnp.cumsum(tile_count)[:-1]]
        )

        kk = jnp.arange(K, dtype=i32)
        gidx = jnp.clip(tile_begin[:, None] + kk[None, :], 0, skey.shape[0] - 1)
        # Gather wide rows through the sorted order.  Rows past a tile's
        # entry count are garbage from the neighbouring segment — the
        # kernel never reads past the `off` ranges.
        sorted_f = rows_f[srow]
        sorted_i = rows_i[srow]
        # Clamp offsets to capacity so kernel ranges stay in bounds even
        # on overflow (the host detects it via `overflow` and retries).
        off = jnp.minimum(off, K)

        # ---- globals (big triangles) via small dense matrix -----------
        gkey = jnp.where(is_global, key2_flat, C * N_CLASSES + 1)
        gskey, gsrow = jax.lax.sort((gkey, jnp.arange(n_rows, dtype=i32)),
                                    num_keys=1, is_stable=True)
        g_total = jnp.sum(is_global.astype(i32))
        g_ids = gsrow[:G] if n_rows >= G else jnp.pad(gsrow, (0, G - n_rows))
        g_valid = jnp.arange(G, dtype=i32) < jnp.minimum(g_total, G)
        g_rows_f = rows_f[g_ids]
        g_rows_i = rows_i[g_ids]

        tile_x0 = (jnp.arange(ntx, dtype=f32) * tw)
        tile_y0 = (jnp.arange(nty, dtype=f32) * th)
        # AABB overlap, separable.
        gaabb = g_rows_f[:, RF_AABB:RF_AABB + 4]
        ovx = (gaabb[:, 0:1] <= tile_x0[None, :] + tw) & (
            gaabb[:, 2:3] >= tile_x0[None, :]
        )  # (G, ntx)
        ovy = (gaabb[:, 1:2] <= tile_y0[None, :] + th) & (
            gaabb[:, 3:4] >= tile_y0[None, :]
        )  # (G, nty)
        g_reject = jnp.zeros((G, nty, ntx), bool)
        g_accept = jnp.ones((G, nty, ntx), bool)
        for e_index in range(3):
            a = g_rows_f[:, 3 * e_index + 0][:, None, None]
            b = g_rows_f[:, 3 * e_index + 1][:, None, None]
            c = g_rows_f[:, 3 * e_index + 2][:, None, None]
            lo, hi = _corner_min_max(
                a, b, c, tile_x0[None, None, :], tile_y0[None, :, None], tw, th
            )
            g_reject = g_reject | (hi < 0.0)
            g_accept = g_accept & (lo > 0.0)
        g_over = ovy[:, :, None] & ovx[:, None, :] & g_valid[:, None, None]
        g_solid = g_rows_i[:, RI_KIND] == KIND_SOLID
        g_acc_mask = g_over & g_accept & g_solid[:, None, None]
        g_entry = (g_over & ~g_reject & ~g_acc_mask).transpose(1, 2, 0).reshape(
            n_tiles, G
        )
        g_acc_flat = g_acc_mask.transpose(1, 2, 0).reshape(n_tiles, G)

        # Per-(tile, command) reductions over globals as one-hot
        # products: on the H100 they beat the equivalent scatter-adds
        # (0.54 vs 1.39 ms at the 4K showcase's shapes, PERF.md).  Exact
        # even in TF32: every operand is 0 or ±1 and the f32 sums stay
        # far below 2**24.
        g_cmd = g_rows_i[:, RI_CMD]
        cmd_one_hot = (
            g_cmd[:, None] == jnp.arange(C, dtype=i32)[None, :]
        ).astype(jnp.float32)
        bulk = bulk + jnp.dot(
            jnp.where(g_acc_flat, g_rows_i[None, :, RI_CONTRIB], 0).astype(
                jnp.float32
            ),
            cmd_one_hot,
            preferred_element_type=jnp.float32,
        ).astype(i32)

        # Per-tile global entry list, ordered by ascending g (already
        # (cmd, class)-sorted): top_k over a descending key.
        gl_key = jnp.where(
            g_entry, G - jnp.arange(G, dtype=i32)[None, :], -1
        )
        _gl_vals, gl_idx = jax.lax.top_k(gl_key, Kg)
        # Each tile's rows: K local entries, then its Kg big-triangle
        # entries materialized densely, so the kernel reads both ranges
        # from one table.
        tri_f = jnp.concatenate([sorted_f[gidx], g_rows_f[gl_idx]], axis=1)
        tri_i = jnp.concatenate([sorted_i[gidx], g_rows_i[gl_idx]], axis=1)
        g_key2 = g_cmd * N_CLASSES + g_rows_i[:, RI_CLASS]
        key2_one_hot = (
            g_key2[:, None]
            == jnp.arange(N_CLASSES * C, dtype=i32)[None, :]
        ).astype(jnp.float32)
        g_counts2 = jnp.dot(
            g_entry.astype(jnp.float32),
            key2_one_hot,
            preferred_element_type=jnp.float32,
        ).astype(i32)
        g_off = jnp.concatenate(
            [jnp.zeros((n_tiles, 1), i32), jnp.cumsum(g_counts2, axis=1)],
            axis=1,
        )
        tile_g_count = g_off[:, -1]
        g_off = jnp.minimum(g_off, Kg)

        # ---- cover draws: near-plane clip + hull lines + class ---------
        # Computed per cover draw (one hull cover per (command,
        # instance)); stencil draws never read hull rows.
        hp = hull[jnp.asarray(c_shape_np)]               # (Rc, Hm, 2)
        ctf = transforms[jnp.asarray(draws.c_row)]       # (Rc, 4, 4)
        Cc = Rc

        # ---- gradient paint endpoints: model → pixel space -------------
        # Two points per cover draw (linear: start/end; radial:
        # center/rim); the same projection as the hulls, so paints ride
        # camera motion for free.  Zeros when the frame has no paints.
        if paint_model is None:
            paint_xy = jnp.zeros((Rc, 4), f32)
        else:
            ph = jnp.concatenate(
                [
                    jnp.asarray(paint_model, f32),
                    jnp.zeros((Rc, 2, 1), f32),
                    jnp.ones((Rc, 2, 1), f32),
                ],
                axis=-1,
            )
            pclip = jnp.einsum(
                "cpk,crk->cpr", ph, ctf,
                precision=jax.lax.Precision.HIGHEST,
            )
            pw = pclip[..., 3]
            piw = jnp.where(jnp.abs(pw) > 1e-6, 1.0 / pw, 0.0)
            pndc = pclip[..., :2] * piw[..., None]
            ppx = (pndc[..., 0] + 1.0) * (0.5 * W)
            ppy = (1.0 - pndc[..., 1]) * (0.5 * H)
            paint_xy = jnp.stack(
                [ppx[:, 0], ppy[:, 0], ppx[:, 1], ppy[:, 1]], axis=-1
            )

        # ---- per-cover-draw depth planes --------------------------------
        # For planar model geometry (z=0), NDC z is an affine function
        # of pixel coordinates (the same screen-space linearity GPUs
        # exploit to interpolate depth): solve z_ndc = a·px + b·py + c
        # from the transform rows without any perspective divide, using
        # px·w = (x_clip + w)·W/2 and py·w = (w − y_clip)·H/2 — both
        # affine over the model plane — so behind-the-eye sample points
        # can never poison the solve.  Consumed by the color cover's
        # depth test (reference depth_compare/depth_write_enabled,
        # renderer.rs:387-390); zeros when depth is compiled out.
        if spec.depth_write or spec.depth_compare != "always":
            mcols = jnp.asarray([0, 1, 3])  # coefficients over (x, y, 1)
            Xr = ctf[:, 0, mcols]
            Yr = ctf[:, 1, mcols]
            Zr = ctf[:, 2, mcols]
            Wr = ctf[:, 3, mcols]
            # Match coefficients of (x, y, 1) in
            #   Z = a·(X + W)·W/2 + b·(W − Y)·H/2 + c·W.
            A = jnp.stack(
                [(Xr + Wr) * (0.5 * W), (Wr - Yr) * (0.5 * H), Wr],
                axis=-1,
            )  # (Rc, 3, 3): rows over (x, y, 1), columns over (a, b, c)
            det = jnp.linalg.det(A)
            safe = jnp.abs(det) > 1e-30
            zplane = jnp.where(
                safe[:, None],
                jnp.linalg.solve(
                    jnp.where(
                        safe[:, None, None], A,
                        jnp.broadcast_to(jnp.eye(3, dtype=f32), A.shape),
                    ),
                    Zr[..., None],
                )[..., 0],
                jnp.zeros((Rc, 3), f32),
            )
        else:
            zplane = jnp.zeros((Rc, 3), f32)
        ones = jnp.ones((Cc, Hm, 1), f32)
        hclip = jnp.einsum(
            "chk,crk->chr",
            jnp.concatenate([hp, jnp.zeros((Cc, Hm, 1), f32), ones], axis=-1),
            ctf,
            precision=jax.lax.Precision.HIGHEST,
        )
        # Sutherland–Hodgman clip of the convex hull against w > eps —
        # the GPU hardware near-plane clip the reference relies on.  A
        # hull vertex behind the camera therefore no longer disables the
        # whole cover command; the visible part keeps rendering.
        H2 = Hm + 2
        eps = jnp.float32(1e-5)
        b_vert = jnp.roll(hclip, -1, axis=1)
        wa = hclip[..., 3]
        wb = b_vert[..., 3]
        in_a = wa > eps
        denom = jnp.where(wb - wa != 0.0, wb - wa, 1.0)
        t_int = (eps - wa) / denom
        inter = hclip + t_int[..., None] * (b_vert - hclip)
        out_v = jnp.stack([hclip, inter], axis=2).reshape(Cc, 2 * Hm, 4)
        out_valid = jnp.stack(
            [in_a, in_a != (wb > eps)], axis=2
        ).reshape(Cc, 2 * Hm)
        h_rank = jnp.cumsum(out_valid.astype(i32), axis=1) - 1
        h_count = jnp.sum(out_valid.astype(i32), axis=1)  # (Cc,)
        rows_c = jnp.broadcast_to(
            jnp.arange(Cc, dtype=i32)[:, None], (Cc, 2 * Hm)
        )
        slot = jnp.where(out_valid, jnp.minimum(h_rank, H2), H2)
        clipped = jnp.zeros((Cc * (H2 + 1), 4), f32).at[
            (rows_c * (H2 + 1) + slot).reshape(-1)
        ].set(out_v.reshape(-1, 4), mode="drop").reshape(Cc, H2 + 1, 4)[
            :, :H2
        ]
        # Pad unused slots with the first clipped vertex so the padded
        # edges are degenerate (replaced by pass lines below).
        in_use = (
            jnp.arange(H2, dtype=i32)[None, :] < jnp.minimum(h_count, H2)[:, None]
        )
        clipped = jnp.where(in_use[..., None], clipped, clipped[:, 0:1, :])
        hvalid = h_count >= 3

        hw = clipped[..., 3]
        hiw = jnp.where(hw > 0.0, 1.0 / hw, 0.0)
        hndc = clipped[..., :2] * hiw[..., None]
        hx = (hndc[..., 0] + 1.0) * (0.5 * W)
        hy = (1.0 - hndc[..., 1]) * (0.5 * H)
        hxn = jnp.roll(hx, -1, axis=-1)
        hyn = jnp.roll(hy, -1, axis=-1)
        h_area = jnp.sum(hx * hyn - hxn * hy, axis=-1)
        hsign = jnp.where(h_area >= 0, 1.0, -1.0)[:, None]
        ha = -(hyn - hy) * hsign
        hb = (hxn - hx) * hsign
        hc = -(ha * hx + hb * hy)
        degenerate = (ha == 0.0) & (hb == 0.0)
        ha = jnp.where(degenerate, 0.0, ha)
        hb = jnp.where(degenerate, 0.0, hb)
        hc = jnp.where(degenerate, 1.0, hc)
        hull_lines = jnp.stack(
            [ha, hb, hc, jnp.zeros_like(ha)], axis=-1
        )  # (Rc, H2, 4)

        hx_min = jnp.min(hx, axis=-1)
        hx_max = jnp.max(hx, axis=-1)
        hy_min = jnp.min(hy, axis=-1)
        hy_max = jnp.max(hy, axis=-1)
        hovx = (hx_min[:, None] <= tile_x0[None, :] + tw) & (
            hx_max[:, None] >= tile_x0[None, :]
        )
        hovy = (hy_min[:, None] <= tile_y0[None, :] + th) & (
            hy_max[:, None] >= tile_y0[None, :]
        )
        h_reject = jnp.zeros((Cc, nty, ntx), bool)
        h_accept = jnp.ones((Cc, nty, ntx), bool)
        # Per-(tile, cover) bitmask of hull lines actually crossing the
        # tile: boundary tiles evaluate only those lines in the kernel
        # (typically 1-4 of up to 18 after hull decimation).  Lines the
        # tile is fully inside of are skipped; lines the tile is fully
        # outside of reject the whole tile (cls 0).
        h_bits = jnp.zeros((Cc, nty, ntx), i32)
        assert H2 <= 31, "hull-line bitmask needs a single i32 word"
        for h_index in range(H2):
            a = ha[:, h_index][:, None, None]
            b = hb[:, h_index][:, None, None]
            c = hc[:, h_index][:, None, None]
            lo, hi = _corner_min_max(
                a, b, c, tile_x0[None, None, :], tile_y0[None, :, None], tw, th
            )
            h_reject = h_reject | (hi < 0.0)
            h_accept = h_accept & (lo > 0.0)
            h_bits = h_bits | jnp.where(lo > 0.0, 0, 1 << h_index)
        h_over = hovy[:, :, None] & hovx[:, None, :] & hvalid[:, None, None]
        cls = jnp.where(
            h_over,
            jnp.where(h_accept, 2, jnp.where(h_reject, 0, 1)),
            0,
        ).astype(i32).transpose(1, 2, 0).reshape(n_tiles, Rc)
        hbits = h_bits.transpose(1, 2, 0).reshape(n_tiles, Rc)

        # ---- active unit list ------------------------------------------
        # A unit is a kernel walk step in global draw order: a whole
        # stencil command or one cover draw (see DrawTables).
        start = off[:, 0:N_CLASSES * C:N_CLASSES]
        end = off[:, N_CLASSES:N_CLASSES * C + 1:N_CLASSES]
        local_any = (end - start) > 0
        g_start = g_off[:, 0:N_CLASSES * C:N_CLASSES]
        g_end = g_off[:, N_CLASSES:N_CLASSES * C + 1:N_CLASSES]
        global_any = (g_end - g_start) > 0
        stencil_active = local_any | global_any | (bulk != 0)
        cover_active = cls > 0
        # Static column gathers route each unit to its activity source.
        act_s = stencil_active[:, jnp.asarray(draws.unit_cmd)]
        act_c = cover_active[:, jnp.asarray(np.maximum(draws.unit_draw, 0))]
        is_cover_u = jnp.asarray(draws.unit_draw >= 0)
        active = jnp.where(is_cover_u[None, :], act_c, act_s)
        # ---- clip/alpha bracket gating ------------------------------
        # Drop a balanced bracket's machinery units from tiles NO
        # content unit of the whole frame touches: frame alpha is
        # exactly 0 there, and the complete bracket is then bit-exact
        # identity on the color buffer (save/scale/restore over a0 = 0
        # computes fl(1−g) − fl(1·fl(1−g)) = 0 with no rounding slack;
        # clip ops never touch color; wind/layerb are written and read
        # only by the equally-gated machinery).  The static proof
        # obligations (depth protocol, shape/layer/opacity pairing,
        # identical issue-time clip state) were discharged by
        # renderer._gate_spans; hull coincidence (equal opener/closer
        # transform rows) is the one runtime condition, checked here
        # per frame.
        for _content_u, _mach_u, _row_pairs in spec.gate_spans:
            valid = jnp.bool_(True)
            for _ra, _rb in _row_pairs:
                valid = valid & jnp.all(
                    transforms[_ra] == transforms[_rb]
                )
            _content_m = np.zeros(U, bool)
            _content_m[list(_content_u)] = True
            _mach_m = np.zeros(U, bool)
            _mach_m[list(_mach_u)] = True
            content_any = jnp.any(
                active & jnp.asarray(_content_m)[None, :], axis=1
            )
            active = active & (
                jnp.asarray(~_mach_m)[None, :]
                | content_any[:, None]
                | ~valid
            )
        # Compact active unit indices per tile by a row-wise sort
        # (inactive slots key to U and sink to the tail; order-preserving).
        aclist = jnp.sort(
            jnp.where(
                active, jnp.arange(U, dtype=i32)[None, :], jnp.int32(U)
            ),
            axis=1,
        )
        acount = jnp.sum(active.astype(i32), axis=1)

        overflow = jnp.stack(
            [jnp.max(tile_count), g_total, jnp.max(tile_g_count), cross_total]
        ).astype(i32)

        return PreparedFrame(
            tri_f=tri_f,
            tri_i=tri_i,
            off=off,
            g_off=g_off,
            bulk=bulk,
            cls=cls,
            hbits=hbits,
            aclist=aclist,
            acount=acount,
            hull_lines=hull_lines,
            paint_xy=paint_xy,
            zplane=zplane,
            overflow=overflow,
        )

    return prepare


# ---------------------------------------------------------------------------
# rasterize: per-sample predicates (shared by the kernel and the reference)
# ---------------------------------------------------------------------------
#
# Every helper below works on per-sample arrays and on coefficients that
# are either scalars (the kernel walks one tile) or arrays broadcastable
# against the samples (the plain executor in ops/reference.py walks all
# tiles at once).  Frame state is a `RasterState` of per-sample lists —
# Triton values must be power-of-two arrays and cannot be sliced, so the
# sample axis is a Python list rather than an array dimension.


class RasterState(NamedTuple):
    """Per-sample frame state of one tile (kernel) or of all tiles
    (reference).  Each leaf list has one array per MSAA sample."""

    wind: tuple          # S × int32 winding counters
    color: tuple         # 4 × S × float32 premultiplied RGBA
    clip: tuple = ()     # S × int32 clip depth (frames with clip ops)
    layer: tuple = ()    # L × S × float32 saved alpha (alpha groups)
    depth: tuple = ()    # S × float32 depth (depth-tested frames)


def _frame_features(spec: FrameSpec):
    """(has_clip, has_alpha, has_depth, has_paint) — static per frame
    program: frames without clip/alpha/depth/paint commands compile
    that state and its per-sample work out."""
    ops_np = np.asarray(spec.ops, np.int32)
    has_clip = bool(np.any((ops_np == OP_CLIP) | (ops_np == OP_UNCLIP)))
    has_alpha = bool(np.any(
        (ops_np == OP_SAVE_ALPHA) | (ops_np == OP_SCALE_ALPHA)
        | (ops_np == OP_RESTORE_ALPHA) | (ops_np == OP_SAVE_SCALE)
    ))
    has_depth = spec.depth_write or spec.depth_compare != "always"
    return has_clip, has_alpha, has_depth, bool(any(spec.paints))


def _initial_state(spec: FrameSpec, shape) -> RasterState:
    has_clip, has_alpha, has_depth, _ = _frame_features(spec)
    S = spec.samples
    L = max(1, spec.n_layers)

    def zeros(dtype):
        return tuple(jnp.zeros(shape, dtype) for _ in range(S))

    return RasterState(
        wind=zeros(jnp.int32),
        color=tuple(zeros(jnp.float32) for _ in range(4)),
        clip=zeros(jnp.int32) if has_clip else (),
        layer=(
            tuple(zeros(jnp.float32) for _ in range(L)) if has_alpha else ()
        ),
        # The reference render pass clears depth to 1.0
        # (examples/showcase/main.rs LoadOp::Clear(1.0)).
        depth=(
            tuple(jnp.ones(shape, jnp.float32) for _ in range(S))
            if has_depth else ()
        ),
    )


def _user_paint_fns(spec: FrameSpec):
    """Distinct user-paint functions in first-appearance order over the
    command walk — matches renderer._pack_commands_runtime's code
    assignment (code = 3 + index)."""
    fns, seen = [], set()
    for p in spec.paints:
        fn = getattr(p, "fn", None)
        if fn is not None and id(fn) not in seen:
            seen.add(id(fn))
            fns.append(fn)
    return fns


def _cap_mask(cap_type, tex_x, tex_y):
    """Analytic cap predicates (shaders.wgsl:165-189) for a cap type
    that varies per sample or per tile, as a where-chain."""
    ax = jnp.abs(tex_x)
    cases = [
        tex_y <= 0.5,                                   # SQUARE
        tex_x * tex_x + tex_y * tex_y < 0.25,           # ROUND
        0.5 - tex_y > ax,                               # OUT
        tex_y < ax,                                     # IN
        0.5 - tex_y > tex_x,                            # RIGHT
        tex_y - 0.5 < tex_x,                            # LEFT
    ]
    out = (cap_type == int(Cap.BUTT)) & (tex_y < 0.0)
    for value, case in enumerate(cases):
        out = jnp.where(cap_type == value, case, out)
    return out


def _cap_mask_scalar(cap_type, tex_x, tex_y):
    """Cap predicate for a *scalar* cap type: `lax.switch` runs the one
    analytic case (shaders.wgsl:165-189) instead of all seven.  Solid
    strokes and single-interval dash patterns have scalar caps."""
    branches = [
        lambda: tex_y <= 0.5,                                  # SQUARE
        lambda: tex_x * tex_x + tex_y * tex_y < 0.25,          # ROUND
        lambda: 0.5 - tex_y > jnp.abs(tex_x),                  # OUT
        lambda: tex_y < jnp.abs(tex_x),                        # IN
        lambda: 0.5 - tex_y > tex_x,                           # RIGHT
        lambda: tex_y - 0.5 < tex_x,                           # LEFT
        lambda: tex_y < 0.0,                                   # BUTT
    ]
    return jax.lax.switch(cap_type, branches)


def _dash_mask_single(df, di, tex_x, tex_y):
    """Dashed coverage for a single-interval pattern: no per-sample
    interval search, scalar cap types.  Entries are routed here
    statically by their binning class (CLS_*_DASH1).  `df`/`di` are the
    descriptor row's values, indexable by column."""
    pattern_len = df[4]
    position = jnp.remainder(tex_y - df[8], pattern_len)
    past = position - df[0]
    in_dash = past <= 0.0
    cap_a = _cap_mask_scalar(di[0], tex_x, past)
    cap_b = _cap_mask_scalar(di[4], tex_x, pattern_len - position)
    return in_dash | cap_a | cap_b


def _dash_mask_general(df, di, tex_x, tex_y):
    """Dashed coverage (shaders.wgsl:205-231) for one descriptor row at
    per-sample pattern position tex_y, side tex_x."""
    last = di[8]
    gap_start = [df[i] for i in range(4)]
    gap_end = [df[4 + i] for i in range(4)]
    end_caps = [di[i] for i in range(4)]
    start_caps = [di[4 + i] for i in range(4)]
    pattern_len = gap_end[0]
    for i in range(1, MAX_DASH_INTERVALS):
        pattern_len = jnp.where(last == i, gap_end[i], pattern_len)
    position = jnp.remainder(tex_y - df[8], pattern_len)
    interval = jnp.zeros(position.shape, jnp.int32) + last
    for i in range(MAX_DASH_INTERVALS - 1, -1, -1):
        hit = (gap_end[i] - position >= 0.0) & (i <= last)
        interval = jnp.where(hit, i, interval)
    g_s = jnp.zeros_like(position)
    g_e = jnp.zeros_like(position)
    e_cap = jnp.zeros(position.shape, jnp.int32)
    s_cap = jnp.zeros(position.shape, jnp.int32)
    for i in range(MAX_DASH_INTERVALS):
        sel = interval == i
        g_s = jnp.where(sel, gap_start[i], g_s)
        g_e = jnp.where(sel, gap_end[i], g_e)
        e_cap = jnp.where(sel, end_caps[i], e_cap)
        s_cap = jnp.where(sel, start_caps[i], s_cap)
    past = position - g_s
    in_dash = past <= 0.0
    cap_a = _cap_mask(e_cap, tex_x, past)
    cap_b = _cap_mask(s_cap, tex_x, g_e - position)
    return in_dash | cap_a | cap_b


def _edge_functions(f, pxc, pyc):
    """The entry's three oriented edge functions evaluated at pixel
    centers, plus their (a, b) gradients.  `f(col)` reads the entry's
    float row."""
    ea = [f(0), f(3), f(6)]
    eb = [f(1), f(4), f(7)]
    ec = [ea[k] * pxc + eb[k] * pyc + f(3 * k + 2) for k in range(3)]
    return ea, eb, ec


def _inside(ea, eb, ec, tl, dx, dy):
    """Top-left-rule edge test at the sample offset (dx, dy) from the
    pixel center.  The edge functions are linear in screen space, so the
    per-sample test is a threshold shift of the center value."""
    inside = None
    for k in range(3):
        nt = -(ea[k] * dx + eb[k] * dy)
        t = (ec[k] > nt) | ((ec[k] == nt) & tl[k])
        inside = t if inside is None else (inside & t)
    return inside


def _interpolants(f, ea, eb, ec, n_ch):
    """Center values and screen gradients of the entry's first `n_ch`
    aux·(1/w) channels and of 1/w (perspective-correct interpolation
    divides the first by the second per sample)."""
    inv_area = f(RF_INV_AREA)
    lc = [ec[k] * inv_area for k in range(3)]

    def linear(w):
        center = lc[0] * w[0] + lc[1] * w[1] + lc[2] * w[2]
        gx = inv_area * (ea[0] * w[0] + ea[1] * w[1] + ea[2] * w[2])
        gy = inv_area * (eb[0] * w[0] + eb[1] * w[1] + eb[2] * w[2])
        return center, gx, gy

    chans = [
        linear([f(RF_AW + 4 * k + cc) for k in range(3)])
        for cc in range(n_ch)
    ]
    return chans, linear([f(RF_IW + k) for k in range(3)])


def fill_keep(class_code, f, pxc, pyc, offsets):
    """Per-sample coverage of one fill entry (edge test plus the
    Loop-Blinn implicit curve test of its class), one bool array per
    sample.  The reference's fill fragment predicate
    (shaders.wgsl:233-300)."""
    ea, eb, ec = _edge_functions(f, pxc, pyc)
    flags = f.i(RI_FLAGS)
    tl = [(flags & (1 << k)) != 0 for k in range(3)]
    n_ch = {CLS_FILL_SOLID: 0, CLS_FILL_QUAD: 3, CLS_FILL_CUBIC: 4}[
        class_code
    ]
    chans, _ = _interpolants(f, ea, eb, ec, n_ch) if n_ch else ([], None)
    out = []
    for ox, oy in offsets:
        dx, dy = float(ox) - 0.5, float(oy) - 0.5
        keep = _inside(ea, eb, ec, tl, dx, dy)
        v = [c + (gx * dx + gy * dy) for c, gx, gy in chans]
        if class_code == CLS_FILL_QUAD:
            keep = keep & (v[0] * v[0] - v[1] * v[2] <= 0.0)
        elif class_code == CLS_FILL_CUBIC:
            keep = keep & (v[0] * v[0] * v[0] - v[1] * v[2] * v[3] <= 0.0)
        out.append(keep)
    return out


def stroke_keep(joint, dash_mode, f, desc, pxc, pyc, offsets,
                cap_fn=_cap_mask_scalar):
    """Per-sample coverage of one stroke entry: edge test, then the
    perspective-correct stroke coordinates and the cap / dash / joint
    predicates (shaders.wgsl:155-231).  `joint` and `dash_mode` (0 solid,
    1 single-interval, 2 general) are static; `desc(col, is_int)` reads
    the entry's stroke-group descriptor.  `cap_fn` picks the scalar-cap
    switch (kernel) or the where-chain (per-tile cap types)."""
    ea, eb, ec = _edge_functions(f, pxc, pyc)
    flags = f.i(RI_FLAGS)
    tl = [(flags & (1 << k)) != 0 for k in range(3)]
    chans, (iw_c, gxw, gyw) = _interpolants(
        f, ea, eb, ec, 3 if joint else 2
    )
    if dash_mode:
        df = [desc(k, False) for k in range(9)]
        di = [desc(k, True) for k in range(9)]
        dash = _dash_mask_single if dash_mode == 1 else _dash_mask_general
    out = []
    for ox, oy in offsets:
        dx, dy = float(ox) - 0.5, float(oy) - 0.5
        inside = _inside(ea, eb, ec, tl, dx, dy)
        iws = iw_c + (gxw * dx + gyw * dy)
        inv = 1.0 / jnp.where(iws != 0.0, iws, 1.0)
        tex = [(c + (gx * dx + gy * dy)) * inv for c, gx, gy in chans]
        if joint:
            radius = jnp.sqrt(tex[0] * tex[0] + tex[1] * tex[1])
            join = desc(10, True)
            is_tip = (flags & FLAG_JOINT_TIP) != 0
            # Miter keeps everything, bevel drops tip triangles, round
            # keeps the half-width disc (shaders.wgsl:191-203); the
            # `radius >= 0` terms reject NaN coordinates.
            keep = jnp.where(
                join == int(Join.ROUND),
                radius <= 0.5,
                (radius >= 0.0)
                & ~((join == int(Join.BEVEL)) & is_tip),
            )
            if dash_mode:
                angle = jnp.arctan2(tex[1], tex[0]) * jnp.float32(1.0 / TAU)
                keep = keep & dash(df, di, radius, tex[2] + angle)
        elif dash_mode:
            keep = dash(df, di, tex[0], tex[1])
        else:
            end_cap = cap_fn(
                desc(12, True), tex[0], tex[1] - f(RF_END_Y)
            )
            start_cap = cap_fn(desc(11, True), tex[0], -tex[1])
            end_flag = (flags & FLAG_END_CAP) != 0
            keep = jnp.where(
                end_flag, end_cap, (tex[1] >= 0.0) | start_cap
            )
        out.append(inside & keep)
    return out


def apply_cover(spec: FrameSpec, st: RasterState, op, in_hull, clip_ok,
                depth, layer, draw, pk, px, py) -> RasterState:
    """One cover draw on the frame state: the reference's cover
    stencil/blend states (renderer.rs:692-861, shaders.wgsl:302-355).

    `op` is a static OP_* code; `in_hull` the per-sample hull mask
    (already gated by tile activity); `clip_ok` per-sample clip tests or
    None; `depth`/`layer` the command's clip depth and alpha layer;
    `draw(col)` reads the draw's float row (cmd_f columns, then
    DRAW_PAINT / DRAW_ZPLANE); `pk` the paint code; `px`/`py` the
    per-sample pixel coordinates."""
    S = spec.samples
    has_depth = spec.depth_write or spec.depth_compare != "always"
    blend_color, blend_alpha = _canonical_blend(spec.blending)
    uses_const = blend_uses_constant(spec.blending)
    ca = draw(3)

    def masked(extra=None):
        out = []
        for s in range(S):
            m = in_hull[s]
            if extra is not None:
                m = m & extra[s]
            if clip_ok is not None:
                m = m & clip_ok[s]
            out.append(m)
        return out

    if op == OP_COLOR:
        # Stencil Less → Zero: paint where winding nonzero within clip,
        # reset winding (renderer.rs:736-754).
        winding_mask = (1 << spec.winding_bits) - 1
        mask = masked([(w & winding_mask) != 0 for w in st.wind])
        zval = None
        if has_depth:
            # Fragment depth: the draw's NDC-z plane at each sample.
            # Only the color cover tests / writes depth, like the
            # reference's pipelines (renderer.rs:736-745 vs 601-841);
            # stencil pass_op fires only when depth also passes
            # (depth_fail_op is Keep, renderer.rs:442).
            zval = [
                draw(DRAW_ZPLANE) * px[s] + draw(DRAW_ZPLANE + 1) * py[s]
                + draw(DRAW_ZPLANE + 2)
                for s in range(S)
            ]
            cmp = {
                "never": lambda z, d: jnp.zeros_like(z, jnp.bool_),
                "less": lambda z, d: z < d,
                "equal": lambda z, d: z == d,
                "less_equal": lambda z, d: z <= d,
                "greater": lambda z, d: z > d,
                "not_equal": lambda z, d: z != d,
                "greater_equal": lambda z, d: z >= d,
                "always": None,
            }[spec.depth_compare]
            if cmp is not None:
                mask = [
                    mask[s] & cmp(zval[s], st.depth[s]) for s in range(S)
                ]
        const = (
            tuple(draw(20 + k) for k in range(4)) if uses_const else None
        )

        def blend(src):
            # Generic wgpu blend state (renderer.rs:381); destination
            # alpha is sampled before any channel updates.  Each source
            # channel is a scalar or a per-sample list.
            def at(v, s):
                return v[s] if isinstance(v, (list, tuple)) else v

            return tuple(
                tuple(
                    jnp.where(
                        mask[s],
                        _blend_channel(
                            blend_alpha if chan == 3 else blend_color,
                            at(src[chan], s), st.color[chan][s],
                            at(src[3], s), st.color[3][s], chan, const,
                        ),
                        st.color[chan][s],
                    )
                    for s in range(S)
                )
                for chan in range(4)
            )

        def solid():
            r, g, b = draw(0), draw(1), draw(2)
            return blend((r * ca, g * ca, b * ca, ca))

        def gradient():
            # Gradient paints: per-sample t along the projected
            # endpoints, multi-stop ramp, then premultiply.
            pax, pay = draw(DRAW_PAINT), draw(DRAW_PAINT + 1)
            pdx = draw(DRAW_PAINT + 2) - pax
            pdy = draw(DRAW_PAINT + 3) - pay
            pden = jnp.maximum(pdx * pdx + pdy * pdy, jnp.float32(1e-12))
            rgba = [[], [], [], []]
            for s in range(S):
                rel_x = px[s] - pax
                rel_y = py[s] - pay
                t_lin = (rel_x * pdx + rel_y * pdy) / pden
                t_rad = jnp.sqrt((rel_x * rel_x + rel_y * rel_y) / pden)
                t = jnp.clip(jnp.where(pk == 2, t_rad, t_lin), 0.0, 1.0)
                # c(t) = c0 + Σᵢ (cᵢ₊₁−cᵢ)·clip((t−oᵢ)/Δoᵢ): each term
                # ramps in over its own segment (degenerate Δo → hard
                # stop via eps).
                fs = [
                    jnp.clip(
                        (t - draw(16 + i)) / jnp.maximum(
                            draw(17 + i) - draw(16 + i), jnp.float32(1e-6)
                        ),
                        0.0, 1.0,
                    )
                    for i in range(MAX_STOPS - 1)
                ]
                for ch in range(4):
                    v = draw(ch)
                    for i in range(MAX_STOPS - 1):
                        v = v + (draw(4 * (i + 1) + ch) - draw(4 * i + ch)) \
                            * fs[i]
                    rgba[ch].append(v)
            a = rgba[3]
            return blend(tuple(
                [rgba[ch][s] * a[s] for s in range(S)] for ch in range(3)
            ) + (a,))

        def user(fn):
            # User paints (renderer.UserPaint): the fn returns straight
            # RGBA per sample; premultiplied here like the gradients.
            anchor = tuple(draw(DRAW_PAINT + k) for k in range(4))
            rgba = [[], [], [], []]
            for s in range(S):
                for ch, v in enumerate(fn(px[s], py[s], anchor)):
                    rgba[ch].append(v)
            a = rgba[3]
            return blend(tuple(
                [rgba[ch][s] * a[s] for s in range(S)] for ch in range(3)
            ) + (a,))

        if spec.paints and any(spec.paints):
            branches = [solid, gradient] + [
                (lambda fn=fn: user(fn)) for fn in _user_paint_fns(spec)
            ]
            index = jnp.where(pk == 0, 0, jnp.where(pk <= 2, 1, pk - 1))
            color = jax.lax.switch(index, branches)
        else:
            color = solid()
        wind = tuple(
            jnp.where(mask[s], 0, st.wind[s]) for s in range(S)
        )
        out_depth = st.depth
        if has_depth and spec.depth_write:
            # Write-back for fragments that passed every test.
            out_depth = tuple(
                jnp.where(mask[s], zval[s], st.depth[s]) for s in range(S)
            )
        return st._replace(wind=wind, color=color, depth=out_depth)

    if op in (OP_CLIP, OP_UNCLIP):
        if op == OP_CLIP:
            # Replace on NotEqual: promote winding≠0 into the clip
            # counter (renderer.rs:692-710).
            winding_mask = (1 << spec.winding_bits) - 1
            mask = [
                in_hull[s] & ((st.wind[s] & winding_mask) != 0)
                for s in range(S)
            ]
        else:
            # Replace on Less: demote deeper samples
            # (renderer.rs:711-729).
            mask = [in_hull[s] & (st.clip[s] > depth) for s in range(S)]
        return st._replace(
            clip=tuple(
                jnp.where(mask[s], depth, st.clip[s]) for s in range(S)
            ),
            wind=tuple(
                jnp.where(mask[s], 0, st.wind[s]) for s in range(S)
            ),
        )

    # Alpha-group ops (renderer.rs:767-861, shaders.wgsl:311-355).
    mask = masked()
    alpha = st.color[3]

    def save(values):
        return tuple(
            tuple(
                jnp.where(mask[s] & (layer == li), values[s], saved[s])
                for s in range(S)
            )
            for li, saved in enumerate(st.layer)
        )

    def scaled(a):
        # frame.alpha ← (1-g) + g·frame.alpha
        return tuple(
            jnp.where(mask[s], (1.0 - ca) + ca * a[s], a[s])
            for s in range(S)
        )

    color = st.color
    layers = st.layer
    if op == OP_SAVE_ALPHA:
        layers = save(alpha)
    elif op == OP_SCALE_ALPHA:
        color = color[:3] + (scaled(alpha),)
    elif op == OP_SAVE_SCALE:
        # Fused alpha-group prologue: snapshot, then rescale, over the
        # identical hull/clip mask.
        layers = save(alpha)
        color = color[:3] + (scaled(alpha),)
    elif op == OP_RESTORE_ALPHA:
        # frame.alpha ← frame.alpha − (1−saved)(1−g) (reverse subtract).
        saved = [
            sum(
                jnp.where(layer == li, sv[s], 0.0)
                for li, sv in enumerate(st.layer)
            )
            for s in range(S)
        ]
        color = color[:3] + (tuple(
            jnp.where(
                mask[s], alpha[s] - (1.0 - saved[s]) * (1.0 - ca), alpha[s]
            )
            for s in range(S)
        ),)
    else:
        raise ValueError(f"not a cover op: {op}")
    return st._replace(color=color, layer=layers)


def cover_ops(spec: FrameSpec):
    """The cover op codes this frame program compiles, in the order of
    their `lax.switch` branches (op code − 1 → branch)."""
    has_clip, has_alpha, _, _ = _frame_features(spec)
    present = {OP_COLOR}
    if has_clip:
        present |= {OP_CLIP, OP_UNCLIP}
    if has_alpha:
        present |= {OP_SAVE_ALPHA, OP_SCALE_ALPHA, OP_RESTORE_ALPHA,
                    OP_SAVE_SCALE}
    return [op if op in present else None for op in range(1, 8)]


def resolve(spec: FrameSpec, color):
    """Average the samples; packed RGBA8 (R | G<<8 | B<<16 | A<<24,
    bit-identical to Renderer._quantize: floor(clip·255 + 0.5)) when
    the frame resolves to uint8, else the four float channels."""
    inv_s = jnp.float32(1.0 / spec.samples)
    chans = []
    for chan in range(4):
        acc = color[chan][0]
        for s in range(1, spec.samples):
            acc = acc + color[chan][s]
        chans.append(acc * inv_s)
    if not spec.out_uint8:
        return chans
    q = [
        jnp.floor(jnp.clip(v, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.int32)
        for v in chans
    ]
    # A<<24 wraps into the int32 sign bit for A >= 128: the bit pattern
    # is exactly the little-endian RGBA8 quad the host bitcasts back.
    return q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24)


#: Stroke classes in walk order: (class, joint, dash mode).
STROKE_CLASSES = (
    (CLS_LINE_SOLID, False, 0),
    (CLS_LINE_DASH1, False, 1),
    (CLS_LINE_DASHN, False, 2),
    (CLS_JOINT_SOLID, True, 0),
    (CLS_JOINT_DASH1, True, 1),
    (CLS_JOINT_DASHN, True, 2),
)
FILL_CLASSES = (CLS_FILL_SOLID, CLS_FILL_QUAD, CLS_FILL_CUBIC)

# Per-draw float row (cmd_f columns first, then these): gradient
# endpoints in pixels, the NDC-z plane, and the hull lines (4 per line).
DRAW_PAINT = 24
DRAW_ZPLANE = 28
DRAW_HULL = 32


def draw_table(spec: FrameSpec, prepared: "PreparedFrame", cmd_f):
    """One float row per cover draw: cmd_f (padded to 24 columns),
    paint endpoints, depth plane and flattened hull lines."""
    Rc = prepared.hull_lines.shape[0]
    cmd_f = jnp.asarray(cmd_f, jnp.float32)
    return jnp.concatenate(
        [
            jnp.pad(cmd_f, ((0, 0), (0, DRAW_PAINT - cmd_f.shape[1]))),
            prepared.paint_xy,
            prepared.zplane,
            jnp.zeros((Rc, 1), jnp.float32),
            prepared.hull_lines.reshape(Rc, -1),
        ],
        axis=1,
    )


class _Row:
    """Column reader of one binned entry: `row(col)` reads its float
    row, `row.i(col)` its int row."""

    def __init__(self, read_f, read_i):
        self._f = read_f
        self.i = read_i

    def __call__(self, col):
        return self._f(col)


# ---------------------------------------------------------------------------
# rasterize: the Triton kernel
# ---------------------------------------------------------------------------


def interpret_for_platform(platform: str) -> bool:
    """Kernel execution mode for a JAX platform: the CPU runs the kernel
    in Pallas interpret mode (tests), the GPU runs it compiled through
    Triton; any other backend has no kernel route and is an error."""
    if platform == "cpu":
        return True
    if platform in ("gpu", "cuda"):
        return False
    raise RuntimeError(
        f"no raster kernel for the {platform!r} backend (supported: "
        "'gpu' through Triton, 'cpu' in interpret mode for tests)"
    )


def check_frame_size(spec: FrameSpec):
    """Raise FrameTooComplex when the per-tile tables outgrow int32
    indexing: binning keys (tile, command, class) as one int32, and the
    kernel addresses (tile × draw) tables with int32 offsets."""
    draws = draw_tables(spec)
    n = spec.n_tiles * max(
        N_CLASSES * spec.n_commands + 1, len(draws.c_cmd),
        len(draws.unit_cmd),
    )
    if n >= 1 << 31:
        from ..error import FrameTooComplex

        raise FrameTooComplex(
            f"{spec.n_tiles} tiles × {spec.n_commands} commands / "
            f"{len(draws.c_cmd)} cover draws exceed int32 table "
            "indexing; instance repeated shapes so draws share commands, "
            "or split the frame"
        )


def make_rasterize(spec: FrameSpec):
    """The frame kernel: one Triton program per (tile_h × tile_w) tile.

    The tile's per-sample state (winding, RGBA, and clip depth, alpha
    layers and depth where the frame uses them) is the carry of the
    command walk, so it stays in registers from the first command to
    the resolve; only the resolved tile is written to device memory.
    Stencil commands walk the tile's binned entries per class (stroke
    classes before fill classes, preserving the reference's draw order,
    renderer.rs:275-336); cover draws apply the reference's stencil and
    blend states inside the hull."""
    check_frame_size(spec)
    draws = draw_tables(spec)
    W, H = spec.width, spec.height
    th, tw = spec.tile_h, spec.tile_w
    ntx, nty, n_tiles = spec.ntx, spec.nty, spec.n_tiles
    K = spec.capacity
    KE = spec.capacity + spec.tile_global_capacity
    NB = spec.fill_batch
    SBS = spec.stroke_batch
    S = spec.samples
    offsets = SAMPLE_PATTERNS[S]
    has_clip, _, _, _ = _frame_features(spec)
    ops_by_branch = cover_ops(spec)

    def kernel(cmd_i, draw_f, unit_cmd, unit_draw, acount, aclist, off,
               g_off, bulk, cls, hbits, tri_f, tri_i, desc_f, desc_i,
               out_ref):
        t = pl.program_id(0)
        x0 = (t % ntx).astype(jnp.float32) * tw
        y0 = (t // ntx).astype(jnp.float32) * th
        col = jax.lax.broadcasted_iota(jnp.int32, (th, tw), 1).astype(
            jnp.float32
        )
        row = jax.lax.broadcasted_iota(jnp.int32, (th, tw), 0).astype(
            jnp.float32
        )
        px = [x0 + col + float(ox) for ox, _ in offsets]
        py = [y0 + row + float(oy) for _, oy in offsets]
        # The entry predicates evaluate every linear function once at
        # pixel centers and reach each sample by a scalar shift.
        pxc = x0 + col + 0.5
        pyc = y0 + row + 0.5

        def entry(r):
            return _Row(lambda k: tri_f[t, r, k], lambda k: tri_i[t, r, k])

        def walk(wind, c, cls_code, batch, step):
            """Run `step(wind, rows, valid)` over the tile's entries of
            (command c, class): local rows [lo, lo+nl) then global rows
            K + [glo, glo+ng), `batch` entries per iteration (the batch
            tail is masked by `valid`)."""
            key = N_CLASSES * c + cls_code
            lo = off[t, key]
            nl = off[t, key + 1] - lo
            glo = g_off[t, key] + K
            n = nl + g_off[t, key + 1] - g_off[t, key]

            def body(b_ix, wind):
                rows, valid = [], []
                for k in range(batch):
                    j = b_ix * batch + k
                    r = jnp.where(j < nl, lo + j, glo + (j - nl))
                    rows.append(jnp.minimum(r, KE - 1))
                    valid.append(j < n)
                return step(wind, rows, valid)

            return jax.lax.fori_loop(
                0, (n + batch - 1) // batch, body, wind
            )

        def stencil(st, c, clip_ok):
            wind = st.wind

            def stroke_step(joint, dash_mode):
                def step(wind, rows, valid):
                    cov = None
                    for r, ok in zip(rows, valid):
                        ent = entry(r)
                        grp = ent.i(RI_GROUP)

                        def desc(k, is_int, grp=grp):
                            return (desc_i if is_int else desc_f)[grp, k]

                        keep = stroke_keep(
                            joint, dash_mode, ent, desc, pxc, pyc, offsets
                        )
                        keep = [k_ & ok for k_ in keep]
                        cov = keep if cov is None else [
                            a | b for a, b in zip(cov, keep)
                        ]
                    # Stroke stencil is Equal-0 + IncrementWrap
                    # (renderer.rs:571-576): a sample ends at winding 1
                    # iff any stroke entry of the command covers it.
                    return tuple(
                        jnp.where(
                            cov[s] & (wind[s] == 0)
                            & (clip_ok[s] if clip_ok else True),
                            1, wind[s],
                        )
                        for s in range(S)
                    )
                return step

            def fill_step(cls_code):
                def step(wind, rows, valid):
                    delta = None
                    for r, ok in zip(rows, valid):
                        ent = entry(r)
                        contrib = jnp.where(ok, ent.i(RI_CONTRIB), 0)
                        keep = fill_keep(cls_code, ent, pxc, pyc, offsets)
                        d = [jnp.where(k_, contrib, 0) for k_ in keep]
                        delta = d if delta is None else [
                            a + b for a, b in zip(delta, d)
                        ]
                    if clip_ok:
                        delta = [
                            jnp.where(clip_ok[s], delta[s], 0)
                            for s in range(S)
                        ]
                    return tuple(wind[s] + delta[s] for s in range(S))
                return step

            if spec.has_strokes:
                for cls_code, joint, dash_mode in STROKE_CLASSES:
                    wind = walk(
                        wind, c, cls_code, SBS,
                        stroke_step(joint, dash_mode),
                    )
            # Fill classes: winding adds commute within a command.
            for cls_code in FILL_CLASSES:
                wind = walk(wind, c, cls_code, NB, fill_step(cls_code))
            b = bulk[t, c]
            wind = tuple(
                wind[s] + (jnp.where(clip_ok[s], b, 0) if clip_ok else b)
                for s in range(S)
            )
            return st._replace(wind=wind)

        def cover(st, c, d, op, depth, layer, clip_ok):
            cl = cls[t, d]

            def active(st):
                # Boundary tiles AND in only the hull lines that cross
                # the tile (prepare's bitmask), lowest set bit first;
                # fully-inside tiles (cl == 2) test none.
                def line(carry):
                    bits, m = carry
                    h = jax.lax.population_count((bits & -bits) - 1)
                    base = DRAW_HULL + 4 * h
                    a = draw_f[d, base]
                    b = draw_f[d, base + 1]
                    e = draw_f[d, base + 2]
                    m = tuple(
                        m[s] & (a * px[s] + b * py[s] + e >= 0.0)
                        for s in range(S)
                    )
                    return bits & (bits - 1), m

                _, in_hull = jax.lax.while_loop(
                    lambda carry: carry[0] != 0, line,
                    (jnp.where(cl == 2, 0, hbits[t, d]),
                     tuple(jnp.ones((th, tw), jnp.bool_)
                           for _ in range(S))),
                )
                pk = cmd_i[c, 3]

                def branch(op_code):
                    if op_code is None:
                        return lambda st: st
                    return lambda st: apply_cover(
                        spec, st, op_code, in_hull, clip_ok, depth, layer,
                        lambda k: draw_f[d, k], pk, px, py,
                    )

                return jax.lax.switch(
                    op - 1, [branch(o) for o in ops_by_branch], st
                )

            return jax.lax.cond(cl > 0, active, lambda st: st, st)

        def unit(k, st):
            # A unit is a whole stencil command or one cover draw; the
            # walk replays the tile's active units in global draw order.
            uid = aclist[t, k]
            c = unit_cmd[uid]
            d = unit_draw[uid]  # cover-draw index; -1 for stencil units
            op = cmd_i[c, 0]
            depth = cmd_i[c, 1]
            layer = cmd_i[c, 2]
            clip_ok = (
                [cb == depth for cb in st.clip] if has_clip else None
            )

            def run(st):
                return jax.lax.cond(
                    op == OP_STENCIL,
                    lambda st: stencil(st, c, clip_ok),
                    lambda st: cover(st, c, d, op, depth, layer, clip_ok),
                    st,
                )

            if has_clip:
                return run(st)
            # Without clip commands the clip buffer is identically zero,
            # so the clip test collapses to the scalar `depth == 0`:
            # commands at nonzero depth are no-ops.
            return jax.lax.cond(depth == 0, run, lambda st: st, st)

        st = jax.lax.fori_loop(
            0, acount[t], unit, _initial_state(spec, (th, tw))
        )
        out = resolve(spec, st.color)
        if spec.out_uint8:
            out_ref[...] = out
        else:
            for chan in range(4):
                out_ref[chan] = out[chan]

    if spec.out_uint8:
        # Each tile's packed-RGBA8 block lands at its final position.
        out_specs = pl.BlockSpec((th, tw), lambda i: (i // ntx, i % ntx))
        out_shape = jax.ShapeDtypeStruct((nty * th, ntx * tw), jnp.int32)
    else:
        out_specs = pl.BlockSpec(
            (4, th, tw), lambda i: (0, i // ntx, i % ntx)
        )
        out_shape = jax.ShapeDtypeStruct(
            (4, nty * th, ntx * tw), jnp.float32
        )
    whole = pl.BlockSpec(memory_space=pl.ANY)
    raster_call = pl.pallas_call(
        kernel,
        grid=(n_tiles,),
        in_specs=[whole] * 15,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=spec.interpret,
        name="raster_tiles",
    )
    unit_cmd_dev = jnp.asarray(draws.unit_cmd)
    unit_draw_dev = jnp.asarray(draws.unit_draw)

    def rasterize(prepared: PreparedFrame, cmd_i, cmd_f, desc_f, desc_i):
        tiles = raster_call(
            cmd_i, draw_table(spec, prepared, cmd_f),
            unit_cmd_dev, unit_draw_dev,
            prepared.acount, prepared.aclist, prepared.off, prepared.g_off,
            prepared.bulk, prepared.cls, prepared.hbits,
            prepared.tri_f, prepared.tri_i, desc_f, desc_i,
        )
        if spec.out_uint8:
            # (H', W') int32 → (H, W, 4) uint8: a bitcast view of the
            # little-endian RGBA quads.
            return jax.lax.bitcast_convert_type(tiles[:H, :W], jnp.uint8)
        return jnp.moveaxis(tiles[:, :H, :W], 0, -1)

    return rasterize
