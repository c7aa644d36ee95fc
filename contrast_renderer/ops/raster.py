"""Tiled fill rasterization: triangle tables → per-sample winding.

The JAX replacement for the reference's stencil pass
(src/renderer.rs:571-690, src/shaders.wgsl:233-266): instead of triangle
rasterization hardware updating stencil winding counters, a jitted array
program

1. transforms triangles by the instance matrix (batched matmul),
2. computes per-triangle edge and attribute-interpolation coefficients,
3. bins triangles to pixel tiles by AABB overlap,
4. accumulates, per tile, a per-sample winding count: each fill triangle
   contributes sign(NDC area) where the sample is inside and the
   implicit-curve predicate of its kind holds (perspective-correct
   interpolation of the Loop-Blinn weights).

Everything is static-shaped: triangle tables are padded, per-tile
triangle lists have a fixed capacity (overflow is reported for the host
to retry with a larger capacity).

Pixel space is y-down image coordinates; NDC is y-up;
``px = (ndc_x+1)/2·W``, ``py = (1-ndc_y)/2·H``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..vertex import (
    KIND_INTEGRAL_CUBIC,
    KIND_INTEGRAL_QUADRATIC,
    KIND_RATIONAL_CUBIC,
    KIND_RATIONAL_QUADRATIC,
    KIND_SOLID,
    KIND_STROKE_JOINT,
    KIND_STROKE_LINE,
)

#: Standard 4x MSAA sample offsets within a pixel (x, y), y-down
#: (matches oracle.MSAA4).
MSAA4 = np.array(
    [[0.375, 0.125], [0.875, 0.375], [0.125, 0.625], [0.625, 0.875]],
    dtype=np.float32,
)
MSAA1 = np.array([[0.5, 0.5]], dtype=np.float32)


class TriangleSetup(NamedTuple):
    """Per-triangle screen-space coefficients (all leading dim T).

    Edge/barycentric lines are stored origin-relative — evaluated as
    ``a*(px - ox) + b*(py - oy)`` with the origin at one of the edge's
    own endpoints — so float32 evaluation at large pixel coordinates
    stays well conditioned (the subtraction of nearby coordinates is
    exact, and the products are O(triangle size), not O(screen size)).
    """

    edge: jnp.ndarray  # (T, 3, 4) oriented edges (a, b, ox, oy); e ≥ 0 inside
    edge_top_left: jnp.ndarray  # (T, 3) bool: edge uses ≥ (top-left) vs >
    bary: jnp.ndarray  # (T, 3, 4) barycentric edges (a, b, ox, oy) / area
    aux_w: jnp.ndarray  # (T, 3, 4) per-vertex aux * inv_w
    inv_w: jnp.ndarray  # (T, 3)
    kind: jnp.ndarray  # (T,) int32
    contribution: jnp.ndarray  # (T,) int32 winding increment (0 if degenerate)
    meta: jnp.ndarray  # (T, 2) f32 stroke group/flags, end texcoord y
    aabb: jnp.ndarray  # (T, 4) pixel-space min_x, min_y, max_x, max_y


def setup_triangles(xy, aux, kind, meta, transform, width, height):
    """Transform model-space triangles and compute screen coefficients.

    `transform` is a standard row-major 4x4; model vertices are lifted as
    (x, y, 0, 1).  Perspective-correct interpolation: aux/w and 1/w are
    interpolated linearly in screen space.
    """
    xy = jnp.asarray(xy, jnp.float32)
    aux = jnp.asarray(aux, jnp.float32)
    kind = jnp.asarray(kind, jnp.int32)
    meta = jnp.asarray(meta, jnp.float32)
    transform = jnp.asarray(transform, jnp.float32)
    t = xy.shape[0]
    v = jnp.concatenate(
        [xy, jnp.zeros((t, 3, 1), jnp.float32), jnp.ones((t, 3, 1), jnp.float32)],
        axis=-1,
    )
    # Full f32 precision: default-precision einsums may run in reduced
    # precision (TF32 on the GPU), whose ~1e-3 error flips the cancellation-sensitive
    # Loop-Blinn predicates along curve boundaries.
    clip = jnp.einsum(
        "tvc,rc->tvr", v, transform, precision=jax.lax.Precision.HIGHEST
    )
    w = clip[..., 3]
    inv_w = 1.0 / w
    ndc = clip[..., :2] * inv_w[..., None]
    px = (ndc[..., 0] + 1.0) * (0.5 * width)
    py = (1.0 - ndc[..., 1]) * (0.5 * height)
    pix = jnp.stack([px, py], axis=-1)  # (T, 3, 2)

    v0, v1, v2 = pix[:, 0], pix[:, 1], pix[:, 2]
    area = (v1[:, 0] - v0[:, 0]) * (v2[:, 1] - v0[:, 1]) - (
        v1[:, 1] - v0[:, 1]
    ) * (v2[:, 0] - v0[:, 0])
    orient = jnp.sign(area)
    finite = jnp.all(jnp.isfinite(pix), axis=(1, 2)) & jnp.isfinite(area)
    # Only front-of-camera triangles are drawn; clipping against the near
    # plane is not needed for 2D scenes with well-behaved cameras.
    visible = finite & (area != 0.0) & jnp.all(w > 0.0, axis=1)

    # Oriented edge lines with top-left fill rule (shared edges stay
    # watertight for winding accumulation).
    edges = []
    top_lefts = []
    for a_idx, b_idx in ((0, 1), (1, 2), (2, 0)):
        a = pix[:, a_idx]
        b = pix[:, b_idx]
        # e(p) = (b.x-a.x)(p.y-a.y) - (b.y-a.y)(p.x-a.x), oriented by sign(area)
        ea = -(b[:, 1] - a[:, 1]) * orient
        eb = (b[:, 0] - a[:, 0]) * orient
        # Orientation-normalized endpoints for the top-left test.
        aa = jnp.where(orient[:, None] > 0, a, b)
        bb = jnp.where(orient[:, None] > 0, b, a)
        top_left = ((aa[:, 1] == bb[:, 1]) & (bb[:, 0] > aa[:, 0])) | (
            bb[:, 1] > aa[:, 1]
        )
        edges.append(jnp.stack([ea, eb, a[:, 0], a[:, 1]], axis=-1))
        top_lefts.append(top_left)
    edge = jnp.stack(edges, axis=1)  # (T, 3, 4)
    edge_top_left = jnp.stack(top_lefts, axis=1)

    # Barycentric coordinate lines: λ0 opposes edge (v1,v2), etc.
    inv_area = jnp.where(area != 0.0, 1.0 / area, 0.0)

    def bary_line(a, b):
        ea = -(b[:, 1] - a[:, 1]) * inv_area
        eb = (b[:, 0] - a[:, 0]) * inv_area
        return jnp.stack([ea, eb, a[:, 0], a[:, 1]], axis=-1)

    bary = jnp.stack(
        [bary_line(v1, v2), bary_line(v2, v0), bary_line(v0, v1)], axis=1
    )

    is_fill = kind <= KIND_RATIONAL_CUBIC
    # NDC-space orientation is the negation of pixel-space orientation
    # (the viewport flips y); NDC-CCW contributes +1 (fill.py winding
    # convention).
    contribution = jnp.where(
        visible & is_fill, -orient.astype(jnp.int32), 0
    )
    stroke_mask = visible & ~is_fill
    contribution = jnp.where(stroke_mask, 1, contribution)

    aabb = jnp.concatenate(
        [jnp.min(pix, axis=1), jnp.max(pix, axis=1)], axis=-1
    )
    aabb = jnp.where(visible[:, None], aabb, jnp.float32(-1e9))

    return TriangleSetup(
        edge=edge,
        edge_top_left=edge_top_left,
        bary=bary,
        aux_w=aux * inv_w[..., None],
        inv_w=inv_w,
        kind=kind,
        contribution=contribution,
        meta=meta,
        aabb=aabb,
    )


def bin_triangles(aabb, contribution, num_tiles_x, num_tiles_y, tile_size, capacity):
    """Assign triangles to tiles by AABB overlap.

    Returns (indices (Ntiles, K) int32, valid (Ntiles, K) bool,
    max_count ()): for each tile, the indices of overlapping triangles
    (order-preserving) padded to capacity; `max_count` lets the host
    detect capacity overflow.
    """
    n_tiles = num_tiles_x * num_tiles_y
    tx = jnp.arange(n_tiles, dtype=jnp.int32) % num_tiles_x
    ty = jnp.arange(n_tiles, dtype=jnp.int32) // num_tiles_x
    tile_min_x = (tx * tile_size).astype(jnp.float32)
    tile_min_y = (ty * tile_size).astype(jnp.float32)
    tile_max_x = tile_min_x + tile_size
    tile_max_y = tile_min_y + tile_size
    live = contribution != 0
    overlap = (
        (aabb[None, :, 0] <= tile_max_x[:, None])
        & (aabb[None, :, 2] >= tile_min_x[:, None])
        & (aabb[None, :, 1] <= tile_max_y[:, None])
        & (aabb[None, :, 3] >= tile_min_y[:, None])
        & live[None, :]
    )
    n_triangles = aabb.shape[0]
    # Compaction by rank: the k-th overlapping triangle of a tile lands in
    # slot k (cumsum + scatter; draw order preserved, overflow dropped).
    rank = jnp.cumsum(overlap.astype(jnp.int32), axis=1)
    slot = jnp.where(overlap, rank - 1, capacity)
    tile_index = jnp.broadcast_to(
        jnp.arange(n_tiles, dtype=jnp.int32)[:, None], slot.shape
    )
    tri_index = jnp.broadcast_to(
        jnp.arange(n_triangles, dtype=jnp.int32)[None, :], slot.shape
    )
    indices = (
        jnp.zeros((n_tiles, capacity), jnp.int32)
        .at[tile_index.ravel(), slot.ravel()]
        .set(tri_index.ravel(), mode="drop")
    )
    counts = rank[:, -1] if n_triangles else jnp.zeros(n_tiles, jnp.int32)
    valid = jnp.arange(capacity, dtype=jnp.int32)[None, :] < counts[:, None]
    return indices, valid, jnp.max(counts)


def interpolate_attributes(lam, aux_w):
    """Barycentric attribute interpolation as explicit multiply-adds.

    ``lam`` (..., K, 3), ``aux_w`` (K, 3, C) → (..., K, C).  Unrolled on
    purpose: an einsum at default precision may run in reduced
    precision (TF32 on the GPU), whose ~1e-3 error flips the
    cancellation-sensitive Loop-Blinn predicates (x³−y·z·w) along curve
    boundaries.  Three f32 multiply-adds are exact.
    """
    return (
        lam[..., 0, None] * aux_w[..., 0, :]
        + lam[..., 1, None] * aux_w[..., 1, :]
        + lam[..., 2, None] * aux_w[..., 2, :]
    )


def _fill_predicates(kind, value):
    """Per-sample implicit predicates by kind (shaders.wgsl:233-266).

    `kind` (K,), `value` (..., K, 4) perspective-corrected weights.
    """
    x, y, z, w = value[..., 0], value[..., 1], value[..., 2], value[..., 3]
    pred_solid = jnp.ones(x.shape, bool)
    # Integral kinds carry a constant-1 trailing channel so their
    # predicates share the homogeneous rational forms (fill.py rescales
    # weights per triangle for float32 conditioning).
    pred_iq = x * x - y * z <= 0.0
    pred_ic = x * x * x - y * z * w <= 0.0
    pred_rq = x * x - y * z <= 0.0
    pred_rc = x * x * x - y * z * w <= 0.0
    preds = jnp.stack(
        [pred_solid, pred_iq, pred_ic, pred_rq, pred_rc], axis=-1
    )
    k = jnp.clip(kind, 0, 4)
    return jnp.take_along_axis(
        preds, k[(None,) * (value.ndim - 2) + (slice(None), None)], axis=-1
    )[..., 0]


def make_fill_rasterizer(
    width,
    height,
    tile_size=32,
    capacity=256,
    sample_offsets=MSAA4,
):
    """Build a jitted function mapping padded triangle tables + transform
    to a per-sample winding buffer (H, W, S) int32.

    All sizing arguments are static; the returned function retraces only
    when the padded triangle count changes.
    """
    num_tiles_x = -(-width // tile_size)
    num_tiles_y = -(-height // tile_size)
    offsets = jnp.asarray(sample_offsets, jnp.float32)
    n_samples = offsets.shape[0]

    # Per-tile sample positions relative to the tile origin: (P, 2) with
    # P = tile_size² * S.
    yy, xx = jnp.meshgrid(
        jnp.arange(tile_size, dtype=jnp.float32),
        jnp.arange(tile_size, dtype=jnp.float32),
        indexing="ij",
    )
    base = jnp.stack([xx, yy], axis=-1)  # (th, tw, 2)
    local = base[:, :, None, :] + offsets[None, None, :, :]  # (th, tw, S, 2)
    local_flat = local.reshape(-1, 2)

    @jax.jit
    def rasterize(xy, aux, kind, meta, transform):
        setup = setup_triangles(xy, aux, kind, meta, transform, width, height)
        indices, valid, max_count = bin_triangles(
            setup.aabb,
            setup.contribution,
            num_tiles_x,
            num_tiles_y,
            tile_size,
            min(capacity, xy.shape[0]),
        )

        def tile_body(tile_index):
            tx = (tile_index % num_tiles_x).astype(jnp.float32) * tile_size
            ty = (tile_index // num_tiles_x).astype(jnp.float32) * tile_size
            pos = local_flat + jnp.stack([tx, ty])  # (P, 2)
            idx = indices[tile_index]  # (K,)
            tvalid = valid[tile_index]  # (K,)
            edge = setup.edge[idx]  # (K, 3, 3)
            top_left = setup.edge_top_left[idx]  # (K, 3)
            bary = setup.bary[idx]  # (K, 3, 3)
            aux_w = setup.aux_w[idx]  # (K, 3, 4)
            inv_w = setup.inv_w[idx]  # (K, 3)
            tkind = setup.kind[idx]  # (K,)
            contrib = setup.contribution[idx]  # (K,)

            # Edge values, origin-relative: (P, K, 3)
            e = (
                (pos[:, None, None, 0] - edge[None, :, :, 2]) * edge[None, :, :, 0]
                + (pos[:, None, None, 1] - edge[None, :, :, 3]) * edge[None, :, :, 1]
            )
            inside_e = (e > 0.0) | ((e == 0.0) & top_left[None, :, :])
            inside = jnp.all(inside_e, axis=-1)  # (P, K)
            # Barycentric, origin-relative: (P, K, 3)
            lam = (
                (pos[:, None, None, 0] - bary[None, :, :, 2]) * bary[None, :, :, 0]
                + (pos[:, None, None, 1] - bary[None, :, :, 3]) * bary[None, :, :, 1]
            )
            interp_aux = interpolate_attributes(lam, aux_w)
            # The fill predicates are homogeneous in the channels, so the
            # perspective division by the (positive) interpolated 1/w can
            # be skipped entirely: evaluating on aux/w-premultiplied
            # values preserves the sign of f.  (Also avoids approximate-
    # reciprocal codegen differences across XLA configurations.)
            keep = _fill_predicates(tkind, interp_aux)
            # This standalone rasterizer evaluates fill predicates only;
            # stroke kinds (dash/cap logic) would silently add bogus
            # winding if a mixed table were passed, so mask them out.
            is_fill = tkind <= KIND_RATIONAL_CUBIC
            active = inside & keep & (tvalid & is_fill)[None, :]
            winding = jnp.sum(
                jnp.where(active, contrib[None, :], 0), axis=1, dtype=jnp.int32
            )
            return winding.reshape(tile_size, tile_size, n_samples)

        tiles = jax.lax.map(
            tile_body, jnp.arange(num_tiles_x * num_tiles_y, dtype=jnp.int32)
        )
        image = tiles.reshape(
            num_tiles_y, num_tiles_x, tile_size, tile_size, n_samples
        )
        image = image.transpose(0, 2, 1, 3, 4).reshape(
            num_tiles_y * tile_size, num_tiles_x * tile_size, n_samples
        )
        return image[:height, :width], max_count

    return rasterize


def resolve_coverage(winding, winding_bits=4):
    """Winding rule: nonzero modulo 2**winding_bits
    (reference renderer.rs:399-402)."""
    return (winding % (1 << winding_bits)) != 0


def composite_color(coverage, color, background=None):
    """Premultiplied-alpha 'over' of a solid color through per-sample
    coverage, resolved by averaging the samples axis
    (reference shaders.wgsl:304-309 + MSAA resolve).

    `coverage` (H, W, S) bool, `color` (4,) straight RGBA; returns
    (H, W, 4) premultiplied RGBA.
    """
    color = jnp.asarray(color, jnp.float32)
    src = jnp.concatenate([color[:3] * color[3], color[3:4]])
    frac = jnp.mean(coverage.astype(jnp.float32), axis=-1)  # (H, W)
    layer = frac[..., None] * src[None, None, :]
    if background is None:
        return layer
    return layer + background * (1.0 - frac[..., None] * color[3])
