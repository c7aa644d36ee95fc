"""CPU reference rasterizers used as test oracles.

Two independent references:

1. :func:`ground_truth_winding` — flattens paths to dense polylines and
   computes exact polygon winding numbers per sample.  This is the
   semantic ground truth (independent of the tessellation pipeline) that
   both the scalar oracle and the device rasterizer are validated against,
   standing in for the reference wgpu renderer's output (SURVEY §4).

2. :func:`rasterize_fill_table` — a scalar numpy implementation of this
   renderer's device semantics: triangle edge functions, perspective-
   correct attribute interpolation, the implicit-curve predicates of
   reference src/shaders.wgsl:237-266, and signed-area winding
   accumulation (the stencil algebra of renderer.rs:577-582).

Pixel space is y-down image coordinates; NDC is y-up; the viewport
transform is ``px = (ndc_x+1)/2·W``, ``py = (1-ndc_y)/2·H``.
"""

from __future__ import annotations

import numpy as np

from . import curve as curvemod
from .path import Path, SegmentType
from .utils import ga2d
from .vertex import (
    KIND_INTEGRAL_CUBIC,
    KIND_INTEGRAL_QUADRATIC,
    KIND_RATIONAL_CUBIC,
    KIND_RATIONAL_QUADRATIC,
    KIND_SOLID,
    TriangleTable,
)

#: Standard 4x MSAA sample offsets within a pixel (x, y), y-down.
MSAA4 = np.array(
    [[0.375, 0.125], [0.875, 0.375], [0.125, 0.625], [0.625, 0.875]]
)
MSAA1 = np.array([[0.5, 0.5]])


def sample_positions(width, height, sample_offsets=MSAA4):
    """(H, W, S, 2) pixel-space sample positions."""
    xs = np.arange(width)[None, :, None, None]
    ys = np.arange(height)[:, None, None, None]
    off = np.asarray(sample_offsets, dtype=np.float64)
    pos = np.zeros((height, width, len(off), 2))
    pos[..., 0] = xs[..., 0] + off[None, None, :, 0]
    pos[..., 1] = ys[..., 0] + off[None, None, :, 1]
    return pos


# ---------------------------------------------------------------------------
# Ground truth: dense polyline winding
# ---------------------------------------------------------------------------

def flatten_path(path: Path, steps_per_curve: int = 256) -> np.ndarray:
    """Flatten a path into a dense closed polyline (model space)."""
    points = [np.asarray(path.start, dtype=np.float64)]
    ts = np.linspace(0.0, 1.0, steps_per_curve + 1)[1:]
    for segment_type, segment in path.iter_segments():
        if segment_type is SegmentType.LINE:
            points.append(segment.control_points[0])
        elif segment_type in (
            SegmentType.INTEGRAL_QUADRATIC_CURVE,
            SegmentType.RATIONAL_QUADRATIC_CURVE,
        ):
            w = getattr(segment, "weight", 1.0)
            cps = np.stack(
                [
                    ga2d.vec_to_point(points[-1]),
                    ga2d.weighted_vec_to_point(w, segment.control_points[0]),
                    ga2d.vec_to_point(segment.control_points[1]),
                ]
            )
            pb = curvemod.rational_quadratic_control_points_to_power_basis(cps)
            pts = curvemod.rational_quadratic_point(pb, ts)
            points.extend(ga2d.point_to_vec(pts))
        else:
            w = getattr(segment, "weights", np.ones(4))
            cps = np.stack(
                [ga2d.weighted_vec_to_point(w[0], points[-1])]
                + [
                    ga2d.weighted_vec_to_point(w[i + 1], segment.control_points[i])
                    for i in range(3)
                ]
            )
            pb = curvemod.rational_cubic_control_points_to_power_basis(cps)
            pts = curvemod.rational_cubic_point(pb, ts)
            points.extend(ga2d.point_to_vec(pts))
    return np.asarray(points)


def polyline_winding(polyline, positions) -> np.ndarray:
    """Winding number of each position w.r.t. a closed polyline.

    `polyline` is (n, 2) pixel-space points (implicitly closed);
    `positions` is (..., 2).  Uses the standard crossing rule; the sign
    convention is: a polyline that is counterclockwise in y-up NDC space
    (hence clockwise in y-down pixel space) gets winding +1 inside.
    """
    poly = np.asarray(polyline, dtype=np.float64)
    a = poly
    b = np.roll(poly, -1, axis=0)
    pos = np.asarray(positions, dtype=np.float64)
    px = pos[..., 0][..., None]
    py = pos[..., 1][..., None]
    ax, ay = a[:, 0], a[:, 1]
    bx, by = b[:, 0], b[:, 1]
    # Upward / downward crossing tests in pixel space (y-down).
    cross = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
    up = (ay <= py) & (by > py) & (cross > 0)
    down = (by <= py) & (ay > py) & (cross < 0)
    winding = up.sum(axis=-1).astype(np.int64) - down.sum(axis=-1).astype(np.int64)
    # In y-down pixel space the crossing rule above yields +1 for
    # pixel-space-CCW loops; negate so that NDC-CCW (pixel-CW) is +1.
    return -winding


def ground_truth_winding(paths, positions, model_to_pixel=None, steps_per_curve=256):
    """Total winding of filled `paths` at pixel-space `positions`.

    `model_to_pixel(points (n,2)) -> (n,2)` maps model space to pixel
    space (default identity).
    """
    total = np.zeros(positions.shape[:-1], dtype=np.int64)
    for path in paths:
        poly = flatten_path(path, steps_per_curve)
        if model_to_pixel is not None:
            poly = model_to_pixel(poly)
        total += polyline_winding(poly, positions)
    return total


def coverage_from_winding(winding, winding_bits=4):
    """The reference's winding rule: nonzero modulo 2**winding_bits
    (renderer.rs:399-402); winding_bits=1 gives even-odd."""
    return (np.asarray(winding) % (1 << winding_bits)) != 0


# ---------------------------------------------------------------------------
# Scalar oracle of the device semantics
# ---------------------------------------------------------------------------

def _transform_to_pixel(xy, transform, width, height):
    """Model (x, y) → (pixel_xy (…,2), one_over_w (…,)) through a standard
    row-major 4x4 matrix (clip = M @ [x, y, 0, 1])."""
    xy = np.asarray(xy, dtype=np.float64)
    ones = np.ones(xy.shape[:-1])
    zeros = np.zeros_like(ones)
    v = np.stack([xy[..., 0], xy[..., 1], zeros, ones], axis=-1)
    clip = v @ np.asarray(transform, dtype=np.float64).T
    w = clip[..., 3]
    ndc = clip[..., :2] / w[..., None]
    px = (ndc[..., 0] + 1.0) * 0.5 * width
    py = (1.0 - ndc[..., 1]) * 0.5 * height
    return np.stack([px, py], axis=-1), 1.0 / w


def fill_predicate(kind, aux):
    """The per-sample implicit curve predicates
    (reference shaders.wgsl:233-266).  `aux` is (..., 4)."""
    x, y, z, w = aux[..., 0], aux[..., 1], aux[..., 2], aux[..., 3]
    if kind == KIND_SOLID:
        return np.ones(x.shape, dtype=bool)
    if kind == KIND_INTEGRAL_QUADRATIC:
        return x * x - y * z <= 0.0  # z ≡ 1 channel (homogeneous form)
    if kind == KIND_INTEGRAL_CUBIC:
        return x * x * x - y * z * w <= 0.0  # w ≡ 1 channel
    if kind == KIND_RATIONAL_QUADRATIC:
        return x * x - y * z <= 0.0
    if kind == KIND_RATIONAL_CUBIC:
        return x * x * x - y * z * w <= 0.0
    raise ValueError(f"not a fill kind: {kind}")


def rasterize_fill_table(
    table: TriangleTable, width, height, transform=None, sample_offsets=MSAA4
):
    """Rasterize fill triangles to a per-sample winding buffer (H, W, S).

    Each triangle contributes sign(NDC signed area) where inside and the
    kind predicate holds, with perspective-correct attribute
    interpolation and a top-left fill rule for watertight shared edges.
    """
    if transform is None:
        transform = np.diag([2.0 / width, 2.0 / height, 1.0, 1.0]).astype(float)
        transform[0, 3] = -1.0
        transform[1, 3] = -1.0
    positions = sample_positions(width, height, sample_offsets)
    flat = positions.reshape(-1, 2)
    winding = np.zeros(len(flat), dtype=np.int64)
    for i in range(len(table)):
        verts, inv_w = _transform_to_pixel(table.xy[i], transform, width, height)
        aux = table.aux[i].astype(np.float64) * inv_w[:, None]
        winding += _rasterize_one(
            int(table.kind[i]), verts, aux, inv_w, flat
        )
    return winding.reshape(positions.shape[:-1])


def _edge_is_top_left(a, b):
    """Top-left rule in y-down pixel space for a CCW-in-pixel-space edge
    a→b: top edge (horizontal, going right) or left edge (going down)."""
    return (a[1] == b[1] and b[0] > a[0]) or (b[1] > a[1])


def _interpolate(verts, aux, inv_w, positions):
    """Inside mask and perspective-corrected attributes for one triangle.

    Returns (inside (N,), corrected_aux (N, 4), orientation) or None for
    degenerate triangles.
    """
    v0, v1, v2 = verts
    area = (v1[0] - v0[0]) * (v2[1] - v0[1]) - (v1[1] - v0[1]) * (v2[0] - v0[0])
    if area == 0.0 or not np.isfinite(area):
        return None
    # Orient to counterclockwise in pixel space for the inside test.
    orientation = 1.0 if area > 0 else -1.0
    px, py = positions[:, 0], positions[:, 1]
    inside = np.ones(len(positions), dtype=bool)
    barycentric = []
    for (a, b) in ((v0, v1), (v1, v2), (v2, v0)):
        e = (b[0] - a[0]) * (py - a[1]) - (b[1] - a[1]) * (px - a[0])
        e = e * orientation
        aa, bb = (a, b) if orientation > 0 else (b, a)
        if _edge_is_top_left(aa, bb):
            inside &= e >= 0.0
        else:
            inside &= e > 0.0
        barycentric.append(e)
    # Barycentric weights: edge (v1,v2) opposes v0 etc.
    l0 = barycentric[1] / (area * orientation)
    l1 = barycentric[2] / (area * orientation)
    l2 = barycentric[0] / (area * orientation)
    lam = np.stack([l0, l1, l2], axis=-1)
    interp_aux = lam @ aux  # linear in screen of aux/w
    interp_inv_w = lam @ inv_w
    with np.errstate(divide="ignore", invalid="ignore"):
        corrected = interp_aux / interp_inv_w[:, None]
    return inside, corrected, orientation


def _rasterize_one(kind, verts, aux, inv_w, positions):
    result = _interpolate(verts, aux, inv_w, positions)
    if result is None:
        return 0
    inside, corrected, orientation = result
    keep = inside & fill_predicate(kind, corrected)
    # Winding contribution: NDC-space orientation = -pixel-space orientation
    # (the viewport flip); NDC-CCW contributes +1.
    contribution = -int(orientation)
    return np.where(keep, contribution, 0)


def rasterize_table(
    table: TriangleTable,
    width,
    height,
    descriptors=None,
    transform=None,
    sample_offsets=MSAA4,
):
    """Full stencil-pass semantics for one shape: strokes then fills
    (reference renderer.rs:275-336 draw order).

    Stroke triangles accumulate an OR coverage (the reference's
    Equal+IncrementWrap stencil state, renderer.rs:571-576: only the
    first covering fragment raises the winding from 0 to 1); fill
    triangles then add signed winding on top.  Returns (H, W, S) winding.
    """
    from . import dynamic_stroke as ds
    from .vertex import END_CAP_FLAG, KIND_STROKE_JOINT, KIND_STROKE_LINE
    from .stroke import JOINT_TIP_FLAG

    if transform is None:
        transform = np.diag([2.0 / width, 2.0 / height, 1.0, 1.0]).astype(float)
        transform[0, 3] = -1.0
        transform[1, 3] = -1.0
    positions = sample_positions(width, height, sample_offsets)
    flat = positions.reshape(-1, 2)
    winding = np.zeros(len(flat), dtype=np.int64)
    stroke_cover = np.zeros(len(flat), dtype=bool)
    for i in range(len(table)):
        kind = int(table.kind[i])
        verts, inv_w = _transform_to_pixel(table.xy[i], transform, width, height)
        aux = table.aux[i].astype(np.float64) * inv_w[:, None]
        if kind in (KIND_STROKE_LINE, KIND_STROKE_JOINT):
            result = _interpolate(verts, aux, inv_w, flat)
            if result is None:
                continue
            inside, corrected, _ = result
            flags = int(table.meta[i, 0])
            group = np.asarray(flags & 0xFFFF)
            if kind == KIND_STROKE_LINE:
                keep = ds.stroke_line_predicate(
                    np,
                    descriptors,
                    group,
                    corrected[:, 0],
                    corrected[:, 1],
                    bool(flags & END_CAP_FLAG),
                    float(table.meta[i, 1]),
                )
            else:
                keep = ds.stroke_joint_predicate(
                    np,
                    descriptors,
                    group,
                    corrected[:, 0],
                    corrected[:, 1],
                    corrected[:, 2],
                    bool(flags & JOINT_TIP_FLAG),
                )
            stroke_cover |= inside & keep
        else:
            winding += _rasterize_one(kind, verts, aux, inv_w, flat)
    winding += stroke_cover.astype(np.int64)
    return winding.reshape(positions.shape[:-1])
