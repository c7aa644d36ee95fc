"""Geometry tables: the SoA triangle representation consumed by the
device rasterizer.

This replaces the reference's GPU vertex buffer structs
(src/vertex.rs:1-26) and its triangle strip/fan encoding
(src/vertex.rs:28-35, src/renderer.rs:198-209).  Instead of interleaved
packed vertices and primitive-restart index strips, the device-side
representation is a flat, padded structure-of-arrays of independent
triangles — the natural layout for batched array processing and tile
binning:

- ``xy``:   (N, 3, 2) float32 — triangle vertex positions (model space)
- ``aux``:  (N, 3, 4) float32 — per-vertex attributes:
    * fill curve triangles: the implicit-curve weights (2/3/4 used)
    * stroke triangles: texcoords (2/3 used)
- ``kind``: (N,) int32 — primitive kind (KIND_*)
- ``meta``: (N, 2) float32 — per-triangle scalars:
    * [0]: stroke group index + end-cap flag (END_CAP_FLAG), as float
    * [1]: the provoking vertex's texcoord.y for end caps
      (reference shaders.wgsl:99, the flat-interpolated end_texcoord_y)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

KIND_SOLID = 0
KIND_INTEGRAL_QUADRATIC = 1
KIND_INTEGRAL_CUBIC = 2
KIND_RATIONAL_QUADRATIC = 3
KIND_RATIONAL_CUBIC = 4
KIND_STROKE_LINE = 5
KIND_STROKE_JOINT = 6

#: Marks stroke triangles belonging to the end-cap extension
#: (reference stroke.rs:448,457: group | 0x10000).
END_CAP_FLAG = 0x10000


@dataclass
class TriangleTable:
    """Flat triangle list with per-vertex attributes."""

    xy: np.ndarray  # (N, 3, 2) f32
    aux: np.ndarray  # (N, 3, 4) f32
    kind: np.ndarray  # (N,) i32
    meta: np.ndarray  # (N, 2) f32

    @classmethod
    def empty(cls) -> "TriangleTable":
        return cls(
            xy=np.zeros((0, 3, 2), dtype=np.float32),
            aux=np.zeros((0, 3, 4), dtype=np.float32),
            kind=np.zeros((0,), dtype=np.int32),
            meta=np.zeros((0, 2), dtype=np.float32),
        )

    @classmethod
    def concatenate(cls, tables) -> "TriangleTable":
        tables = [t for t in tables if len(t.kind)]
        if not tables:
            return cls.empty()
        return cls(
            xy=np.concatenate([t.xy for t in tables]),
            aux=np.concatenate([t.aux for t in tables]),
            kind=np.concatenate([t.kind for t in tables]),
            meta=np.concatenate([t.meta for t in tables]),
        )

    def __len__(self):
        return len(self.kind)


class TriangleBuilder:
    """Append-only accumulator producing a TriangleTable."""

    def __init__(self):
        # Batches of (N, 3, 2) / (N, 3, 4) / (N,) / (N, 2); build()
        # concatenates once — hot builders (strokes, glyph batches)
        # push whole strips in one call instead of per-triangle.
        self.xy = []
        self.aux = []
        self.kind = []
        self.meta = []
        self._count = 0

    def __len__(self):
        return self._count

    def push(self, xy, kind, aux=None, meta=(0.0, 0.0)):
        xy = np.asarray(xy, dtype=np.float64)
        assert xy.shape == (3, 2), xy.shape
        a = np.zeros((3, 4), dtype=np.float64)
        if aux is not None:
            aux = np.asarray(aux, dtype=np.float64)
            a[:, : aux.shape[1]] = aux
        self.xy.append(xy[None])
        self.aux.append(a[None])
        self.kind.append(np.asarray([kind], dtype=np.int64))
        self.meta.append(np.asarray(meta, dtype=np.float64)[None])
        self._count += 1

    def push_many(self, xy, kind, aux=None, meta=None):
        """Append a batch: xy (N, 3, 2); kind scalar or (N,);
        aux (N, 3, k≤4) or None; meta (N, 2) or None."""
        xy = np.asarray(xy, dtype=np.float64)
        n = len(xy)
        if n == 0:
            return
        assert xy.shape == (n, 3, 2), xy.shape
        a = np.zeros((n, 3, 4), dtype=np.float64)
        if aux is not None:
            aux = np.asarray(aux, dtype=np.float64)
            a[:, :, : aux.shape[2]] = aux
        k = np.broadcast_to(
            np.asarray(kind, dtype=np.int64), (n,)
        ).copy()
        m = (
            np.zeros((n, 2), dtype=np.float64)
            if meta is None
            else np.asarray(meta, dtype=np.float64).reshape(n, 2)
        )
        self.xy.append(xy)
        self.aux.append(a)
        self.kind.append(k)
        self.meta.append(m)
        self._count += n

    def build(self) -> TriangleTable:
        if not self._count:
            return TriangleTable.empty()
        return TriangleTable(
            xy=np.concatenate(self.xy).astype(np.float32),
            aux=np.concatenate(self.aux).astype(np.float32),
            kind=np.concatenate(self.kind).astype(np.int32),
            meta=np.concatenate(self.meta).astype(np.float32),
        )


def fan_triangles(points):
    """Triangulate a fan around the first point into (n-2, 3, 2)
    triangles (the reference draws fans as strips via
    triangle_fan_to_strip, vertex.rs:28-35; a flat list is equivalent)."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    if len(pts) < 3:
        return np.zeros((0, 3, 2))
    return np.stack(
        [
            np.repeat(pts[:1], len(pts) - 2, axis=0),
            pts[1:-1],
            pts[2:],
        ],
        axis=1,
    )


# The reference's strip encodings (vertex.rs:28-35 triangle_fan_to_strip,
# primitive-restart strips) have no analogue here: flat triangle lists
# are the natural SoA layout for binning, and fans decompose directly
# via `fan_triangles`.
