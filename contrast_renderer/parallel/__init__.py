"""Multi-chip scaling: sharded frame rendering over a device mesh.

The reference is single-device (SURVEY §2 parallelism inventory); this
package is an extension: the frame's pixels are sharded
across a `jax.sharding.Mesh` — 1D row bands or a 2D row × column tile
grid — each device rendering its sub-rect with a rect-adjusted
projection; no collectives beyond the output layout.
"""

from .mesh import (  # noqa: F401
    ShardedFrameProgram,
    ShardedFrameProgram2D,
    band_adjusted_transform,
    rect_adjusted_transform,
    render_sharded,
    render_sharded_2d,
)
