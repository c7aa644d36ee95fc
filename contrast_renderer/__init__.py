"""contrast_renderer — a JAX-native 2D vector-graphics renderer.

A brand-new JAX/XLA/Pallas implementation with the capabilities of the
Contrast renderer (reference: Lichtso/contrast_renderer, wgpu/Rust):
resolution-independent filling of paths built from lines and
integral/rational quadratic/cubic Bezier curves via per-sample implicit-curve
evaluation, polygon-tessellated stroking with joins/caps/dashing resolved
per sample, MSAA, instancing, nestable clipping and nestable transparency
groups, plus a TTF text subsystem.

Architecture (array-first, not a port):
  - Host scene layer (``path``, ``text``): same API surface as the
    reference's ``Path``/``StrokeOptions``/``paths_of_text`` so scenes port
    unchanged (reference src/path.rs, src/text.rs).
  - Geometry build (``fill``, ``stroke``, ``curve``): paths are tessellated
    into *primitive tables* — SoA arrays of triangles carrying per-vertex
    implicit weights (Loop-Blinn) or stroke texcoords (reference
    src/fill.rs, src/stroke.rs).
  - Device layer (``ops``, ``renderer``): instead of triangle rasterization
    + stencil hardware (reference src/renderer.rs, src/shaders.wgsl), a
    jitted frame program transforms primitives (batched matmul), bins them
    to pixel tiles, and a Pallas (Triton) kernel accumulates per-sample
    winding / stroke coverage in registers per tile, then composites with the same winding, clip
    and alpha-group algebra the reference encodes in stencil state.
"""

__version__ = "0.1.0"

from .error import (  # noqa: F401
    ERROR_MARGIN,
    ClipStackOverflow,
    ContrastError,
    DynamicStrokeOptionsIndexOutOfBounds,
    NumberOfStencilBitsIsUnsupported,
    TooManyDashIntervals,
    TooManyNestedOpacityGroups,
)

# Renderer surface (imported lazily by submodule elsewhere; re-exported
# here for discoverability — jax loads on first renderer use, not at
# package import).


def __getattr__(name):
    _renderer_names = {
        "BlendComponent", "BlendState", "Configuration", "DrawCommand",
        "FrameProgram", "LinearGradient", "RadialGradient",
        "RenderOperation", "Renderer", "Shape", "UserPaint",
    }
    _app_names = {"Application", "FrameLoop", "PngSink", "CollectSink"}
    if name in _renderer_names:
        from . import renderer

        return getattr(renderer, name)
    if name in _app_names:
        from . import app

        return getattr(app, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
