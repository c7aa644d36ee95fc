"""Device-side rasterization ops (JAX/XLA/Pallas).

The JAX replacement for the reference's GPU runtime
(src/renderer.rs render pipelines + src/shaders.wgsl fragment stages):
triangle edge/attribute setup as batched arithmetic, per-tile coverage
accumulation over an MSAA samples axis, and winding/clip/alpha composite
algebra as explicit array math.
"""
