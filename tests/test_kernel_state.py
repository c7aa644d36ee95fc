"""Raster kernel: clip / alpha / depth state, paints and the packed
RGBA8 resolve against the plain-XLA executor; CUDA lowering of every
kernel variant; the kernel-route choice per backend; and the stroke
compile-out flag."""

from dataclasses import replace

import jax
import numpy as np
import pytest

from contrast_renderer.ops import coverage, reference
from contrast_renderer.renderer import Configuration, Renderer
from kernel_cases import (
    CASES,
    SIZE,
    assert_matches,
    kernel_and_reference,
)

STATE_CASES = ["clip_nested", "alpha_group", "depth_less_equal", "paints"]


@pytest.mark.parametrize("case", STATE_CASES)
def test_kernel_matches_plain_executor(case):
    got, want = kernel_and_reference(case)
    assert np.isfinite(got).all()
    assert_matches(got, want)
    assert got[..., 3].max() > 0.3


@pytest.mark.parametrize("case", ["fill_cubic", "alpha_group"])
def test_uint8_resolve_matches_plain_executor(case):
    got, want = kernel_and_reference(case, uint8=True)
    assert got.dtype == want.dtype == np.uint8
    assert_matches(got, want)


def _gpu_spec_and_args(case, out_uint8=False):
    config, commands = CASES[case]()
    renderer = Renderer(config, SIZE, SIZE)
    spec, args = renderer._prepare_frame(commands)
    return replace(spec, interpret=False, out_uint8=out_uint8), args


@pytest.mark.parametrize(
    "case,out_uint8",
    [
        ("fill_cubic", False),
        ("stroke_dash_multi", False),
        ("clip_nested", True),
        ("alpha_group", False),
        ("depth_less_equal", False),
        ("paints", True),
    ],
)
def test_kernel_lowers_for_cuda(case, out_uint8):
    """Each kernel variant lowers through Triton for CUDA (this checks
    the lowering only, not the PTX compile, which needs the card)."""
    spec, args = _gpu_spec_and_args(case, out_uint8)
    lowered = jax.jit(coverage.make_rasterize(spec)).trace(*args).lower(
        lowering_platforms=("cuda",)
    )
    assert "raster_tiles" in lowered.as_text()


@pytest.mark.parametrize(
    "platform,interpret", [("cpu", True), ("gpu", False), ("cuda", False)]
)
def test_interpret_for_platform(platform, interpret):
    assert coverage.interpret_for_platform(platform) is interpret


def test_interpret_for_platform_rejects_other_backends():
    with pytest.raises(RuntimeError, match="no raster kernel"):
        coverage.interpret_for_platform("metal")


def test_default_renderer_interprets_on_cpu():
    renderer = Renderer(Configuration(), SIZE, SIZE)
    assert renderer._interpret_flag() is True


@pytest.mark.parametrize("stroked", [False, True])
def test_has_strokes_follows_stroke_geometry(stroked):
    case = "stroke_miter_butt" if stroked else "fill_solid"
    config, commands = CASES[case]()
    renderer = Renderer(config, SIZE, SIZE)
    spec, _ = renderer._prepare_frame(commands)
    assert spec.has_strokes is stroked


@pytest.mark.parametrize("field,value", [("tile_h", 12), ("tile_w", 48)])
def test_frame_spec_rejects_non_power_of_two_tiles(field, value):
    with pytest.raises(ValueError, match="power of two"):
        coverage.FrameSpec(
            width=64, height=64, ops=(0, 3), cmd_shape=(0, 0), n_shapes=1,
            t_max=8, h_max=8, samples=4, winding_bits=8, n_layers=0,
            blending="back_to_front", **{field: value},
        )


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_compiled_kernel_matches_plain_executor(gpu, case):
    """On the card: the compiled Triton kernel against the plain
    executor (FMA contraction may flip an edge sample)."""
    config, commands = CASES[case]()
    renderer = Renderer(config, SIZE, SIZE)
    assert_matches(
        renderer.render(commands),
        reference.render_reference(renderer, commands),
    )
