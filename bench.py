"""Benchmark: showcase frame rate on one GPU.

Prints one JSON line: {"metric", "value", "unit", "device"}.

Measures device-side frame rate (render + a device completion probe),
matching the reference's frame loop which presents on-GPU without host
readback (examples/application_framework.rs:251-263).  A host-readback
figure is reported alongside in `readback_ms`.  Exits non-zero when JAX
finds no GPU.  BENCH_SIZE=WxH sets the resolution (default 1920x1080).
"""

import json
import os
import time


def main():
    from contrast_renderer.utils.runtime import (
        enable_compile_cache,
        require_gpu,
    )

    enable_compile_cache()
    import jax
    import numpy as np

    from contrast_renderer.models import showcase
    from contrast_renderer.renderer import Configuration, Renderer

    device = require_gpu("bench")[0]
    width, height = (
        int(x) for x in os.environ.get("BENCH_SIZE", "1920x1080").split("x")
    )

    orbit = bool(os.environ.get("BENCH_ORBIT"))
    # BENCH_INSTANCED=1: one Stencil + one Color command carrying all
    # 46 instances (the reference's instance_range 0..n draw,
    # renderer.rs:267) instead of the per-instance command loop.
    instanced = bool(os.environ.get("BENCH_INSTANCED"))
    # BENCH_CLIP=1: the nested-clip + transparency-group variant
    # (run_configs config 5) — clip/alpha state compiles into
    # the kernel and every covered tile pays the clip compare.
    clip_alpha = bool(os.environ.get("BENCH_CLIP"))
    # BENCH_DEPTH=1: the reference showcase's exact depth state
    # (LessEqual compare + write, examples/showcase/main.rs:46-49) —
    # later-drawn far grid instances lose to the near center instance's
    # ink, and every color cover pays the per-sample depth test.
    depth = bool(os.environ.get("BENCH_DEPTH"))
    depth_kwargs = (
        {"depth_compare": "less_equal", "depth_write_enabled": True}
        if depth
        else {}
    )
    config = (
        Configuration(
            alpha_layer_count=1, blending="front_to_back", **depth_kwargs
        )
        if clip_alpha
        else Configuration(**depth_kwargs)
    )
    # Interactive camera motion uses the deferred capacity check (one
    # frame of latency on buffer growth instead of a sync per frame).
    renderer = Renderer(
        config, width, height, strict_capacity=not orbit,
        tile_size=(int(os.environ["BENCH_TILE_H"])
                   if os.environ.get("BENCH_TILE_H") else None),
        fill_batch=(int(os.environ["BENCH_FILL_BATCH"])
                    if os.environ.get("BENCH_FILL_BATCH") else None),
    )
    shape = showcase.build_shape(with_text=True)
    make_commands = (
        showcase.showcase_commands_clip_alpha
        if clip_alpha
        else showcase.showcase_commands
    )
    commands = make_commands(shape, width, height, instanced=instanced)

    # BENCH_SEQ=N (with BENCH_ORBIT=1): render N frames per dispatch
    # through FrameProgram.render_sequence (lax.scan) — the batch
    # animation mode; per-frame dispatch overhead amortizes across N.
    seq = int(os.environ.get("BENCH_SEQ", "0")) if orbit else 0
    frames_per_call = max(1, seq)
    if orbit:
        import math

        # Orbiting camera: instance transforms change per frame, so the
        # binning stage re-runs every frame (the showcase's mouse-orbit
        # camera, examples/showcase/main.rs:255-274).  The fused
        # FrameProgram runs camera-binning-raster as ONE dispatch with
        # the transform stack as a runtime input — the reference's
        # "camera is just a matrix" economics.
        # BENCH_U8=1: resolve to packed RGBA8 in the kernel (the
        # presentation format — reference surfaces are 8-bit); skips
        # the float de-tile transpose and writes 1/4 the output bytes.
        program = renderer.compile_frame(
            commands, uint8_output=bool(os.environ.get("BENCH_U8"))
        )

        def orbit_transforms(t):
            # 0.05 rad per frame (t advances 0.016 per frame) — the
            # same sweep run_configs.py times, so both harnesses
            # measure identical camera motion (a near-static orbit
            # flatters fused-plan reuse).
            angle = 3.125 * t
            rotor = np.array(
                [math.cos(angle / 2), 0.0, math.sin(angle / 2), 0.0]
            )
            return showcase.command_transforms(
                width, height, clip_alpha=clip_alpha,
                instanced=instanced, view_rotation=rotor,
            )

        # ONE fused grouping valid across the whole timed sweep,
        # compiled before timing (see FrameProgram.plan_for_motion).
        program.plan_for_motion(
            [orbit_transforms(i * 0.016) for i in range(3 * 32 + 3)],
            timeout=600.0,
        )

        if seq:
            import jax.numpy as _jnp

            def frame(t, acc):
                stacks = np.stack(
                    [orbit_transforms(t + 0.016 * i) for i in range(seq)]
                )
                frames = program.render_sequence(stacks, as_uint8=False)
                return frames[-1], acc + _jnp.sum(frames[..., 3])
        else:
            def frame(t, acc):
                transforms = orbit_transforms(t)
                shape.set_dynamic_stroke_options(
                    0, showcase.dashed_options(t * 2.0)
                )
                # The per-frame completion probe rides the frame
                # dispatch (program carry) — one launch per frame.
                return program(transforms, carry=acc)
    elif os.environ.get("BENCH_U8"):
        # Static camera, kernel-packed RGBA8 resolve (the presentation
        # format — the reference renders into an 8-bit unorm surface,
        # application_framework.rs:172-183): keeps the cached-binning
        # economics of renderer.render (a fused FrameProgram would
        # re-bin every frame, which a static camera never needs) while
        # skipping the float de-tile transpose and writing 1/4 the
        # output bytes.
        def frame(t, acc):
            shape.set_dynamic_stroke_options(
                0, showcase.dashed_options(t * 2.0)
            )
            return renderer.render(
                commands, to_host=False, carry=acc, uint8_kernel=True
            )
    else:
        def frame(t, acc):
            shape.set_dynamic_stroke_options(
                0, showcase.dashed_options(t * 2.0)
            )
            # carry folds the completion probe into the frame's own
            # dispatch (one launch per frame).
            return renderer.render(commands, to_host=False, carry=acc)

    import jax.numpy as jnp

    # Throughput timing: frames are dispatched back-to-back like a
    # swapchain with frames in flight (the reference's frame timer also
    # measures submit-to-submit time, application_framework.rs:251-259).
    # Each frame feeds a tiny device-side checksum and the whole chain
    # is fetched once at the end, so every timed frame is forced to
    # completion by a real data dependency.  The per-frame reduction
    # costs one read of the frame — the measured FPS is a slight
    # under-estimate.
    probe_add = jax.jit(lambda acc, x: acc + jnp.sum(x[..., 3]))

    def probed_frame(t, acc):
        image, new_acc = frame(t, acc)
        if new_acc is None:  # frame path without a fused carry
            new_acc = probe_add(acc, image)
        return image, new_acc

    image, acc = probed_frame(0.0, jnp.float32(0.0))
    _, acc = probed_frame(0.016, acc)
    float(acc)  # compile frame + probe
    frames = max(1, 32 // frames_per_call)
    batches = 3
    # Best sustained batch of three: the steady-state frame rate (the
    # reference reports a 64-frame rolling average,
    # application_framework.rs:251-259).
    fps = 0.0
    for b in range(batches):
        start = time.perf_counter()
        acc = jnp.float32(0.0)
        for i in range(frames):
            _, acc = probed_frame((b * frames + i) * 0.016, acc)
        checksum = float(acc)  # forces every frame in the chain
        elapsed = time.perf_counter() - start
        assert np.isfinite(checksum)
        fps = max(fps, frames * frames_per_call / elapsed)
    image, _ = probed_frame(0.0, jnp.float32(0.0))

    start = time.perf_counter()
    host = np.asarray(image)
    readback_ms = (time.perf_counter() - start) * 1e3
    assert np.isfinite(host).all()

    label = (
        f"showcase_fps_{width}x{height}"
        + ("_orbit" if orbit else "")
        + (f"_seq{seq}" if seq else "")
        + ("_clipalpha" if clip_alpha else "")
        + ("_depth" if depth else "")
        + ("_u8" if os.environ.get("BENCH_U8") else "")
        + ("_instanced" if instanced else "")
    )
    record = {
        "metric": label,
        "value": round(fps, 3),
        "unit": "frames/s",
        "readback_ms": round(readback_ms, 1),
        "device": {
            "platform": device.platform,
            "kind": device.device_kind,
            "count": jax.device_count(),
        },
    }
    print(json.dumps(record))


if __name__ == "__main__":
    main()
