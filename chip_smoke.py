"""Smoke run of the renderer's frame path on one GPU.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the sharded phase only

Each phase drives the public API (`Renderer.render`,
`Renderer.compile_frame` → `FrameProgram.plan_for_motion`, and with
``--four`` `render_sharded` / `ShardedFrameProgram`) on the showcase with
text at full size and 4× MSAA, and prints its compile seconds, median
frame ms, the process's peak device bytes, tiles, binned entries and
capacity growths.  Every frame is compared with the plain-XLA executor
(ops/reference.py) on the same prepared frame:

- per-channel mean |difference| < 1e-4,
- under 0.1 % of pixels off by more than 1/255,
- no NaN.

The kernel and the plain executor round differently where the compiler
contracts a multiply-add, so a sample exactly on an edge may flip; one
flipped sample of four moves a pixel by 1/4 at most, and the limits
allow a few such pixels per million.  The 192×108 showcase is also
compared with the golden image, and the tests marked ``gpu`` (every
kernel variant compiled by Triton against the plain executor) run in
this process.  Any failure exits non-zero; the last line is the JSON
result.
"""

import argparse
import itertools
import json
import math
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

MEAN_ABS_MAX = 1e-4
FRAC_OFF_MAX = 1e-3
WARMUP = 3
FRAMES = 20


def card_line():
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not found"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def compare(label, got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    n_nan = int(np.isnan(got).sum())
    d = np.abs(got - want)
    mean = d.mean(axis=(0, 1))
    frac = float((d.max(axis=-1) > 1.0 / 255.0).mean())
    print(f"  {label}: mean|d| per channel {mean.tolist()} max {d.max()} "
          f"off>1/255 {frac} nan {n_nan}", flush=True)
    assert n_nan == 0, f"{label}: {n_nan} NaN"
    assert (mean < MEAN_ABS_MAX).all(), f"{label}: mean |d| {mean}"
    assert frac < FRAC_OFF_MAX, f"{label}: {frac} of pixels off"


def median_ms(fn, frames=FRAMES, warmup=WARMUP):
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn())
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def report(label, renderer, compile_s, frame_ms, **extra):
    stats = renderer.stats
    fields = dict(
        compile_s=round(compile_s, 3), median_frame_ms=frame_ms,
        peak_device_bytes=peak_bytes(), tiles=stats.get("tiles"),
        max_tile_entries=stats.get("max_tile_entries"),
        global_triangles=stats.get("global_triangles"),
        capacity_growths=renderer.capacity_growths, **extra,
    )
    print(f"{label}: " + json.dumps(fields), flush=True)


def rotor(angle):
    return np.array([math.cos(angle / 2), 0.0, math.sin(angle / 2), 0.0])


def phase_static(width, height, variant="plain", time_plain=False):
    import jax

    from contrast_renderer.models import showcase
    from contrast_renderer.ops import reference
    from contrast_renderer.renderer import Configuration, Renderer

    config = {
        "plain": Configuration(),
        "clip_alpha": Configuration(
            alpha_layer_count=1, blending="front_to_back"),
        "depth": Configuration(
            depth_compare="less_equal", depth_write_enabled=True),
    }[variant]
    make = (showcase.showcase_commands_clip_alpha if variant == "clip_alpha"
            else showcase.showcase_commands)
    label = f"static {variant} {width}x{height}"
    shape = showcase.build_shape(with_text=True)
    commands = make(shape, width, height)
    renderer = Renderer(config, width, height)
    t0 = time.perf_counter()
    image = jax.block_until_ready(renderer.render(commands, to_host=False))
    compile_s = time.perf_counter() - t0
    frame_ms = median_ms(lambda: renderer.render(commands, to_host=False))
    extra = {}
    if time_plain:
        # The contender: the plain-XLA executor on the same prepared
        # frame (binning is cached for a static camera, so the raster
        # stage is the whole device frame for both).
        spec, args = renderer._prepare_frame(commands)
        kernel = renderer._get_executors(spec)[1]
        plain = jax.jit(reference.make_reference_rasterize(spec))
        extra = dict(
            kernel_raster_ms=median_ms(lambda: kernel(*args)),
            plain_raster_ms=median_ms(lambda: plain(*args)),
        )
    report(label, renderer, compile_s, frame_ms, **extra)
    compare(label, image, reference.render_reference(renderer, commands))


def phase_orbit(width, height):
    import jax

    from contrast_renderer.models import showcase
    from contrast_renderer.ops import reference
    from contrast_renderer.renderer import Configuration, Renderer

    label = f"orbit {width}x{height}"
    shape = showcase.build_shape(with_text=True)
    commands = showcase.showcase_commands(shape, width, height)
    n = WARMUP + FRAMES
    # 0.05 rad of camera orbit per frame (showcase main.rs:255-274).
    stacks = [
        showcase.command_transforms(
            width, height, view_rotation=rotor(0.05 * i))
        for i in range(n)
    ]
    renderer = Renderer(Configuration(), width, height)
    t0 = time.perf_counter()
    program = renderer.compile_frame(commands)
    program.plan_for_motion(stacks, timeout=900.0)
    jax.block_until_ready(program(stacks[0]))
    compile_s = time.perf_counter() - t0
    frames = itertools.cycle(stacks)
    frame_ms = median_ms(lambda: program(next(frames)))
    report(label, renderer, compile_s, frame_ms)
    checker = Renderer(Configuration(), width, height)
    for i in (1, n - 1):
        got = program(stacks[i])
        want = reference.render_reference(
            checker,
            showcase.showcase_commands(
                shape, width, height, view_rotation=rotor(0.05 * i)),
        )
        compare(f"{label} frame {i}", got, want)


def phase_golden():
    import os

    from contrast_renderer.models import showcase
    from contrast_renderer.renderer import Configuration, Renderer
    from contrast_renderer.utils.png import read_png

    w, h = 192, 108
    renderer = Renderer(Configuration(), w, h)
    shape = showcase.build_shape(with_text=True)
    image = renderer.render(showcase.showcase_commands(shape, w, h))
    got = (np.clip(image, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    want = read_png(os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "tests", "golden", "showcase_192x108.png"))
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    far = float((diff.max(axis=-1) > 32).mean())
    print(f"golden 192x108: mean|d| {diff.mean()} (limit 1.0), "
          f"share off by >32 {far} (limit 0.01)", flush=True)
    assert diff.mean() < 1.0 and far < 0.01


def phase_gpu_tests():
    import os

    import pytest

    tests = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests",
        "test_kernel_state.py",
    )
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", tests])
    assert rc == 0, f"gpu tests exited {rc}"


def phase_four_cards(width=3840, height=2160):
    import jax
    from jax.sharding import Mesh

    from contrast_renderer.models import showcase
    from contrast_renderer.parallel import (
        ShardedFrameProgram, render_sharded)
    from contrast_renderer.renderer import Configuration, Renderer

    devices = jax.devices()
    assert len(devices) == 4, f"--four needs 4 GPUs, found {len(devices)}"
    mesh = Mesh(np.array(devices), ("y",))
    shape = showcase.build_shape(with_text=True)
    commands = showcase.showcase_commands(shape, width, height)
    single = Renderer(Configuration(), width, height)
    one_card = single.render(commands)

    sharded_renderer = Renderer(Configuration(), width, height)
    t0 = time.perf_counter()
    banded = render_sharded(sharded_renderer, commands, mesh)
    print(f"render_sharded 4 bands {width}x{height}: first call s "
          f"{time.perf_counter() - t0:.3f}", flush=True)
    compare("render_sharded vs one card", banded, one_card)

    t0 = time.perf_counter()
    program = ShardedFrameProgram(
        Renderer(Configuration(), width, height), commands, mesh)
    print(f"ShardedFrameProgram build s {time.perf_counter() - t0:.3f}",
          flush=True)
    for angle in (0.05, 0.1):
        stack = showcase.command_transforms(
            width, height, view_rotation=rotor(angle))
        frame = program(stack)
        frame_ms = median_ms(lambda: program(stack), frames=10)
        print(f"ShardedFrameProgram orbit {angle}: median frame ms "
              f"{frame_ms}", flush=True)
        want = single.render(showcase.showcase_commands(
            shape, width, height, view_rotation=rotor(angle)))
        compare(f"ShardedFrameProgram orbit {angle} vs one card",
                frame, want)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card sharded phase")
    args = parser.parse_args()

    from contrast_renderer.utils.runtime import (
        enable_compile_cache,
        require_gpu,
    )

    enable_compile_cache()
    devices = require_gpu("chip_smoke")
    print(card_line(), flush=True)
    print(devices, devices[0].device_kind, flush=True)

    if args.four:
        phases = [("four cards", phase_four_cards)]
    else:
        phases = [
            ("golden", phase_golden),
            ("gpu tests", phase_gpu_tests),
            ("static 1080p", lambda: phase_static(1920, 1080,
                                                  time_plain=True)),
            ("static 4K", lambda: phase_static(3840, 2160, time_plain=True)),
            ("orbit 1080p", lambda: phase_orbit(1920, 1080)),
            ("orbit 4K", lambda: phase_orbit(3840, 2160)),
            ("clip/alpha 1080p", lambda: phase_static(1920, 1080,
                                                      "clip_alpha")),
            ("depth 1080p", lambda: phase_static(1920, 1080, "depth")),
        ]
    failed = []
    for name, phase in phases:
        t0 = time.perf_counter()
        try:
            phase()
            print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s",
                  flush=True)
        except Exception:
            traceback.print_exc()
            print(f"phase {name}: FAILED", flush=True)
            failed.append(name)
    if failed:
        print(f"failed phases: {failed}", flush=True)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))


if __name__ == "__main__":
    main()
