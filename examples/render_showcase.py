"""Frame driver: render the showcase scene to PNG frames with the
reference's rolling-average frame timing.

The headless replacement for the reference's winit window loop
(examples/application_framework.rs:236-263): instead of presenting to a
surface, frames are written as PNGs, and the per-frame time plus a
64-frame rolling average is logged exactly as
application_framework.rs:251-259 does.

Usage:
    python examples/render_showcase.py [--size WxH] [--frames N]
                                       [--out DIR] [--no-text]
"""

import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from contrast_renderer.models import showcase  # noqa: E402
from contrast_renderer.renderer import Configuration, Renderer  # noqa: E402
from contrast_renderer.utils.png import write_png  # noqa: E402
from contrast_renderer.utils.profiling import FrameTimer  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", default="1920x1080")
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--out", default="/tmp/showcase_frames")
    parser.add_argument("--no-text", action="store_true")
    parser.add_argument("--depth", action="store_true",
                        help="the reference showcase's depth state "
                             "(LessEqual + write, main.rs:46-49)")
    parser.add_argument("--save-every", type=int, default=1,
                        help="write every Nth frame as PNG")
    args = parser.parse_args()

    logging.basicConfig(
        level=logging.INFO, format="%(levelname)s %(name)s: %(message)s"
    )
    log = logging.getLogger("showcase")

    width, height = (int(x) for x in args.size.split("x"))
    os.makedirs(args.out, exist_ok=True)

    config = (
        Configuration(depth_compare="less_equal", depth_write_enabled=True)
        if args.depth
        else Configuration()
    )
    renderer = Renderer(config, width, height)
    shape = showcase.build_shape(with_text=not args.no_text)
    commands = showcase.showcase_commands(shape, width, height)

    timer = FrameTimer(log=True)
    for index in range(args.frames):
        with timer.frame():
            # Dash-phase animation (main.rs:155-161): only the
            # descriptor table changes — geometry and binning are reused.
            shape.set_dynamic_stroke_options(
                0, showcase.dashed_options(index * 0.032)
            )
            # uint8 quantization on device: 4× less host transfer.
            image = renderer.render(commands, as_uint8=True)
        if index == 0:
            log.info("scene stats: %s", renderer.stats)
        if index % args.save_every == 0:
            path = os.path.join(args.out, f"frame_{index:04d}.png")
            write_png(path, image)
    log.info("wrote frames to %s", args.out)


if __name__ == "__main__":
    main()
