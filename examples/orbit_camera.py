"""Interactive-style showcase: orbit camera driven by pointer events.

The Application-framework port of the reference showcase's window-event
camera (examples/showcase/main.rs:255-274): cursor drag orbits the
scene (a rotor accumulated from pointer deltas), the wheel zooms
(view distance), and a resize rebuilds the per-resolution frame
program.  On a headless host the events come from a script instead of winit;
the handlers are the same shape.

Camera motion re-bins every frame, so the app renders through the
fused ``FrameProgram`` (camera → binning → raster in one dispatch with
the transform stack as a runtime input).

Usage:
    python examples/orbit_camera.py [--size WxH] [--frames N]
                                    [--out DIR] [--no-text]
"""

import argparse
import logging
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from contrast_renderer.app import Application, FrameLoop, PngSink  # noqa: E402
from contrast_renderer.models import showcase  # noqa: E402
from contrast_renderer.utils.matrix import (  # noqa: E402
    _quat_mul,
    rotate_around_axis,
)


class ShowcaseOrbitApp(Application):
    """The showcase scene under a pointer-driven orbit camera."""

    def __init__(self, with_text: bool = True):
        self.with_text = with_text
        self.yaw = 0.0
        self.pitch = 0.0
        self.distance = 5.0
        self._pressed = False
        self._last_xy = None
        self._program = None
        self._shape = None

    # -- Application ---------------------------------------------------

    def create(self, renderer):
        self._shape = showcase.build_shape(with_text=self.with_text)
        self._compile(renderer)

    def resize(self, renderer):
        # Frame programs are per-resolution (renderer.resize cleared its
        # executor caches); rebuild (main.rs surface reconfigure).
        self._compile(renderer)

    def _compile(self, renderer):
        commands = showcase.showcase_commands(
            self._shape, renderer.width, renderer.height
        )
        self._program = renderer.compile_frame(commands)

    def _rotor(self):
        # yaw about +Y then pitch about +X (main.rs:255-267 accumulates
        # the same two axes from cursor deltas).
        return _quat_mul(
            rotate_around_axis(self.yaw, [0.0, 1.0, 0.0]),
            rotate_around_axis(self.pitch, [1.0, 0.0, 0.0]),
        )

    def render(self, renderer, frame_index, time_s):
        # Dash-phase animation rides the descriptor table
        # (main.rs:155-161); the camera rides the transform stack.
        self._shape.set_dynamic_stroke_options(
            0, showcase.dashed_options(time_s * 2.0)
        )
        transforms = showcase.command_transforms(
            renderer.width,
            renderer.height,
            view_rotation=self._rotor(),
            view_distance=self.distance,
        )
        return self._program(transforms)

    # -- window events (main.rs:255-274) --------------------------------

    def pointer_button(self, pressed):
        self._pressed = pressed
        if not pressed:
            self._last_xy = None

    def pointer_moved(self, x, y):
        if self._pressed and self._last_xy is not None:
            dx = x - self._last_xy[0]
            dy = y - self._last_xy[1]
            self.yaw += dx * 0.005
            self.pitch += dy * 0.005
        self._last_xy = (x, y)

    def wheel(self, delta):
        self.distance = float(
            np.clip(self.distance * math.exp(-0.1 * delta), 1.0, 100.0)
        )


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", default="1920x1080")
    parser.add_argument("--frames", type=int, default=96)
    parser.add_argument("--out", default="/tmp/orbit_frames")
    parser.add_argument("--no-text", action="store_true")
    parser.add_argument("--save-every", type=int, default=8)
    args = parser.parse_args()

    logging.basicConfig(
        level=logging.INFO, format="%(levelname)s %(name)s: %(message)s"
    )
    log = logging.getLogger("orbit")

    width, height = (int(x) for x in args.size.split("x"))
    app = ShowcaseOrbitApp(with_text=not args.no_text)
    loop = FrameLoop(
        app,
        width,
        height,
        sink=PngSink(args.out, every=args.save_every),
        background=(1.0, 1.0, 1.0, 1.0),
    )

    # Scripted input: press, drag an arc, zoom out, keep dragging —
    # the same event kinds a real pointer would feed the loop.
    loop.send_button(True)
    loop.send_pointer(0.0, 0.0)
    for index in range(args.frames):
        loop.send_pointer(6.0 * index, 2.0 * math.sin(index * 0.2))
        if index == args.frames // 2:
            loop.send_wheel(-2.0)  # zoom out
        loop.step()
        if index % 16 == 15:
            log.info(
                "frame %d: rolling average %.1f ms (%.1f FPS)",
                index, loop.timer.average_s * 1e3, loop.timer.fps,
            )
    log.info(
        "done: %d frames, %.1f FPS rolling; PNGs in %s",
        loop.frame_index, loop.timer.fps, args.out,
    )


if __name__ == "__main__":
    main()
