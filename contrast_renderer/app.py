"""Application framework: the frame-loop host for interactive scenes.

The headless replacement for the reference's winit/wgpu application
framework (examples/application_framework.rs).  The reference defines an
``Application`` trait (new / resize / render / window-event handlers,
application_framework.rs:62-67) and an event loop that feeds it resize,
cursor and wheel events and presents frames with a 64-frame
rolling-average timer (application_framework.rs:236-263).

A headless GPU host has no window system, so presentation becomes a *frame sink*
(PNG directory, in-memory list, or nothing — rendering for timing only)
and window events become a scripted or programmatic event stream; the
trait surface and loop semantics are otherwise the same, so an
application written against the reference's trait maps method-for-method.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .renderer import Configuration, Renderer
from .utils.profiling import FrameTimer

__all__ = [
    "Application",
    "FrameLoop",
    "PngSink",
    "CollectSink",
]


class Application:
    """Base class mirroring the reference's ``Application`` trait
    (application_framework.rs:62-67).

    Subclasses override:

    - :meth:`create` — build shapes / compile frame programs (the
      reference's ``new(device, queue, surface_config)``).
    - :meth:`resize` — the surface changed size; per-resolution state
      (compiled frame programs) must be rebuilt (``resize``).
    - :meth:`render` — produce one frame; returns the device-resident
      (H, W, 4) image (``render(device, queue, frame, animation_time)``).
    - :meth:`pointer_moved` / :meth:`pointer_button` / :meth:`wheel` —
      the winit window events the showcase consumes for its orbit
      camera (``window_event``, examples/showcase/main.rs:255-274).
    """

    def create(self, renderer: Renderer) -> None:
        pass

    def resize(self, renderer: Renderer) -> None:
        pass

    def render(self, renderer: Renderer, frame_index: int, time_s: float):
        raise NotImplementedError

    # -- window events (no-ops by default) -----------------------------
    def pointer_moved(self, x: float, y: float) -> None:
        pass

    def pointer_button(self, pressed: bool) -> None:
        pass

    def wheel(self, delta: float) -> None:
        pass


class PngSink:
    """Presents frames as numbered PNGs in a directory."""

    def __init__(self, directory: str, every: int = 1):
        from .utils.png import write_png

        self._write_png = write_png
        self.directory = directory
        self.every = max(1, int(every))
        os.makedirs(directory, exist_ok=True)

    def __call__(self, image_u8: np.ndarray, frame_index: int) -> None:
        if frame_index % self.every == 0:
            self._write_png(
                os.path.join(self.directory, f"frame_{frame_index:05d}.png"),
                image_u8,
            )


class CollectSink:
    """Keeps presented frames in memory (tests, programmatic use)."""

    def __init__(self):
        self.frames: List[np.ndarray] = []

    def __call__(self, image_u8: np.ndarray, frame_index: int) -> None:
        self.frames.append(np.asarray(image_u8))


class FrameLoop:
    """The event/render loop (application_framework.rs:236-263).

    Drives an :class:`Application`: dispatches queued window events,
    calls ``render`` once per frame, quantizes on device, presents to
    ``sink`` and keeps the reference's 64-frame rolling-average timing.

    Events are queued with :meth:`send_pointer` / :meth:`send_wheel` /
    :meth:`request_resize` (from a script, a test, or an external
    process feeding real input) and take effect at the next frame
    boundary, like a window message queue.
    """

    def __init__(
        self,
        app: Application,
        width: int,
        height: int,
        config: Optional[Configuration] = None,
        sink: Optional[Callable[[np.ndarray, int], None]] = None,
        background: Optional[Sequence[float]] = None,
        renderer: Optional[Renderer] = None,
    ):
        self.app = app
        self.renderer = renderer or Renderer(
            config or Configuration(), width, height
        )
        self.sink = sink
        self.background = (
            None if background is None
            else np.asarray(background, np.float32)
        )
        self.timer = FrameTimer()
        self._events: List[Tuple] = []
        self.frame_index = 0
        self._time_s = 0.0
        app.create(self.renderer)

    # -- event queue ----------------------------------------------------

    def request_resize(self, width: int, height: int) -> None:
        self._events.append(("resize", int(width), int(height)))

    def send_pointer(self, x: float, y: float) -> None:
        self._events.append(("pointer", float(x), float(y)))

    def send_button(self, pressed: bool) -> None:
        self._events.append(("button", bool(pressed)))

    def send_wheel(self, delta: float) -> None:
        self._events.append(("wheel", float(delta)))

    def _dispatch_events(self) -> None:
        events, self._events = self._events, []
        for event in events:
            kind = event[0]
            if kind == "resize":
                _, width, height = event
                self.renderer.resize(width, height)
                self.app.resize(self.renderer)
            elif kind == "pointer":
                self.app.pointer_moved(event[1], event[2])
            elif kind == "button":
                self.app.pointer_button(event[1])
            elif kind == "wheel":
                self.app.wheel(event[1])

    # -- frame loop -----------------------------------------------------

    def step(self, dt: float = 1.0 / 60.0) -> np.ndarray:
        """Run one frame; returns the presented uint8 image."""
        self._dispatch_events()
        with self.timer.frame():
            image = self.app.render(
                self.renderer, self.frame_index, self._time_s
            )
            if self.background is not None:
                image_u8 = np.asarray(
                    Renderer._composite_quantize(image, self.background)
                )
            else:
                image_u8 = np.asarray(Renderer._quantize(image))
        if self.sink is not None:
            self.sink(image_u8, self.frame_index)
        self.frame_index += 1
        self._time_s += dt
        return image_u8

    def run(self, frames: int, dt: float = 1.0 / 60.0) -> None:
        for _ in range(int(frames)):
            self.step(dt)

    def run_realtime(self, duration_s: float, fps_cap: float = 60.0) -> None:
        """Wall-clock loop: render as fast as the device allows up to
        ``fps_cap``, for ``duration_s`` seconds (the interactive mode).
        Animation time advances by real elapsed wall time; the cap is
        enforced by sleeping out the remainder of each frame slot."""
        end = time.perf_counter() + float(duration_s)
        min_dt = 1.0 / float(fps_cap)
        last = time.perf_counter()
        while time.perf_counter() < end:
            now = time.perf_counter()
            self.step(now - last)
            last = now
            leftover = min_dt - (time.perf_counter() - now)
            if leftover > 0:
                time.sleep(leftover)
