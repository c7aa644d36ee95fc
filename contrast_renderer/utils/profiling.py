"""Frame timing and device tracing.

The reference's only performance instrumentation is a per-frame time
with a 64-frame rolling average (examples/application_framework.rs:
251-259); `FrameTimer` reproduces it.  `device_trace` wraps
`jax.profiler.trace` for XLA/device-level inspection — an upgrade
over wgpu's (disabled) tracing hook
(application_framework.rs:156)."""

from __future__ import annotations

import contextlib
import logging
import time
from collections import deque

logger = logging.getLogger("contrast_renderer")

ROLLING_WINDOW = 64  # frames (application_framework.rs:251)


class FrameTimer:
    """Rolling-average frame timer.

    >>> timer = FrameTimer()
    >>> with timer.frame():
    ...     render()
    >>> timer.average_s, timer.fps
    """

    def __init__(self, window: int = ROLLING_WINDOW, log: bool = False):
        self._times = deque(maxlen=window)
        self._log = log
        self.frame_index = 0
        self.last_s = 0.0

    @contextlib.contextmanager
    def frame(self):
        start = time.perf_counter()
        yield
        self.last_s = time.perf_counter() - start
        self._times.append(self.last_s)
        if self._log:
            logger.info(
                "frame %d: %.1f µs (rolling average %.1f µs, %.1f FPS)",
                self.frame_index, self.last_s * 1e6,
                self.average_s * 1e6, self.fps,
            )
        self.frame_index += 1

    @property
    def average_s(self) -> float:
        if not self._times:
            return 0.0
        return sum(self._times) / len(self._times)

    @property
    def fps(self) -> float:
        avg = self.average_s
        return 1.0 / avg if avg > 0 else 0.0


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace (TensorBoard format) around a block."""
    import jax

    with jax.profiler.trace(log_dir):
        yield
    logger.info("wrote device trace to %s", log_dir)
