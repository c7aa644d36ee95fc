"""Application framework: frame loop, event queue, resize, sinks
(the reference's winit loop semantics, application_framework.rs:236-263)."""

import os

import numpy as np
import pytest

from contrast_renderer.app import Application, CollectSink, FrameLoop
from contrast_renderer.path import Path
from contrast_renderer.renderer import (
    DrawCommand,
    RenderOperation,
    Shape,
)


def ortho(width, height):
    t = np.diag([2.0 / width, 2.0 / height, 1.0, 1.0]).astype(np.float32)
    t[0, 3] = -1.0
    t[1, 3] = -1.0
    return t


class MovingRectApp(Application):
    """A rect whose x position follows the pointer; red while the
    button is held, green otherwise."""

    def __init__(self):
        self.x = 16.0
        self.pressed = False
        self.created = 0
        self.resized = 0
        self.shape = Shape([Path.from_rect((0.0, 0.0), (8.0, 8.0))])

    def create(self, renderer):
        self.created += 1

    def resize(self, renderer):
        self.resized += 1

    def pointer_moved(self, x, y):
        self.x = x

    def pointer_button(self, pressed):
        self.pressed = pressed

    def render(self, renderer, frame_index, time_s):
        t = ortho(renderer.width, renderer.height)
        t[0, 3] += 2.0 * self.x / renderer.width
        t[1, 3] += 1.0  # vertical center
        color = (1.0, 0.0, 0.0, 1.0) if self.pressed else (0.0, 1.0, 0.0, 1.0)
        return renderer.render(
            [
                DrawCommand(RenderOperation.STENCIL, self.shape, t),
                DrawCommand(
                    RenderOperation.COLOR, self.shape, t, color=color
                ),
            ],
            to_host=False,
        )


class TestFrameLoop:
    def test_events_resize_and_sink(self):
        app = MovingRectApp()
        sink = CollectSink()
        loop = FrameLoop(app, 64, 64, sink=sink)
        assert app.created == 1

        frame0 = loop.step()
        assert frame0.shape == (64, 64, 4) and frame0.dtype == np.uint8
        # Rect centered at x=16: covered there, empty at x=48.
        assert frame0[32, 16, 1] == 255 and frame0[32, 16, 3] == 255
        assert frame0[32, 48, 3] == 0

        # Events queue until the next frame boundary.
        loop.send_pointer(48.0, 32.0)
        loop.send_button(True)
        frame1 = loop.step()
        assert frame1[32, 48, 0] == 255  # moved and red
        assert frame1[32, 16, 3] == 0

        # Resize rebuilds per-resolution state and notifies the app.
        loop.request_resize(64, 32)
        frame2 = loop.step()
        assert app.resized == 1
        assert frame2.shape == (32, 64, 4)
        assert frame2[16, 48, 0] == 255

        # The sink saw every presented frame; timing accumulated.
        assert len(sink.frames) == 3
        assert loop.timer.frame_index == 3 and loop.timer.average_s > 0

    @pytest.mark.slow  # heavy compile/exec; smoke coverage stays in the fast gate
    def test_background_composite(self):
        app = MovingRectApp()
        loop = FrameLoop(app, 64, 64, background=(1.0, 1.0, 1.0, 1.0))
        frame = loop.step()
        # Outside the rect: the white background, not transparent black.
        assert tuple(frame[2, 60]) == (255, 255, 255, 255)


class TestViewerServer:
    """The live-browser presentation surface (examples/viewer_server.py)
    — the analogue of the reference's index.html + server.js
    WASM hosting (component #16): page served, raw-RGBA frames rendered
    per camera state over HTTP."""

    def test_page_and_frames_over_http(self):
        import sys
        import threading
        import urllib.request
        from http.server import ThreadingHTTPServer

        sys.path.insert(
            0,
            os.path.join(os.path.dirname(__file__), "..", "examples"),
        )
        import viewer_server

        size = 64
        session = viewer_server.ShowcaseSession(
            size, size, with_text=False, scout_frames=2
        )
        server = ThreadingHTTPServer(
            ("127.0.0.1", 0), viewer_server.make_handler(session)
        )
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            page = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/", timeout=60
            ).read().decode()
            assert "<canvas" in page and str(size) in page
            raw = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/frame?yaw=0.3&pitch=0.1"
                "&dist=5&t=0.5",
                timeout=600,
            ).read()
            frame = np.frombuffer(raw, np.uint8).reshape(size, size, 4)
            assert (frame[..., 3] == 255).all()  # composited over white
            assert frame[..., :3].min() < 250    # some ink rendered
            # A second camera state renders a different frame.
            raw2 = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/frame?yaw=1.1&pitch=0.4"
                "&dist=7&t=1.0",
                timeout=600,
            ).read()
            assert raw2 != raw
        finally:
            server.shutdown()
            server.server_close()
