"""Live browser viewer: orbit the showcase against the real chip.

The equivalent of the reference's in-browser presentation
surface (examples/showcase/index.html:7-11 canvas + module loader,
server.js:15-38 dev server, examples/showcase/main.rs:255-274 mouse
orbit/zoom): a stdlib HTTP server renders frames on demand through the
fused ``FrameProgram`` and streams them to a <canvas>; the browser's
pointer events drive the same yaw/pitch/distance camera the reference
accumulates from winit cursor deltas.

The browser requests the next frame as soon as the previous one
arrives (natural backpressure — the render device is never more than
one frame ahead of the viewer), sending the ABSOLUTE camera state each
time so the server stays stateless.  Frames render kernel-packed RGBA8
(the presentation format) and are composited over the page background
server-side, so the canvas blit is a raw putImageData.

Usage:
    python examples/viewer_server.py [--size WxH] [--port 8080]
                                     [--no-text]
then open http://localhost:8080/.
"""

import argparse
import json
import logging
import math
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

PAGE = """<!DOCTYPE html>
<html>
<head><meta charset="utf-8"><title>contrast_renderer — showcase</title>
<style>
 body { margin: 0; background: #222; color: #ddd;
        font: 13px system-ui, sans-serif; }
 #bar { padding: 6px 10px; }
 canvas { display: block; margin: 0 auto; cursor: grab;
          touch-action: none; }
</style></head>
<body>
<div id="bar">drag to orbit &middot; wheel to zoom &middot;
 <span id="fps">...</span></div>
<canvas id="c" width="__W__" height="__H__"></canvas>
<script>
const W = __W__, H = __H__;
const canvas = document.getElementById('c');
const ctx = canvas.getContext('2d');
const img = ctx.createImageData(W, H);
let yaw = 0.0, pitch = 0.0, dist = 5.0, dragging = false, last = null;
canvas.addEventListener('pointerdown', e => {
  dragging = true; last = [e.clientX, e.clientY];
  canvas.setPointerCapture(e.pointerId);
});
canvas.addEventListener('pointerup', () => { dragging = false; });
canvas.addEventListener('pointermove', e => {
  if (!dragging || !last) { last = [e.clientX, e.clientY]; return; }
  yaw += (e.clientX - last[0]) * 0.005;     // main.rs:255-267
  pitch += (e.clientY - last[1]) * 0.005;
  last = [e.clientX, e.clientY];
});
canvas.addEventListener('wheel', e => {
  e.preventDefault();
  dist = Math.min(100, Math.max(1, dist * Math.exp(0.001 * e.deltaY)));
}, { passive: false });
let frames = 0, t0 = performance.now();
async function loop() {
  for (;;) {
    const t = performance.now() / 1000;
    const q = `yaw=${yaw}&pitch=${pitch}&dist=${dist}&t=${t}`;
    const resp = await fetch('/frame?' + q);
    if (!resp.ok) { await new Promise(r => setTimeout(r, 250)); continue; }
    const buf = new Uint8Array(await resp.arrayBuffer());
    img.data.set(buf);
    ctx.putImageData(img, 0, 0);
    if (++frames % 16 === 0) {
      const now = performance.now();
      document.getElementById('fps').textContent =
        (16000 / (now - t0)).toFixed(1) + ' fps (round-trip)';
      t0 = now;
    }
  }
}
loop();
</script></body></html>
"""


class ShowcaseSession:
    """One showcase FrameProgram + the camera math shared with
    examples/orbit_camera.py (the reference's event-driven camera,
    main.rs:255-274)."""

    def __init__(self, width, height, with_text=True, scout_frames=16):
        from contrast_renderer.models import showcase
        from contrast_renderer.renderer import Configuration, Renderer

        self.width, self.height = width, height
        self.showcase = showcase
        self.renderer = Renderer(
            Configuration(), width, height, strict_capacity=False
        )
        self.shape = showcase.build_shape(with_text=with_text)
        commands = showcase.showcase_commands(self.shape, width, height)
        self.program = self.renderer.compile_frame(
            commands, uint8_output=True
        )
        # Pre-compile one fused grouping valid across a whole yaw
        # orbit so horizontal dragging dispatches the fused variant
        # immediately (other motions converge via the hysteresis in
        # _try_fused, or fall back to the sequential walk).
        # scout_frames yaw samples cover the circle — enough for the
        # grouping derivation and the capacity scout; CPU-only hosts
        # (tests) pass fewer, each scout frame costs a host prepare.
        if scout_frames:
            step = 2.0 * math.pi / scout_frames
            self.program.plan_for_motion(
                [
                    self._transforms(step * i, 0.0, 5.0)
                    for i in range(scout_frames)
                ],
                wait=False,
            )
        self._lock = threading.Lock()

    def _transforms(self, yaw, pitch, dist):
        from contrast_renderer.utils.matrix import (
            _quat_mul, rotate_around_axis)

        rotor = _quat_mul(
            rotate_around_axis(yaw, [0.0, 1.0, 0.0]),
            rotate_around_axis(pitch, [1.0, 0.0, 0.0]),
        )
        return self.showcase.command_transforms(
            self.width, self.height,
            view_rotation=rotor, view_distance=dist,
        )

    def frame(self, yaw, pitch, dist, t) -> bytes:
        with self._lock:
            self.shape.set_dynamic_stroke_options(
                0, self.showcase.dashed_options(t * 2.0)
            )
            image = np.asarray(
                self.program(self._transforms(yaw, pitch, dist))
            )
        # Premultiplied-over-white composite (uint16 to avoid wrap),
        # full alpha for the canvas blit.
        out = image.astype(np.uint16)
        inv = 255 - out[..., 3:4]
        out[..., :3] = np.minimum(out[..., :3] + inv, 255)
        out[..., 3] = 255
        return out.astype(np.uint8).tobytes()


def make_handler(session):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet per-request spam
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                page = PAGE.replace("__W__", str(session.width)).replace(
                    "__H__", str(session.height)
                )
                self._send(200, page.encode(), "text/html; charset=utf-8")
                return
            if url.path == "/frame":
                q = parse_qs(url.query)

                def f(name, default):
                    try:
                        v = float(q.get(name, [default])[0])
                    except ValueError:
                        return default
                    return v if math.isfinite(v) else default

                try:
                    body = session.frame(
                        f("yaw", 0.0), f("pitch", 0.0),
                        min(100.0, max(1.0, f("dist", 5.0))),
                        f("t", 0.0),
                    )
                except Exception:
                    logging.getLogger("viewer").exception("render failed")
                    self._send(500, b"render failed", "text/plain")
                    return
                self._send(200, body, "application/octet-stream")
                return
            if url.path == "/meta":
                body = json.dumps(
                    {"width": session.width, "height": session.height}
                ).encode()
                self._send(200, body, "application/json")
                return
            self._send(404, b"not found", "text/plain")

    return Handler


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", default="960x540")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--no-text", action="store_true")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("viewer")

    width, height = (int(x) for x in args.size.split("x"))
    t0 = time.perf_counter()
    session = ShowcaseSession(width, height, with_text=not args.no_text)
    # Warm the dispatch path so the first browser frame is instant.
    session.frame(0.0, 0.0, 5.0, 0.0)
    log.info(
        "showcase ready in %.1fs at %dx%d", time.perf_counter() - t0,
        width, height,
    )
    server = ThreadingHTTPServer(
        ("0.0.0.0", args.port), make_handler(session)
    )
    log.info("open http://localhost:%d/",
             args.port)
    server.serve_forever()


if __name__ == "__main__":
    main()
