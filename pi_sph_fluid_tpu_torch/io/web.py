"""Live browser display sink — the desktop SDL-window analog.

A copy of `pi_sph_fluid_tpu/io/web.py:38-187` for the port (framework-free host code).

The reference's desktop build opens an SDL window emulating the OLED
(`Makefile:18-23`, `pi_sph_fluid.c:8`).  Here the analog is a zero-
dependency localhost HTTP server: ``WebSink`` keeps the latest page-packed
framebuffer and serves

    /        a canvas page that polls and draws frames (~30 Hz)
    /frame   the raw framebuffer bytes (SSD1306 page packing, byte
             ``i//8*cols + j``, bit ``i%8`` — unpacked client-side)
    /meta    {"rows": R, "cols": C, "frames": N}

and accepts

    POST /gravity   {"tx": f, "ty": f} — a tilt vector in sim coordinates
                    (y up), unit-disc clamped server-side

which makes the browser the accelerometer: the page converts pointer
drags (and, on phones, ``deviceorientation``) into tilt posts, and
``io.gravity.WebGravity`` reads the latest tilt exactly like
``MPU6050Gravity`` reads its 10 Hz sysfs sample (`pi_sph_fluid.c:431-464`)
— the reference's tilt-to-slosh interactivity without the hardware.

Wrap in io.display.AsyncSink like every other sink so the sim loop never
blocks on a slow client (the reference's tearing-tolerant contract).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

__all__ = ["WebSink"]

_PAGE = """<!doctype html>
<html><head><title>pi_sph_fluid_tpu</title><style>
 body { background:#111; color:#9ae; font-family:monospace; text-align:center }
 canvas { image-rendering: pixelated; border:1px solid #345; margin-top:2em;
          touch-action:none; cursor:crosshair }
</style></head><body>
<h3>pi_sph_fluid_tpu &mdash; live</h3>
<canvas id=c></canvas><div id=s></div>
<div id=hint>drag on the canvas to tilt gravity &middot; double-click to reset</div>
<script>
const cv = document.getElementById('c'), st = document.getElementById('s');
let rows = 64, cols = 128, scale = 6, frames = 0;
let tilt = [0, -1], dirty = false, dragging = false;
async function meta() {
  const m = await (await fetch('/meta')).json();
  rows = m.rows; cols = m.cols;
  cv.width = cols; cv.height = rows;
  cv.style.width = (cols * scale) + 'px';
  cv.style.height = (rows * scale) + 'px';
}
function setTilt(tx, ty) {           // sim coords, y up; clamp to unit disc
  const n = Math.hypot(tx, ty);
  if (n > 1) { tx /= n; ty /= n; }
  tilt = [tx, ty]; dirty = true;
}
function pointerTilt(e) {            // gravity points from center toward pointer
  const r = cv.getBoundingClientRect();
  const tx = (e.clientX - r.left - r.width / 2) / (r.width / 2);
  const ty = -(e.clientY - r.top - r.height / 2) / (r.height / 2);
  setTilt(tx, ty);
}
cv.addEventListener('pointerdown', e => { dragging = true; cv.setPointerCapture(e.pointerId); pointerTilt(e); });
cv.addEventListener('pointermove', e => { if (dragging) pointerTilt(e); });
cv.addEventListener('pointerup', () => { dragging = false; });
cv.addEventListener('dblclick', () => setTilt(0, -1));
window.addEventListener('deviceorientation', e => {   // phone: real tilt
  if (e.gamma === null || dragging) return;
  setTilt(Math.sin(e.gamma * Math.PI / 180), -Math.cos(e.beta * Math.PI / 180));
});
setInterval(() => {                  // ~20 Hz, only on change (MPU polls at 10 Hz)
  if (!dirty) return;
  dirty = false;
  fetch('/gravity', {method: 'POST', body: JSON.stringify({tx: tilt[0], ty: tilt[1]})})
    .catch(() => {});
}, 50);
async function tick() {
  try {
    const buf = new Uint8Array(await (await fetch('/frame')).arrayBuffer());
    const ctx = cv.getContext('2d');
    const img = ctx.createImageData(cols, rows);
    for (let i = 0; i < rows; i++) for (let j = 0; j < cols; j++) {
      const lit = (buf[(i >> 3) * cols + j] >> (i & 7)) & 1;
      // framebuffer row 0 is the TOP of the screen (pixel_centers flips y
      // already, `pi_sph_fluid.c:570-577`) — draw rows in order, same as
      // the SSD1306/terminal/PNG sinks
      const o = (i * cols + j) * 4;
      img.data[o] = lit ? 160 : 12; img.data[o+1] = lit ? 210 : 14;
      img.data[o+2] = lit ? 255 : 22; img.data[o+3] = 255;
    }
    ctx.putImageData(img, 0, 0);
    const gx = cols / 2, gy = rows / 2, gl = Math.min(gx, gy) * 0.8;
    ctx.strokeStyle = '#e84'; ctx.lineWidth = 1; ctx.beginPath();
    ctx.moveTo(gx, gy); ctx.lineTo(gx + tilt[0] * gl, gy - tilt[1] * gl);
    ctx.stroke();                    // gravity arrow (canvas y down)
    st.textContent = 'frame ' + (++frames);
  } catch (e) { st.textContent = 'disconnected'; }
  setTimeout(tick, 33);
}
meta().then(tick);
</script></body></html>"""


class WebSink:
    """Serves the latest framebuffer to a browser on localhost."""

    def __init__(self, port: int = 8742, rows: int = 64, cols: int = 128):
        self.rows, self.cols = rows, cols
        self._frame = bytes(rows // 8 * cols)
        self._count = 0
        self._tilt: np.ndarray | None = None   # latest POSTed tilt (unit disc)
        self._lock = threading.Lock()
        sink = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def do_POST(self):
                if self.path != "/gravity":
                    self.send_error(404)
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n))
                    tilt = np.asarray([req["tx"], req["ty"]], np.float32)
                    if not np.all(np.isfinite(tilt)):
                        raise ValueError("non-finite tilt")
                except (ValueError, KeyError, TypeError) as e:
                    self.send_error(400, explain=str(e))
                    return
                norm = float(np.hypot(*tilt))   # belt to the client-side clamp
                if norm > 1.0:
                    tilt /= norm
                with sink._lock:
                    sink._tilt = tilt
                self.send_response(204)
                self.end_headers()

            def do_GET(self):
                if self.path == "/frame":
                    with sink._lock:
                        body = sink._frame
                    ctype = "application/octet-stream"
                elif self.path == "/meta":
                    with sink._lock:
                        body = json.dumps({
                            "rows": sink.rows, "cols": sink.cols,
                            "frames": sink._count}).encode()
                    ctype = "application/json"
                else:
                    body = _PAGE.encode()
                    ctype = "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        print(f"web display: http://127.0.0.1:{self.port}/", flush=True)

    def push(self, framebuffer: np.ndarray) -> None:
        with self._lock:
            self._frame = np.asarray(framebuffer, np.uint8).tobytes()
            self._count += 1

    def tilt(self) -> np.ndarray | None:
        """Latest browser-posted tilt (unit-disc vector, sim coords, y up),
        or None before the first post.  Consumed by io.gravity.WebGravity."""
        with self._lock:
            return None if self._tilt is None else self._tilt.copy()

    def close(self) -> None:
        self._httpd.shutdown()
        self._thread.join(timeout=1.0)
