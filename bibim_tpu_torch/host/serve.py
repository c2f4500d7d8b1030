"""Live viewer (port of ``bibim_tpu.host.serve``) — the window + present
loop, served over HTTP.

The reference is a windowed interactive app: it creates an SDL window
(main.cpp:192-196), polls events into Input, and presents each rendered
frame to the swapchain (main.cpp:1367-1380). On a headless GPU host the
display surface is a browser tab instead of a swapchain: this module
streams :meth:`Session.render` frames as MJPEG (multipart/x-mixed-replace
— every browser renders it natively, no client code needed) and feeds
browser key/mouse events back into :meth:`Session.handle_event`, so a
human drives WASD + mouse-look against a moving image exactly like the
reference's present loop.

Run:  python -m bibim_tpu_torch.host.app --scene shaderball --serve 8000
Open: http://localhost:8000/        (click the image to grab the mouse;
                                     WASD moves, drag looks, Esc releases)

Endpoints:
  GET  /            control page (stream + event capture + UI toggles)
  GET  /stream      MJPEG frame stream (the present loop)
  GET  /frame.jpg   one frame (poll / screenshot)
  POST /event       JSON event or list of events (host/session.py format)
  GET  /stats       {"fps": ..., "frames": ..., "size": [w, h],
                     "stages": the render_frame stages' median host ms,
                     host syncs and K1 tail launches over the last 60
                     frames}
  GET  /ui          the session's UiState (camera fields from the live
                    camera)
  GET  /materials   {"names": [...], "selected": i}
  GET  /preview/N.jpg  material N's map strip

An exception that ends the render loop is kept: :meth:`ViewerServer.stop`
and :meth:`ViewerServer.wait_for_frame` raise it, and ``/frame.jpg``
answers 500 with it. The JPEG encode rides the native runtime
(``bibim_tpu_torch.native.encode_jpeg``; PIL where the library does not
load).
"""

from __future__ import annotations

import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from bibim_tpu_torch.utils import profiling
from bibim_tpu_torch.utils.log import log_info, log_warning

# The newest span records /stats reads: 60 frames of a dozen or so each,
# with room.
STATS_RECORDS = 2048


def encode_frame_jpeg(img: np.ndarray, quality: int = 85) -> bytes:
    """(H, W, 3|4) uint8 → JPEG bytes (native encoder, PIL fallback)."""
    from bibim_tpu_torch import native

    arr = np.ascontiguousarray(img)
    data = native.encode_jpeg(arr, quality)
    if data is not None:
        return data
    from io import BytesIO

    from PIL import Image

    buf = BytesIO()
    Image.fromarray(arr[:, :, :3]).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


class FrameHub:
    """Latest-frame mailbox between the render thread and any number of
    stream connections (the swapchain image the present loop replaces).
    Streams always show the newest frame; slow clients skip, never lag."""

    def __init__(self):
        self._cond = threading.Condition()
        self._seq = 0
        self._data: bytes | None = None

    def publish(self, data: bytes) -> None:
        with self._cond:
            self._seq += 1
            self._data = data
            self._cond.notify_all()

    def wake(self) -> None:
        """Wake every waiter (the render loop ended)."""
        with self._cond:
            self._cond.notify_all()

    def wait_next(self, last_seq: int, timeout: float = 1.0):
        """Block until a frame newer than ``last_seq`` exists (or timeout,
        or :meth:`wake`); returns (seq, bytes|None)."""
        with self._cond:
            if self._seq == last_seq:
                self._cond.wait(timeout)
            if self._seq == last_seq:
                return last_seq, None
            return self._seq, self._data


_PAGE = """<!doctype html>
<html><head><title>bibim_tpu</title><style>
  body { margin: 0; background: #111; color: #ddd;
         font: 13px monospace; display: flex; flex-direction: column;
         align-items: center; }
  #view { margin-top: 8px; cursor: crosshair; outline: 1px solid #333; }
  #bar { padding: 6px; }
  #bar * { font: inherit; margin-right: 8px; }
</style></head><body>
<div id="bar">
  <b>bibim_tpu</b>
  <span>click image &rarr; drag = look, WASD = move</span>
  <label>scene <select id="scene">
    <option>shaderball</option><option>triangle</option>
    <option>gizmo</option><option>cube</option>
  </select></label>
  <label>path <select id="path">
    <option value="deferred">deferred</option>
    <option value="forward">forward</option>
  </select></label>
  <label>viz <select id="viz">
    <option>scene</option><option>position</option><option>normal</option>
    <option>albedo</option><option>mrha</option><option>matindex</option>
  </select></label>
  <span id="stats"></span>
</div>
<div id="bar">
  <label>exposure <input id="exp" type="range" min="0.1" max="4" step="0.1"
    value="1"></label>
  <label>tonemap <input id="tm" type="checkbox" checked></label>
  <label>normal map <input id="nm" type="checkbox"></label>
  <label>TBN <input id="tbn" type="checkbox"></label>
  <label>HUD <input id="hud" type="checkbox"></label>
  <label>aniso <select id="aniso">
    <option>1</option><option>2</option><option>4</option>
    <option>8</option><option>16</option>
  </select></label>
  <label>instances <input id="inst" type="number" min="1" max="100"
    value="1" style="width:4em"></label>
  <label>material <select id="mat"></select></label>
  <label>preview <input id="showprev" type="checkbox"></label>
</div>
<img id="view" src="/stream">
<img id="prev" style="display:none; margin-top:8px" width="768">
<script>
const view = document.getElementById('view');
const post = (ev) => fetch('/event', {method: 'POST',
  body: JSON.stringify(ev)});
let dragging = false;
view.addEventListener('mousedown', (e) => {
  dragging = true;
  post({mouse: true, cursor: [e.offsetX, e.offsetY]});
});
window.addEventListener('mouseup', () => {
  dragging = false; post({mouse: false});
});
view.addEventListener('mousemove', (e) => {
  if (dragging) post({cursor: [e.offsetX, e.offsetY]});
});
const KEYS = {w: 'w', a: 'a', s: 's', d: 'd'};
window.addEventListener('keydown', (e) => {
  const k = KEYS[e.key.toLowerCase()];
  if (k && !e.repeat) post({key: k, down: true});
});
window.addEventListener('keyup', (e) => {
  const k = KEYS[e.key.toLowerCase()];
  if (k) post({key: k, down: false});
});
const el = (id) => document.getElementById(id);
el('exp').addEventListener('input', (e) =>
  post({set: {exposure: parseFloat(e.target.value)}}));
el('tm').addEventListener('change', (e) =>
  post({set: {enable_tone_mapping: e.target.checked}}));
el('viz').addEventListener('change', (e) =>
  post({set: {gbuffer_viz: e.target.value}}));
el('scene').addEventListener('change', (e) =>
  post({set: {scene: e.target.value}}));
el('path').addEventListener('change', (e) =>
  post({set: {deferred: e.target.value === 'deferred'}}));
el('nm').addEventListener('change', (e) =>
  post({set: {enable_normal_map: e.target.checked}}));
el('tbn').addEventListener('change', (e) =>
  post({set: {enable_tbn: e.target.checked}}));
el('hud').addEventListener('change', (e) =>
  post({set: {show_hud: e.target.checked}}));
el('inst').addEventListener('change', (e) =>
  post({set: {num_instances: Math.max(1, parseInt(e.target.value) || 1)}}));
el('aniso').addEventListener('change', (e) =>
  post({set: {aniso_taps: parseInt(e.target.value)}}));
const updatePreview = () => {
  const show = el('showprev').checked;
  el('prev').style.display = show ? '' : 'none';
  if (show) el('prev').src = '/preview/' + el('mat').value +
    '.jpg?t=' + Date.now();
};
el('mat').addEventListener('change', (e) => {
  post({set: {selected_material: parseInt(e.target.value)}});
  updatePreview();
});
el('showprev').addEventListener('change', updatePreview);
(async () => {
  // Initialize every control from the session's live UI state + the
  // material list (the reference GUI reflects scene state the same way).
  const ui = await (await fetch('/ui')).json();
  const mats = await (await fetch('/materials')).json();
  el('mat').innerHTML = mats.names.map((n, i) =>
    `<option value="${i}">${n}</option>`).join('');
  el('mat').value = ui.selected_material;
  el('scene').value = ui.scene;
  el('path').value = ui.deferred ? 'deferred' : 'forward';
  el('viz').value = ui.gbuffer_viz;
  el('exp').value = ui.exposure;
  el('tm').checked = ui.enable_tone_mapping;
  el('nm').checked = ui.enable_normal_map;
  el('tbn').checked = ui.enable_tbn;
  el('hud').checked = ui.show_hud;
  el('inst').value = ui.num_instances;
  el('aniso').value = ui.aniso_taps;
})();
setInterval(async () => {
  const s = await (await fetch('/stats')).json();
  el('stats').textContent =
    s.fps.toFixed(1) + ' fps  ' + s.size[0] + 'x' + s.size[1];
}, 1000);
</script></body></html>
"""

_BOUNDARY = b"bibimframe"

# Bounded pending-event queue (the SDL-event-queue-full analog): a client
# flooding /event faster than the render loop drains — e.g. during the
# first frame's autotune and kernel build — must not grow host memory
# without bound. Oldest events drop first; 8192 is ~minutes of mousemove
# spam at browser rates, so the cap only engages when the render loop is
# stalled.
_EVENT_QUEUE_CAP = 8192


class ViewerServer:
    """Owns the render thread (the reference's main loop) and the HTTP
    server (its window/present surface)."""

    def __init__(self, session, host: str = "127.0.0.1", port: int = 8000,
                 max_fps: float = 60.0, quality: int = 85):
        self.session = session
        self.hub = FrameHub()
        self.quality = quality
        self.max_fps = max_fps
        self.frames = 0
        self.events_dropped = 0  # queue-cap drops (see _EVENT_QUEUE_CAP)
        self.error: BaseException | None = None  # what ended the loop
        self._previews: dict = {}  # material idx → preview JPEG bytes
        self._events: list[dict] = []
        self._ev_lock = threading.Lock()
        self._running = False
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet access log
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send(200, "text/html", _PAGE.encode())
                elif self.path == "/frame.jpg":
                    _, data = viewer.hub.wait_next(-1, timeout=10.0)
                    if viewer.error is not None:
                        self._send(500, "text/plain",
                                   f"render loop ended: {viewer.error!r}"
                                   .encode())
                    elif data is None:
                        self._send(503, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/jpeg", data)
                elif self.path == "/stats":
                    w, h = viewer.session.width, viewer.session.height
                    body = json.dumps({
                        "fps": viewer.session.stats.fps,
                        "ms_per_frame": viewer.session.stats.ms_per_frame,
                        "frames": viewer.frames,
                        "size": [w, h],
                        "stages": profiling.stage_medians(
                            profiling.snapshot(last=STATS_RECORDS)),
                    }).encode()
                    self._send(200, "application/json", body)
                elif self.path == "/ui":
                    from dataclasses import asdict

                    # UiState's camera fields are the save/load snapshot;
                    # refresh them from the LIVE camera so the page (and
                    # scripted pollers) see the pose drags produced.
                    ui, cam = viewer.session.ui, viewer.session.camera
                    ui.camera_pos = tuple(float(v) for v in cam.pos)
                    ui.camera_yaw = float(cam.yaw)
                    ui.camera_pitch = float(cam.pitch)
                    self._send(200, "application/json",
                               json.dumps(asdict(ui)).encode())
                elif self.path == "/materials":
                    names = list(viewer.session.material_set().names)
                    body = json.dumps({
                        "names": names,
                        "selected": viewer.session.ui.selected_material,
                    }).encode()
                    self._send(200, "application/json", body)
                elif (self.path.startswith("/preview/")
                      and self.path.split("?")[0].endswith(".jpg")):
                    stem = self.path.split("?")[0][len("/preview/"):-4]
                    try:
                        idx = int(stem)
                    except ValueError:
                        self._send(404, "text/plain", b"bad material index")
                        return
                    data = viewer.material_preview_jpeg(idx)
                    if data is None:
                        self._send(404, "text/plain", b"no such material")
                    else:
                        self._send(200, "image/jpeg", data)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=" +
                        _BOUNDARY.decode(),
                    )
                    self.end_headers()
                    seq = -1
                    try:
                        while viewer._running:
                            seq, data = viewer.hub.wait_next(seq, 1.0)
                            if data is None:
                                continue
                            self.wfile.write(
                                b"--" + _BOUNDARY + b"\r\n"
                                b"Content-Type: image/jpeg\r\n"
                                b"Content-Length: " +
                                str(len(data)).encode() + b"\r\n\r\n" +
                                data + b"\r\n"
                            )
                    except OSError:
                        # Client closed mid-stream (browser tab gone, drag
                        # resize storm): unwind this handler thread; the
                        # hub and render loop are unaffected.
                        pass
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path != "/event":
                    self._send(404, "text/plain", b"not found")
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    evs = json.loads(self.rfile.read(n))
                except (ValueError, UnicodeDecodeError):
                    self._send(400, "text/plain", b"bad json")
                    return
                if isinstance(evs, dict):
                    evs = [evs]
                if not isinstance(evs, list) or not all(
                        isinstance(e, dict) for e in evs):
                    self._send(400, "text/plain",
                               b"an event is a JSON object")
                    return
                with viewer._ev_lock:
                    viewer._events.extend(evs)
                    if len(viewer._events) > _EVENT_QUEUE_CAP:
                        drop = len(viewer._events) - _EVENT_QUEUE_CAP
                        del viewer._events[:drop]
                        viewer.events_dropped += drop
                self._send(200, "application/json", b"{}")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._render_thread = threading.Thread(
            target=self._render_loop, name="bibim-render", daemon=True
        )
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, name="bibim-http", daemon=True
        )

    def material_preview_jpeg(self, idx: int, tile: int = 128):
        """One material's PBR map strip as JPEG (the ImGui material
        preview analog, scene.cpp:152-168): one tile per map type,
        left→right in PBRMapType order. Cached per index."""
        from bibim_tpu_torch.host.session import material_preview_strip

        ms = self.session.material_set()
        if not (0 <= idx < len(ms.names)):
            return None
        cached = self._previews.get(idx)
        if cached is None:
            cached = encode_frame_jpeg(
                material_preview_strip(ms, idx, tile), quality=90)
            self._previews[idx] = cached
        return cached

    # -- the frame loop (main.cpp:1131-1381, events → render → present) ----

    def _render_loop(self):
        try:
            self._frame_loop()
        except Exception as e:  # noqa: BLE001 - kept; stop() raises it
            self.error = e
            log_warning("viewer: the render loop ended: {}",
                        "".join(traceback.format_exception(e)))
        finally:
            self._running = False
            self.hub.wake()

    def _frame_loop(self):
        last = time.perf_counter()
        while self._running:
            with self._ev_lock:
                evs, self._events = self._events, []
            for ev in evs:
                try:
                    self.session.handle_event(ev)
                except ValueError as e:
                    log_info("viewer: dropped bad event {}: {}", ev, e)
            now = time.perf_counter()
            dt, last = now - last, now
            img = self.session.render(min(dt, 0.25))
            if img is not None:
                self.hub.publish(encode_frame_jpeg(img, self.quality))
                self.frames += 1
            # Throttle: the frame itself paces the loop; this only stops
            # a tiny scene from spinning the host CPU.
            budget = 1.0 / self.max_fps - (time.perf_counter() - now)
            if budget > 0:
                time.sleep(budget)

    def _raise_if_failed(self) -> None:
        if self.error is not None:
            raise self.error

    def wait_for_frame(self, timeout: float = 30.0, after: int = 0):
        """Block until a frame newer than sequence number ``after`` is
        published; returns (seq, JPEG bytes). Raises the exception that
        ended the render loop, if one did, and TimeoutError after
        ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        while True:
            self._raise_if_failed()
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"no frame within {timeout} s")
            seq, data = self.hub.wait_next(after, min(left, 1.0))
            if data is not None:
                return seq, data

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        self._running = True
        self._render_thread.start()
        self._http_thread.start()
        log_info("live viewer on http://{}:{}/ (scene {!r}, {}x{})",
                 self.httpd.server_address[0], self.port,
                 self.session.ui.scene, self.session.width,
                 self.session.height)
        return self

    def stop(self, timeout: float = 30.0):
        """Stop the render loop and the HTTP server, join both threads,
        and raise the exception that ended the loop, if one did
        (RuntimeError if the render thread does not end within
        ``timeout`` seconds)."""
        self._running = False
        if self._render_thread.is_alive():
            self._render_thread.join(timeout=timeout)
        if self._http_thread.is_alive():
            self.httpd.shutdown()
            self._http_thread.join(timeout=timeout)
        self.httpd.server_close()
        if self._render_thread.is_alive():
            raise RuntimeError(f"the render thread did not stop within "
                               f"{timeout} s")
        self._raise_if_failed()

    def serve_until_interrupt(self):
        try:
            while self._render_thread.is_alive():
                self._render_thread.join(timeout=1.0)
        except KeyboardInterrupt:
            log_info("viewer: shutting down")
        finally:
            self.stop()
