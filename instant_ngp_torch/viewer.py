"""A minimal interactive web viewer: the headless stand-in for the
reference's GUI (port of ``instant_ngp_tpu/viewer.py``, on the standard
library's ``http.server`` as it is).

Serves a single-page orbit viewer over ``Testbed.render`` on the card:

    python -m instant_ngp_torch.viewer --snapshot snap.ingp [--port 8000] [--train]
    python -m instant_ngp_torch.viewer --scene /path/to/scene --train

Mouse drag orbits, wheel zooms; the page asks /render for JPEG frames
(``render_image``: the port's frame encoded by PIL, imported at the call; a
JPEG request without PIL raises) and /screenshot for PNG ones (the port's
own ``io/png.encode_png``). With --train a thread keeps training between
frames (``Testbed.frame()``). The control API under /api: ``state``,
``set`` (train, render mode and quality, exposure, fov, slice plane),
``save_snapshot``, ``level_stats`` and the camera-path editor (``path``,
``path_add``, ``path_remove``, ``path_clear``; /render's ``path_t`` scrubs
the path). ``ViewerServer(tb, port=0).make_server()`` binds a free port,
which a test or a script serves from a thread.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .io.png import encode_png

_PAGE = """<!DOCTYPE html>
<html><head><title>instant-ngp-torch viewer</title><style>
 body { margin:0; background:#111; color:#ccc; font-family:monospace; }
 #hud { position:fixed; top:8px; left:8px; background:#000c; padding:8px 12px;
        border:1px solid #333; border-radius:4px; min-width:240px; }
 #hud label { display:block; margin-top:4px; font-size:12px; }
 #hud select, #hud input[type=range] { width:130px; }
 #hud button { margin-top:6px; margin-right:4px; font-family:monospace; }
 canvas { background:#0008; display:block; margin-top:4px; }
 img { display:block; width:100vw; height:100vh; object-fit:contain;
       image-rendering:auto; cursor:grab; }
 .row { display:flex; justify-content:space-between; align-items:center; }
</style></head><body>
<div id="hud">
 <b>instant-ngp-torch</b> — drag orbits, wheel zooms<br>
 <span id="stats"></span>
 <canvas id="lossplot" width="224" height="48"></canvas>
 <div class="row"><label>train <input type="checkbox" id="train"></label>
   <span id="steprate"></span></div>
 <label class="row">mode <select id="mode">
  <option>shade</option><option>depth</option><option>normals</option>
  <option>positions</option><option>ao</option><option>cost</option>
  <option>encoding_vis</option><option>distortion</option><option>slice</option>
 </select></label>
 <label class="row">quality <select id="quality">
  <option>exact</option><option>fast</option><option>baked</option>
  <option>slab</option>
 </select></label>
 <label class="row">exposure <input type="range" id="exposure" min="-4"
   max="4" step="0.1" value="0"></label>
 <label class="row">fov <input type="range" id="fov" min="20" max="120"
   step="1" value="50"></label>
 <label class="row">res <select id="res">
  <option>192</option><option selected>384</option><option>768</option>
 </select></label>
 <button id="snap">save snapshot</button>
 <button id="shot">screenshot</button>
 <span id="msg"></span>
 <details id="lvls"><summary>hash-level stats</summary>
  <canvas id="lvlplot" width="224" height="64"></canvas>
  <div id="lvltxt" style="font-size:10px"></div>
 </details>
 <details id="pathpanel"><summary>camera path</summary>
  <div class="row">
   <button id="kfadd">+ key</button>
   <button id="kfdel">del</button>
   <button id="kfclear">clear</button>
   <span id="kfinfo">0 keys</span>
  </div>
  <label class="row">scrub <input type="range" id="patht" min="0" max="1"
    step="0.002" value="0"></label>
  <label class="row">play <input type="checkbox" id="pathplay"></label>
  <select id="kflist" size="4" style="width:100%"></select>
 </details>
</div>
<img id="view" draggable="false">
<script>
let theta = 0.0, phi = 0.3, radius = 2.0, busy = false, dirty = true;
const $ = id => document.getElementById(id);
const img = $('view');
let losses = [];
async function setOpt(k, v) {
  dirty = true;
  await fetch(`/api/set?${k}=${encodeURIComponent(v)}`);
}
$('train').addEventListener('change', e => setOpt('train', e.target.checked ? 1 : 0));
$('mode').addEventListener('change', e => setOpt('render_mode', e.target.value));
$('quality').addEventListener('change', e => setOpt('render_quality', e.target.value));
$('exposure').addEventListener('input', e => setOpt('exposure', e.target.value));
$('fov').addEventListener('input', e => setOpt('fov', e.target.value));
$('snap').addEventListener('click', async () => {
  const r = await fetch('/api/save_snapshot');
  $('msg').textContent = (await r.json()).path || 'saved';
});
$('shot').addEventListener('click', () => {
  window.open(`/screenshot?theta=${theta}&phi=${phi}&r=${radius}&w=1280&h=720`);
});
function drawLosses() {
  const c = $('lossplot').getContext('2d');
  c.clearRect(0, 0, 224, 48);
  if (losses.length < 2) return;
  const mx = Math.max(...losses), mn = Math.min(...losses);
  c.strokeStyle = '#6cf'; c.beginPath();
  losses.forEach((v, i) => {
    const x = i / (losses.length - 1) * 224;
    const y = 46 - 44 * (mx > mn ? (v - mn) / (mx - mn) : 0.5);
    i ? c.lineTo(x, y) : c.moveTo(x, y);
  });
  c.stroke();
}
async function pollState() {
  try {
    const s = await (await fetch('/api/state')).json();
    $('stats').textContent =
      `step=${s.step} loss=${s.loss?.toExponential?.(3) ?? s.loss}`;
    $('steprate').textContent = s.train_ms ? `${s.train_ms.toFixed(0)} ms/step` : '';
    if (document.activeElement !== $('train')) $('train').checked = !!s.shall_train;
    losses = s.loss_graph || losses;
    drawLosses();
  } catch (e) {}
  setTimeout(pollState, 1000);
}
async function refresh() {
  if (busy || !dirty) { setTimeout(refresh, 30); return; }
  busy = true; dirty = false;
  const res = +$('res').value;
  const t0 = performance.now();
  try {
    const pt = pathT !== null ? `&path_t=${pathT}` : '';
    const r = await fetch(`/render?theta=${theta}&phi=${phi}&r=${radius}&w=${res}&h=${res}${pt}`);
    const blob = await r.blob();
    img.src = URL.createObjectURL(blob);
    $('msg').textContent = `${(performance.now() - t0).toFixed(0)} ms/frame`;
  } catch (e) {}
  busy = false;
  setTimeout(refresh, 10);
}
// ---- hash-level histogram panel (reference testbed.cu:5234-5284) ----
async function pollLevels() {
  if ($('lvls').open) {
    try {
      const ls = await (await fetch('/api/level_stats')).json();
      const c = $('lvlplot').getContext('2d');
      c.clearRect(0, 0, 224, 64);
      const mx = Math.max(1e-9, ...ls.map(l => l.std));
      const bw = 224 / Math.max(ls.length, 1);
      ls.forEach((l, i) => {
        c.fillStyle = l.hashed ? '#fa6' : '#6cf';
        const h = 58 * l.std / mx;
        c.fillRect(i * bw + 2, 62 - h, bw - 4, h);
      });
      $('lvltxt').textContent = ls.map(
        (l, i) => `L${i}:${l.resolution}`).join(' ');
    } catch (e) {}
  }
  setTimeout(pollLevels, 2000);
}
// ---- camera-path keyframe editor (reference camera_path.cu) ----
let pathT = null;
async function pathRefresh() {
  const p = await (await fetch('/api/path')).json();
  $('kfinfo').textContent = `${p.n} keys`;
  const sel = $('kflist');
  sel.innerHTML = '';
  (p.keyframes || []).forEach((k, i) => {
    const o = document.createElement('option');
    o.value = i;
    o.textContent = `#${i} t=${k.timestamp.toFixed(2)} fov=${k.fov.toFixed(0)}`;
    sel.appendChild(o);
  });
}
$('kfadd').addEventListener('click', async () => {
  await fetch(`/api/path_add?theta=${theta}&phi=${phi}&r=${radius}`);
  pathRefresh();
});
$('kfdel').addEventListener('click', async () => {
  const i = $('kflist').value;
  if (i !== '') { await fetch(`/api/path_remove?i=${i}`); pathRefresh(); }
});
$('kfclear').addEventListener('click', async () => {
  await fetch('/api/path_clear'); pathRefresh();
});
$('patht').addEventListener('input', e => {
  pathT = +e.target.value; dirty = true;
});
setInterval(() => {
  if ($('pathplay').checked) {
    pathT = ((pathT ?? 0) + 0.01) % 1;
    $('patht').value = pathT; dirty = true;
  }
}, 100);
let drag = null;
img.addEventListener('pointerdown', e => { drag = [e.clientX, e.clientY]; });
window.addEventListener('pointermove', e => {
  if (!drag) return;
  pathT = null;  // manual orbit overrides path playback
  theta += (e.clientX - drag[0]) * 0.01;
  phi = Math.max(-1.5, Math.min(1.5, phi + (e.clientY - drag[1]) * 0.01));
  drag = [e.clientX, e.clientY]; dirty = true;
});
window.addEventListener('pointerup', () => { drag = null; });
window.addEventListener('wheel', e => {
  radius = Math.max(0.3, Math.min(10, radius * Math.exp(e.deltaY * 0.001)));
  dirty = true;
});
setInterval(() => { dirty = true; }, 2000);  // pick up training progress
pollState();
pollLevels();
pathRefresh();
refresh();
</script></body></html>"""


def orbit_matrix(theta: float, phi: float, radius: float,
                 center=(0.5, 0.5, 0.5)) -> np.ndarray:
    """Camera-to-world 3×4 looking at ``center`` from spherical coords."""
    c = np.asarray(center, np.float32)
    eye = c + radius * np.array(
        [np.cos(phi) * np.sin(theta), np.sin(phi), -np.cos(phi) * np.cos(theta)], np.float32)
    fwd = c - eye
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    right = np.cross(fwd, up)
    nr = np.linalg.norm(right)
    if nr < 1e-6:
        right = np.array([1.0, 0.0, 0.0], np.float32)
    else:
        right /= nr
    up = np.cross(right, fwd)
    return np.stack([right, -up, fwd, eye], axis=1).astype(np.float32)


def encode_frame(frame: np.ndarray, fmt: str) -> bytes:
    """A frame's rgb (clipped to [0, 1], 8 bits) as PNG (the port's encoder)
    or JPEG (PIL, quality 90; raises where PIL is missing)."""
    rgb = (np.clip(np.asarray(frame)[..., :3], 0, 1) * 255).astype(np.uint8)
    if fmt == "PNG":
        return encode_png(rgb)
    if fmt != "JPEG":
        raise ValueError(f"unknown frame format {fmt!r}")
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=90)
    return buf.getvalue()


class ViewerServer:
    def __init__(self, testbed, port: int = 8000, train: bool = False,
                 predict_camera: bool = False, host: str = "0.0.0.0"):
        self.testbed = testbed
        self.port = port
        self.host = host
        self.train = train
        self._lock = threading.Lock()
        self._stop = False
        self._last_frame = None
        self._last_pose_t = None
        self.camera_predictor = None
        if predict_camera:
            from .render.camera_predictor import MatLogCameraPredictor

            self.camera_predictor = MatLogCameraPredictor(is_quadratic=False, is_se3=True,
                                                          half_life_s=0.25)

    def _train_loop(self):
        while not self._stop:
            with self._lock:
                self.testbed.frame()
            time.sleep(0.001)

    # ------------------------------------------------------------------
    # control API (the headless analog of the reference's ImGui panel:
    # train toggle, render mode/quality, exposure, snapshot save)
    # ------------------------------------------------------------------
    def state_json(self) -> dict:
        tb = self.testbed
        mode = getattr(tb, "render_mode", None)
        graph = list(tb.loss_graph[-128:]) if tb.loss_graph else []
        return {
            "step": tb.task.training_step if tb.task is not None else tb.training_step,
            "loss": float(tb.loss or 0.0),
            "shall_train": bool(tb.shall_train),
            "train_ms": float(tb.training_ms.val()),
            "render_ms": float(tb.render_ms.val()),
            "render_mode": getattr(mode, "value", str(mode)),
            "render_quality": tb.render_quality,
            "exposure": float(tb.exposure),
            "fov": float(tb.fov),
            "loss_graph": [round(float(v), 6) for v in graph],
        }

    def apply_settings(self, q: dict) -> dict:
        """Apply ?key=value settings under the render lock."""
        from .common import RenderMode

        tb = self.testbed
        applied = {}
        with self._lock:
            if "train" in q:
                tb.shall_train = q["train"][0] in ("1", "true", "on")
                applied["train"] = tb.shall_train
            if "render_mode" in q:
                tb.render_mode = RenderMode(q["render_mode"][0])
                applied["render_mode"] = tb.render_mode.value
            if "render_quality" in q:
                v = q["render_quality"][0]
                if v not in ("exact", "fast", "baked", "slab"):
                    raise ValueError(f"unknown render_quality {v!r}")
                tb.render_quality = v
                applied["render_quality"] = v
            if "exposure" in q:
                tb.exposure = float(q["exposure"][0])
                applied["exposure"] = tb.exposure
            if "fov" in q:
                tb.fov = float(q["fov"][0])
                applied["fov"] = tb.fov
            if "slice_plane_z" in q:
                tb.slice_plane_z = float(q["slice_plane_z"][0])
                applied["slice_plane_z"] = tb.slice_plane_z
        return applied

    def save_snapshot(self, path=None) -> str:
        path = str(path or f"viewer_step{self.testbed.training_step}.ingp")
        with self._lock:
            self.testbed.save_snapshot(path, include_optimizer_state=True)
        return path

    # ------------------------------------------------------------------
    # camera-path keyframe editor (reference camera_path.cu:170-588)
    # ------------------------------------------------------------------
    def path_json(self) -> dict:
        p = self.testbed.camera_path
        return {
            "n": len(p.keyframes),
            "duration_seconds": p.duration_seconds,
            "keyframes": [{"T": np.asarray(k.T, np.float32).tolist(),
                           "R": np.asarray(k.R, np.float32).tolist(),
                           "fov": float(k.fov), "timestamp": float(k.timestamp)}
                          for k in p.keyframes],
        }

    def path_add(self, theta, phi, radius) -> dict:
        p = self.testbed.camera_path
        with self._lock:
            p.add_camera(orbit_matrix(theta, phi, radius), fov=float(self.testbed.fov))
            p.make_keyframe_timestamps_equidistant()
        return self.path_json()

    def path_remove(self, i: int) -> dict:
        p = self.testbed.camera_path
        with self._lock:
            if 0 <= i < len(p.keyframes):
                p.keyframes.pop(i)
                if p.keyframes:
                    p.make_keyframe_timestamps_equidistant()
        return self.path_json()

    def path_clear(self) -> dict:
        with self._lock:
            self.testbed.camera_path.clear()
        return self.path_json()

    def level_stats_json(self) -> list:
        from .nerf.task import NerfTask, level_stats

        if not isinstance(self.testbed.task, NerfTask):
            return []
        with self._lock:
            return level_stats(self.testbed.task)

    def camera(self, theta, phi, radius, path_t=None) -> np.ndarray:
        """The view of a request: the camera path at ``path_t`` (setting the
        Testbed's fov from the keyframe) where one is loaded, else the orbit;
        then, with a camera predictor, where the camera will be once the
        frame lands (the last frame's render time ahead)."""
        path = self.testbed.camera_path
        if path_t is not None and not path.empty():
            path.sanitize_keyframes()
            kf = path.eval_camera_path(float(np.clip(path_t, 0.0, 1.0)))
            cam = np.asarray(kf.to_matrix(), np.float32)
            if getattr(kf, "fov", 0):
                self.testbed.fov = float(kf.fov)
        else:
            cam = orbit_matrix(theta, phi, radius)
        if self.camera_predictor is not None:
            now = time.perf_counter()
            last = self._last_pose_t
            self.camera_predictor.sample_camera(cam, (now - last) if last else 1 / 30)
            self._last_pose_t = now
            lat = self.testbed.render_ms.val() / 1000.0
            cam = np.asarray(self.camera_predictor.predict_camera(lat), np.float32)
        return cam

    def render_image(self, theta, phi, radius, w, h, fmt="JPEG", path_t=None) -> bytes:
        """A frame of ``Testbed.render`` from the request's view, encoded.
        With rendering paused (``is_rendering`` False) a JPEG request gets
        the last JPEG, so that training keeps the card; a PNG (a screenshot)
        renders afresh."""
        if not getattr(self.testbed, "is_rendering", True):
            if fmt == "JPEG" and self._last_frame is not None:
                return self._last_frame
        cam = self.camera(theta, phi, radius, path_t)
        with self._lock:
            frame = self.testbed.render(w, h, camera_matrix=cam)
        out = encode_frame(frame, fmt)
        if fmt == "JPEG":
            self._last_frame = out
        return out

    def make_server(self) -> ThreadingHTTPServer:
        """The HTTP server on (host, port); port 0 binds a free one
        (``server.server_address``)."""
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)

                def get(k, d):
                    return float(q.get(k, [d])[0])

                if u.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                    return
                if u.path in ("/render", "/screenshot"):
                    png = u.path == "/screenshot"
                    body = viewer.render_image(
                        get("theta", 0), get("phi", 0.3), get("r", 2.0), int(get("w", 384)),
                        int(get("h", 384)), fmt="PNG" if png else "JPEG",
                        path_t=float(q["path_t"][0]) if "path_t" in q else None)
                    info = json.dumps({"step": viewer.testbed.training_step,
                                       "loss": round(float(viewer.testbed.loss or 0.0), 5)})
                    self._send(200, "image/png" if png else "image/jpeg", body,
                               {"X-Info": info})
                    return
                routes = {
                    "/api/state": viewer.state_json,
                    "/api/save_snapshot": lambda: {"path": viewer.save_snapshot()},
                    "/api/level_stats": viewer.level_stats_json,
                    "/api/path": viewer.path_json,
                    "/api/path_add": lambda: viewer.path_add(get("theta", 0), get("phi", 0.3),
                                                             get("r", 2.0)),
                    "/api/path_remove": lambda: viewer.path_remove(int(q.get("i", [-1])[0])),
                    "/api/path_clear": viewer.path_clear,
                }
                if u.path == "/api/set":
                    try:
                        self._json(viewer.apply_settings(q))
                    except (ValueError, KeyError) as e:
                        self._json({"error": str(e)}, code=400)
                    return
                if u.path in routes:
                    self._json(routes[u.path]())
                    return
                self.send_response(404)
                self.end_headers()

            def _send(self, code, ctype, body, headers=None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code: int = 200):
                self._send(code, "application/json", json.dumps(obj).encode())

        return ThreadingHTTPServer((self.host, self.port), Handler)

    def serve_forever(self):
        if self.train:
            threading.Thread(target=self._train_loop, daemon=True).start()
        server = self.make_server()
        print(f"viewer listening on http://localhost:{server.server_address[1]}", flush=True)
        try:
            server.serve_forever()
        finally:
            self._stop = True
            server.server_close()


def main(argv=None):
    p = argparse.ArgumentParser(description="instant-ngp-torch web viewer")
    p.add_argument("--scene", default="", help="scene to load")
    p.add_argument("--snapshot", default="", help=".ingp snapshot to load")
    p.add_argument("--network", default="", help="network config json")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--train", action="store_true", help="keep training while viewing")
    args = p.parse_args(argv)
    if not args.scene and not args.snapshot:
        raise SystemExit("need --scene or --snapshot")

    from .testbed import Testbed

    tb = Testbed(device=args.device)
    if args.network:
        tb.reload_network_from_file(args.network)
    if args.scene:
        tb.load_training_data(args.scene)
    if args.snapshot:
        tb.load_snapshot(args.snapshot)
    ViewerServer(tb, port=args.port, train=args.train, host=args.host).serve_forever()


if __name__ == "__main__":
    main()
