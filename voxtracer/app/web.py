"""Browser live viewer: continuous mouse-look + full slider panel.

The reference flies its camera through winit device events and exposes
every tuning parameter in an egui side panel
(``src/context.rs:1517-1560`` mouse/keyboard, ``:1692-1827`` sliders).
A terminal cannot deliver smooth per-pixel mouse deltas or key-up
events, so the interactive parity frontend is a tiny
stdlib HTTP server plus one self-contained HTML page:

  * pointer-lock mouse-look (0.001 rad/px, exactly the reference's
    rate) and WASD/QE key-state flying via :class:`FlyController`
  * an MJPEG ``multipart/x-mixed-replace`` stream of the rendered
    frames (JPEG via PIL when available, PNG otherwise)
  * every egui slider bound to an ``<input type=range>`` posting
    absolute values — same ranges and defaults as the reference panel
  * scene combobox, accumulation reset, snapshot save

Run: ``python -m voxtracer.app.web --scene menger --size 640x360``
then open http://localhost:8089/.
"""

from __future__ import annotations

import dataclasses
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..engine.pipeline import Renderer
from ..utils.timing import FpsCounter
from .cli import available_scenes, load_scene
from .input import FlyController

# egui slider ranges (src/context.rs:1692-1827); absolute-set analogs
# of the terminal viewer's key pairs.
PARAM_SPECS = {
    # name: (group, lo, hi)
    "sun_yaw": ("render", -np.pi, np.pi),
    "sun_pitch": ("render", 0.0, np.pi / 2),
    "sun_size": ("render", 0.0, 1.0),
    "sun_strength": ("render", 0.0, 10.0),
    "emit_strength": ("render", 0.0, 32.0),
    "specularity": ("render", 0.0, 1.0),
    "sample_blending": ("temporal", 0.0, 1.0),
    "maximum_blending": ("temporal", 0.0, 1.0),
    "blending_distance_cutoff": ("temporal", 1e-6, 1.0),
    "sigma_distance": ("denoise", 0.25, 8.0),
    "sigma_range": ("denoise", 0.25, 8.0),
    "albedo_factor": ("denoise", 0.0, 1.0),
    "denoise_radius": ("radius", 0, 8),
}


def _encode_jpeg(img: np.ndarray) -> tuple[bytes, str]:
    try:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=85)
        return buf.getvalue(), "image/jpeg"
    except Exception:
        from ..io.image import encode_png

        return encode_png(img), "image/png"


class WebViewer:
    """Owns the renderer + controller and runs the render loop thread.

    The HTTP layer only reads ``latest`` (frame bytes) and posts events
    through the thread-safe ``handle_event``.
    """

    def __init__(self, renderer: Renderer, scenes=None, scene_idx=0,
                 controller: FlyController | None = None,
                 watcher=None):
        self.renderer = renderer
        self.ctl = controller or FlyController()
        self.scenes = scenes or ["default"]
        self.scene_idx = scene_idx
        # kernel hot-reload DURING the live session — the whole point
        # of the reference's shader watcher (src/context.rs:1637-1657
        # runs in its frame loop); polled by the render-loop thread.
        # None skips polling (tests construct bare viewers).
        self.watcher = watcher
        self.lock = threading.Lock()
        self.frame_ready = threading.Condition(self.lock)
        self.latest: bytes = b""
        self.latest_mime = "image/jpeg"
        self.frame_no = 0
        self.fps = FpsCounter()
        self.running = False
        self._thread: threading.Thread | None = None
        # encoder thread decouples the host JPEG encode (2-5 ms at
        # 640x360) from the render loop: the loop hands off the RAW
        # frame (latest wins) and immediately dispatches the next
        # device frame, so encode overlaps device work instead of
        # serializing with it (VERDICT r3 next #3)
        self._enc_cond = threading.Condition()
        self._enc_frame: np.ndarray | None = None
        self._enc_thread: threading.Thread | None = None
        # live resize: HTTP threads request, the render-loop thread
        # applies (it owns the renderer between frames); the old frame
        # keeps streaming until the first new-size frame lands —
        # capability parity with src/context.rs:1430-1461
        self._pending_size: tuple[int, int] | None = None
        # per-stage wall accumulators (seconds / counts) for the
        # interactive-gap attribution (VERDICT r5 #5).  The loop
        # thread owns the first five; the encoder thread owns
        # enc_s/enc_n (GIL-atomic float adds; read via stage_stats).
        self._stats = dict(
            watch_s=0.0, ctl_s=0.0, dispatch_s=0.0, fetch_s=0.0,
            loop_n=0, enc_s=0.0, enc_n=0,
        )

    def reset_stage_stats(self):
        for k in self._stats:
            self._stats[k] = 0 if k in ("loop_n", "enc_n") else 0.0

    def stage_stats(self) -> dict:
        """Per-published-frame stage means in ms (plus raw counts).

        ``dispatch_ms`` is the renderer.render call (jit dispatch —
        asynchronous unless it has to wait for a donated buffer or a
        compile), ``fetch_ms`` the blocking host fetch of the
        PREVIOUS frame's image (the lookahead overlap target),
        ``encode_ms`` the JPEG encode + publish on the encoder
        thread, ``dropped`` how many rendered frames latest-wins
        replaced before encoding."""
        s = self._stats
        n = max(s["loop_n"], 1)
        return dict(
            loop_frames=s["loop_n"],
            encoded_frames=s["enc_n"],
            dropped=max(s["loop_n"] - s["enc_n"], 0),
            watcher_ms=round(s["watch_s"] / n * 1e3, 2),
            ctl_ms=round(s["ctl_s"] / n * 1e3, 2),
            dispatch_ms=round(s["dispatch_s"] / n * 1e3, 2),
            fetch_ms=round(s["fetch_s"] / n * 1e3, 2),
            encode_ms=round(s["enc_s"] / max(s["enc_n"], 1) * 1e3, 2),
        )

    # -- events (called from HTTP threads) ----------------------------
    def handle_event(self, ev: dict):
        kind = ev.get("type")
        with self.lock:
            if kind == "keydown":
                self.ctl.key_down(str(ev.get("key", "")))
            elif kind == "keyup":
                self.ctl.key_up(str(ev.get("key", "")))
            elif kind == "look":
                self.ctl.mouse_delta(
                    float(ev.get("dx", 0.0)), float(ev.get("dy", 0.0))
                )
            elif kind == "grab":
                self.ctl.cursor_grabbed = bool(ev.get("grabbed", False))
            elif kind == "param":
                self._set_param(str(ev.get("name")), ev.get("value"))
            elif kind == "color":
                self._set_color(str(ev.get("name")), ev.get("value"))
            elif kind == "scene":
                self._set_scene(str(ev.get("name")))
            elif kind == "size":
                w = int(ev.get("width", 0))
                h = int(ev.get("height", 0))
                if 16 <= w <= 3840 and 16 <= h <= 2160:
                    self._pending_size = (h, w)
            elif kind == "reset":
                self.renderer.reset_accumulation()
            elif kind == "snapshot":
                from ..engine import snapshot

                snapshot.save(
                    ev.get("path", "viewer_snapshot.npz"),
                    self.renderer, self.ctl.camera,
                )

    def _set_param(self, name: str, value):
        if name not in PARAM_SPECS:
            return
        group, lo, hi = PARAM_SPECS[name]
        r = self.renderer
        if group == "radius":
            r.denoise_radius = int(np.clip(int(value), lo, hi))
            return
        v = float(np.clip(float(value), lo, hi))
        if group == "render":
            r.render_params = dataclasses.replace(
                r.render_params, **{name: v}
            )
        elif group == "temporal":
            r.temporal_params = dataclasses.replace(
                r.temporal_params, **{name: v}
            )
        elif group == "denoise":
            r.denoise_params = dataclasses.replace(
                r.denoise_params, **{name: v}
            )

    def _set_color(self, name: str, value):
        if name not in ("sun_color", "sky_color"):
            return
        rgb = tuple(float(np.clip(float(c), 0.0, 1.0)) for c in value)[:3]
        r = self.renderer
        r.render_params = dataclasses.replace(
            r.render_params, **{name: rgb}
        )

    def _set_scene(self, name: str):
        try:
            scene = load_scene(name)
        except (Exception, SystemExit):
            return  # keep the old scene (src/context.rs:1817-1818)
        self.renderer.set_scene(scene)
        if name in self.scenes:
            self.scene_idx = self.scenes.index(name)

    def state_json(self) -> dict:
        r = self.renderer
        vals = {}
        for name, (group, _, _) in PARAM_SPECS.items():
            if group == "render":
                vals[name] = getattr(r.render_params, name)
            elif group == "temporal":
                vals[name] = getattr(r.temporal_params, name)
            elif group == "denoise":
                vals[name] = getattr(r.denoise_params, name)
            else:
                vals[name] = r.denoise_radius
        vals["sun_color"] = list(r.render_params.sun_color)
        vals["sky_color"] = list(r.render_params.sky_color)
        fps = self.fps.fps
        return {
            "params": vals,
            "scenes": self.scenes,
            "scene": self.scenes[self.scene_idx],
            "fps": round(fps, 1),
            "mrays_per_s": round(r.height * r.width * fps / 1e6, 1),
            "frame": self.frame_no,
            "size": [r.width, r.height],
        }

    # -- render loop --------------------------------------------------
    def start(self):
        self.running = True
        self._enc_thread = threading.Thread(
            target=self._encode_loop, daemon=True
        )
        self._enc_thread.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self.running = False
        if self._thread is not None:
            self._thread.join(timeout=10)
        with self._enc_cond:
            self._enc_cond.notify_all()
        if self._enc_thread is not None:
            self._enc_thread.join(timeout=10)

    def _apply_pending_size(self):
        """Apply a requested live resize (render-loop/owner thread
        only — must not race an in-flight render)."""
        with self.lock:
            size, self._pending_size = self._pending_size, None
        if size is not None:
            self.renderer.resize(*size)

    def poll_watcher(self):
        """Non-fatal kernel hot-reload poll (reference keeps the old
        pipeline on a failed shader compile, src/context.rs:1644-1646;
        KernelWatcher.poll already catches reload errors — this guard
        covers watcher-internal failures like a deleted source file)."""
        if self.watcher is None:
            return
        try:
            self.watcher.poll()
        except Exception:  # pragma: no cover - keep rendering
            pass

    def render_once(self, dt: float = 1 / 30.0):
        """One frame: advance controller, render, encode, publish
        (synchronous — the single-step path tests drive)."""
        self.poll_watcher()
        self._apply_pending_size()
        with self.lock:
            cam = self.ctl.update(dt)
        out = self.renderer.render(cam)
        self._publish(np.asarray(out["image"]))

    def _publish(self, img: np.ndarray):
        data, mime = _encode_jpeg(img)
        with self.frame_ready:
            self.latest, self.latest_mime = data, mime
            self.frame_no += 1
            self.fps.tick()
            self.frame_ready.notify_all()

    def _submit_raw(self, img: np.ndarray):
        """Hand a raw frame to the encoder thread (latest wins — if
        the encoder is behind, the stale frame is dropped, never
        queued: an interactive stream wants freshness, not history)."""
        with self._enc_cond:
            self._enc_frame = img
            self._enc_cond.notify()

    def _encode_loop(self):
        while True:
            with self._enc_cond:
                while self._enc_frame is None and self.running:
                    self._enc_cond.wait(0.25)
                img, self._enc_frame = self._enc_frame, None
            if img is None:
                if not self.running:
                    return
                continue
            try:
                t0 = time.perf_counter()
                self._publish(img)
                self._stats["enc_s"] += time.perf_counter() - t0
                self._stats["enc_n"] += 1
            except Exception:  # pragma: no cover - keep encoding
                pass

    def _loop(self):
        # One frame of lookahead: dispatch frame N+1 BEFORE fetching
        # frame N's image, so the (blocking) host fetch overlaps the
        # device's work on the next frame instead of serializing the
        # pipeline.  Costs one frame of display latency.
        last = time.perf_counter()
        pending = None
        stats = self._stats
        while self.running:
            now = time.perf_counter()
            dt, last = now - last, now
            try:
                self.poll_watcher()
                t1 = time.perf_counter()
                if self._pending_size is not None:
                    # flush the in-flight lookahead frame at the OLD
                    # size first, then rebuild at the new one
                    if pending is not None:
                        self._submit_raw(np.asarray(pending))
                        pending = None
                    self._apply_pending_size()
                with self.lock:
                    cam = self.ctl.update(min(dt, 0.25))
                t2 = time.perf_counter()
                out = self.renderer.render(cam)
                out["image"].copy_to_host_async()
                t3 = time.perf_counter()
                if pending is not None:
                    self._submit_raw(np.asarray(pending))
                pending = out["image"]
                t4 = time.perf_counter()
                stats["watch_s"] += t1 - now
                stats["ctl_s"] += t2 - t1
                stats["dispatch_s"] += t3 - t2
                stats["fetch_s"] += t4 - t3
                stats["loop_n"] += 1
            except Exception:  # pragma: no cover - keep serving
                import traceback

                traceback.print_exc()
                pending = None
                time.sleep(0.5)
        if pending is not None:  # flush the lookahead frame
            try:
                self._publish(np.asarray(pending))
            except Exception:  # pragma: no cover
                pass

    def wait_frame(self, after: int, timeout: float = 5.0):
        """Block until a frame newer than ``after`` exists."""
        deadline = time.time() + timeout
        with self.frame_ready:
            while self.frame_no <= after:
                left = deadline - time.time()
                if left <= 0 or not self.frame_ready.wait(left):
                    break
            return self.latest, self.latest_mime, self.frame_no


PAGE = """<!DOCTYPE html>
<html><head><title>voxtracer</title><style>
body{margin:0;background:#111;color:#ddd;font:13px sans-serif;display:flex}
#view{flex:1;display:flex;align-items:center;justify-content:center}
#view img{max-width:100%;max-height:100vh;cursor:crosshair}
#panel{width:270px;padding:10px;background:#1b1b1b;overflow-y:auto;height:100vh;box-sizing:border-box}
#panel label{display:block;margin-top:8px;font-size:11px;color:#aaa}
#panel input[type=range]{width:100%}
#panel select,#panel button{width:100%;margin-top:6px}
#stats{font-size:12px;color:#8c8;margin-bottom:6px;white-space:pre}
</style></head><body>
<div id=view><img id=frame src=/stream></div>
<div id=panel>
<div id=stats>connecting…</div>
<select id=scene></select>
<label>resolution <select id=size>
<option>320x180</option><option>640x360</option><option>960x540</option>
<option>1280x720</option><option>1920x1080</option>
</select></label>
<button id=reset>reset accumulation (R)</button>
<button id=snap>save snapshot (P)</button>
<div id=sliders></div>
<label>sun color <input type=color id=sun_color></label>
<label>sky color <input type=color id=sky_color></label>
<p style="font-size:11px;color:#777">click the image to grab the
cursor (pointer lock): WASD/QE fly, mouse looks, Shift fast, Ctrl
slow, Esc releases.</p>
</div>
<script>
const SLIDERS = {
 sun_yaw:[-3.14159,3.14159,0.01], sun_pitch:[0,1.5708,0.01],
 sun_size:[0,1,0.005], sun_strength:[0,10,0.1],
 emit_strength:[0,32,0.25], specularity:[0,1,0.01],
 sample_blending:[0,1,0.01], maximum_blending:[0,1,0.005],
 blending_distance_cutoff:[0.000001,1,0.0001],
 sigma_distance:[0.25,8,0.05], sigma_range:[0.25,8,0.05],
 albedo_factor:[0,1,0.05], denoise_radius:[0,8,1]};
const post = (o) => fetch('/input', {method:'POST', body:JSON.stringify(o)});
const sdiv = document.getElementById('sliders');
for (const [name,[lo,hi,step]] of Object.entries(SLIDERS)) {
  const l = document.createElement('label');
  l.textContent = name;
  const s = document.createElement('input');
  s.type='range'; s.min=lo; s.max=hi; s.step=step; s.id=name;
  s.oninput = () => post({type:'param', name, value:+s.value});
  l.appendChild(s); sdiv.appendChild(l);
}
const hex = (rgb) => '#'+rgb.map(c=>Math.round(c*255).toString(16).padStart(2,'0')).join('');
const unhex = (h) => [1,3,5].map(i=>parseInt(h.slice(i,i+2),16)/255);
for (const id of ['sun_color','sky_color']) {
  document.getElementById(id).oninput = (e) =>
    post({type:'color', name:id, value:unhex(e.target.value)});
}
const scenesEl = document.getElementById('scene');
scenesEl.onchange = () => post({type:'scene', name:scenesEl.value});
const sizeEl = document.getElementById('size');
sizeEl.onchange = () => {
  const [w,h] = sizeEl.value.split('x').map(Number);
  post({type:'size', width:w, height:h});
};
document.getElementById('reset').onclick = () => post({type:'reset'});
document.getElementById('snap').onclick = () => post({type:'snapshot'});
async function refresh(init) {
  const st = await (await fetch('/state')).json();
  document.getElementById('stats').textContent =
    `${st.scene} ${st.size[0]}x${st.size[1]}  fps ${st.fps}  ` +
    `${st.mrays_per_s} Mray/s`;
  if (init) {
    for (const name of Object.keys(SLIDERS))
      document.getElementById(name).value = st.params[name];
    scenesEl.innerHTML = st.scenes.map(s=>`<option>${s}</option>`).join('');
    scenesEl.value = st.scene;
    const cur = `${st.size[0]}x${st.size[1]}`;
    if (![...sizeEl.options].some(o=>o.value===cur))
      sizeEl.add(new Option(cur, cur));
    sizeEl.value = cur;
    document.getElementById('sun_color').value = hex(st.params.sun_color);
    document.getElementById('sky_color').value = hex(st.params.sky_color);
  }
}
refresh(true); setInterval(()=>refresh(false), 1000);
const img = document.getElementById('frame');
img.onclick = () => img.requestPointerLock();
document.addEventListener('pointerlockchange', () =>
  post({type:'grab', grabbed: document.pointerLockElement === img}));
document.addEventListener('mousemove', (e) => {
  if (document.pointerLockElement === img && (e.movementX||e.movementY))
    post({type:'look', dx:e.movementX, dy:e.movementY});
});
const KEYS = {KeyW:'w',KeyA:'a',KeyS:'s',KeyD:'d',KeyQ:'q',KeyE:'e',
  ShiftLeft:'shift',ControlLeft:'control',KeyR:'r',KeyP:'p'};
document.addEventListener('keydown', (e) => {
  const k = KEYS[e.code]; if (!k) return;
  if (k==='r') return post({type:'reset'});
  if (k==='p') return post({type:'snapshot'});
  post({type:'keydown', key:k});
});
document.addEventListener('keyup', (e) => {
  const k = KEYS[e.code]; if (k) post({type:'keyup', key:k});
});
</script></body></html>
"""


def make_handler(viewer: WebViewer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, mime="text/html"):
            self.send_response(code)
            self.send_header("Content-Type", mime)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                self._send(200, PAGE.encode())
            elif self.path == "/state":
                self._send(
                    200,
                    json.dumps(viewer.state_json()).encode(),
                    "application/json",
                )
            elif self.path.startswith("/frame"):
                data, mime, _ = viewer.wait_frame(0)
                if not data:
                    self._send(503, b"no frame yet", "text/plain")
                else:
                    self._send(200, data, mime)
            elif self.path.startswith("/stream"):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=vtframe",
                )
                self.end_headers()
                seen = 0
                try:
                    while viewer.running or viewer.frame_no > seen:
                        data, mime, seen = viewer.wait_frame(seen)
                        if not data:
                            continue
                        self.wfile.write(
                            b"--vtframe\r\nContent-Type: "
                            + mime.encode()
                            + b"\r\nContent-Length: "
                            + str(len(data)).encode()
                            + b"\r\n\r\n"
                            + data
                            + b"\r\n"
                        )
                        if not viewer.running:
                            break
                except (BrokenPipeError, ConnectionResetError):
                    pass
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/input":
                return self._send(404, b"not found", "text/plain")
            n = int(self.headers.get("Content-Length", 0))
            try:
                ev = json.loads(self.rfile.read(n) or b"{}")
                viewer.handle_event(ev)
                self._send(200, b"{}", "application/json")
            except Exception as e:
                self._send(400, str(e).encode(), "text/plain")

    return Handler


def serve(viewer: WebViewer, host="127.0.0.1", port=8089):
    server = ThreadingHTTPServer((host, port), make_handler(viewer))
    server.daemon_threads = True
    return server


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="default")
    p.add_argument("--size", default="640x360")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8089)
    p.add_argument("--denoise-radius", type=int, default=2)
    args = p.parse_args(argv)
    w, h = (int(v) for v in args.size.split("x"))
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    scenes = available_scenes()
    renderer = Renderer(
        scene=load_scene(args.scene), height=h, width=w,
        denoise_radius=args.denoise_radius, lean=True,
    )
    from ..engine.reload import KernelWatcher

    viewer = WebViewer(
        renderer,
        scenes=scenes,
        scene_idx=scenes.index(args.scene) if args.scene in scenes else 0,
        watcher=KernelWatcher(),
    )
    viewer.start()
    server = serve(viewer, args.host, args.port)
    print(f"voxtracer web viewer on http://{args.host}:{args.port}/")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        viewer.stop()
        server.shutdown()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
