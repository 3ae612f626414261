"""Live progressive viewer: a local HTTP page over the accumulating film.

The reference opens a winit/OpenGL window that repaints as render
threads merge passes, with runtime keys — 1..5 display modes, E export,
backtick QUICK_PASS (abort the render and show the albedo preview)
(reference: src/main.rs:297-532; keys 418-441; QUICK_PASS 224-231).
An accelerator host is headless, so the same interaction ships as a tiny
stdlib-http server: the browser polls the tonemapped frame and posts
keystrokes back; the render loop polls the shared control state between
passes, aborting and restarting exactly like the reference's
RENDER_ABORT atomic when the mode requires it.

Run: `python -m mrt --scene cornell --serve --port 7860`; open
http://localhost:7860 — keys in the page: 1..5 modes, E export PNG,
backtick quick-pass toggle.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .film import Film, DisplayMode

_MODES = {
    "1": DisplayMode.DEFAULT,
    "2": DisplayMode.DENOISE,
    "3": DisplayMode.DEPTH,
    "4": DisplayMode.ALBEDO,
    "5": DisplayMode.NORMAL,
}

_PAGE = """<!doctype html>
<html><head><title>mrt live</title><style>
body { background:#111; color:#ddd; font-family:monospace; margin:1em }
img { image-rendering:pixelated; width:min(96vw, 1280px); }
#bar { margin:.5em 0 }
</style></head><body>
<div id="bar">mrt &mdash; keys: 1..5 display modes &middot; E export
&middot; ` quick-pass &middot; WASD+space play (--play scenes)
&middot; <span id="st"></span></div>
<img id="frame" src="/frame.png">
<script>
const img = document.getElementById('frame');
const st = document.getElementById('st');
async function tick() {
  try {
    const r = await fetch('/frame.png?' + Date.now());
    img.src = URL.createObjectURL(await r.blob());
    const s = await (await fetch('/status')).json();
    st.textContent = s.mode + ' | ' + s.samples + ' spp' +
        (s.frame !== undefined ? ' | frame ' + s.frame : '') +
        (s.quick_pass ? ' | QUICK PASS' : '') +
        (s.done ? ' | done' : '');
  } catch (e) {}
  setTimeout(tick, 250);
}
tick();
// Held game keys stream to /input as a comma list (the gilrs
// poll-every-frame role, main.rs:333-360); everything else stays a
// one-shot /key control event.
const held = new Set();
const game = new Set(['w','a','s','d',' ','shift',
                      'arrowleft','arrowright','arrowup','arrowdown']);
function sendHeld() {
  fetch('/input?held=' + encodeURIComponent([...held].join(',')));
}
document.addEventListener('keydown', (e) => {
  const k = e.key.toLowerCase();
  if (game.has(k)) {
    if (!held.has(k)) { held.add(k); sendHeld(); }
    e.preventDefault();
  } else {
    fetch('/key?k=' + encodeURIComponent(e.key));
  }
});
document.addEventListener('keyup', (e) => {
  const k = e.key.toLowerCase();
  if (held.delete(k)) sendHeld();
});
window.addEventListener('blur', () => { held.clear(); sendHeld(); });
setInterval(sendHeld, 400);   // heartbeat vs missed keyups
</script></body></html>
"""


class ViewerState:
    """Shared control/state between the HTTP thread and the render loop
    (the reference's RENDER_ABORT / DISPLAY_MODE atomics +
    Arc<Mutex<Image>>, main.rs:53-60)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.mode = DisplayMode.DEFAULT
        self.quick_pass = False
        self.export_requested = False
        self.epoch = 0          # bumped on any abort-worthy change
        self.film = None
        self.samples = 0
        self.done = False
        self.png = b""
        self.held = frozenset()  # live game keys (w/a/s/d/space/...)
        self.frame = None        # interactive-mode frame counter

    def set_held(self, keys):
        with self.lock:
            self.held = frozenset(k for k in keys if k)

    def input_collection(self):
        """Map held keys to the per-frame InputCollection the scene's
        generate() consumes (the reference feeds gamepad state the same
        way each frame, main.rs:333-360,500-532)."""
        from .input import InputCollection

        with self.lock:
            h = self.held
        return InputCollection(
            stick_x=(1.0 if "d" in h else 0.0)
                    - (1.0 if "a" in h else 0.0),
            stick_y=(1.0 if "w" in h else 0.0)
                    - (1.0 if "s" in h else 0.0),
            cam_x=(1.0 if "arrowright" in h else 0.0)
                  - (1.0 if "arrowleft" in h else 0.0),
            cam_z=(1.0 if "arrowup" in h else 0.0)
                  - (1.0 if "arrowdown" in h else 0.0),
            button_a=" " in h,
            button_b="shift" in h,
        )

    def key(self, k):
        with self.lock:
            if k in _MODES:
                self.mode = _MODES[k]
            elif k.lower() == "e":
                self.export_requested = True
            elif k == "`":
                self.quick_pass = not self.quick_pass
                self.epoch += 1     # abort + restart (main.rs:224-231)

    def publish(self, film, png, samples, done=False):
        with self.lock:
            self.film = film
            self.png = png
            self.samples = samples
            self.done = done

    def snapshot(self):
        with self.lock:
            return (self.mode, self.quick_pass, self.epoch,
                    self.export_requested)

    def clear_export(self):
        with self.lock:
            self.export_requested = False


def _handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):       # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/frame.png"):
                with state.lock:
                    png = state.png
                if not png:
                    self._send(503, "text/plain", b"no frame yet")
                else:
                    self._send(200, "image/png", png)
            elif self.path.startswith("/key"):
                from urllib.parse import urlparse, parse_qs
                q = parse_qs(urlparse(self.path).query)
                state.key(q.get("k", [""])[0])
                self._send(200, "text/plain", b"ok")
            elif self.path.startswith("/input"):
                from urllib.parse import urlparse, parse_qs
                q = parse_qs(urlparse(self.path).query)
                held = q.get("held", [""])[0]
                state.set_held(held.split(",") if held else [])
                self._send(200, "text/plain", b"ok")
            elif self.path.startswith("/status"):
                with state.lock:
                    d = dict(
                        mode=state.mode.value, samples=int(state.samples),
                        quick_pass=state.quick_pass,
                        done=state.done)
                    if state.frame is not None:
                        d["frame"] = int(state.frame)
                self._send(200, "application/json", json.dumps(d).encode())
            else:
                self._send(200, "text/html", _PAGE.encode())
    return Handler


def png_bytes(rgb_bottom_up):
    """Encode (H,W,3) uint8 bottom-up rows to PNG bytes (same flip as
    io.save_png, main.rs:760-783)."""
    from .io import encode_png

    return encode_png(np.asarray(rgb_bottom_up)[::-1])


class _Abort(Exception):
    pass


def serve(config, log=print, stop=None):
    """Progressive render with the live viewer attached (the reference's
    render()+run() pair, main.rs:150-532).

    stop: optional threading.Event — when set, the loop winds down and
    returns (so an embedding process, e.g. the test harness, can shut
    the render thread down instead of killing it mid-XLA-call)."""
    if stop is None:
        stop = threading.Event()
    from .. import scenes
    from .driver import _denoiser_for, export
    from .input import InputCollection
    from .render import render, aov_pass

    state = ViewerState()
    httpd = ThreadingHTTPServer((config.host, config.port),
                                _handler(state))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    log(f"viewer at http://{config.host}:{config.port}")

    sc = scenes.get(config.scene)(aspect_ratio=config.aspect_ratio)
    denoiser = _denoiser_for(config)
    albedo = normal = None

    def tonemap(film):
        mode, _, _, _ = state.snapshot()
        try:
            return film.to_rgb_bytes(mode, denoiser=denoiser)
        except ValueError:   # mode needs AOV not yet attached
            return film.to_rgb_bytes(DisplayMode.DEFAULT)

    if getattr(config, "play", False):
        # Play mode generates per frame itself — generating here too
        # would tick stateful scenes (physics) one extra time and break
        # record/replay bit-identity.
        return _play_loop(config, state, sc, stop, log, tonemap, httpd)

    scene, camera = sc.generate(0.0, 0, InputCollection())
    if config.nee:
        from ..geometry.scene import attach_lights
        scene = attach_lights(scene)

    try:
        while not stop.is_set():
            mode, quick, epoch, _ = state.snapshot()
            if quick:
                # QUICK_PASS: albedo preview only (main.rs:224-231).
                if albedo is None:
                    albedo, normal = aov_pass(
                        scene, camera, width=config.width,
                        height=config.height, seed=config.seed)
                film = Film.create(config.width, config.height)
                film = film.with_aov(albedo, normal)
                state.publish(film,
                              png_bytes(film.to_rgb_bytes(
                                  DisplayMode.ALBEDO)), 0, done=True)
                while state.snapshot()[2] == epoch and not stop.is_set():
                    self_export(state, film, config)
                    time.sleep(0.2)
                continue

            needs_aov = (config.denoise or denoiser is not None
                         or mode in (DisplayMode.DENOISE,
                                     DisplayMode.ALBEDO,
                                     DisplayMode.NORMAL))

            def progress(f):
                state.publish(f, png_bytes(tonemap(f)), int(f.samples))
                self_export(state, f, config)
                if state.snapshot()[2] != epoch or stop.is_set():
                    raise _Abort()

            try:
                film = render(scene, camera, config.width, config.height,
                              spp=config.spp, seed=config.seed,
                              max_depth=config.max_depth,
                              samples_per_pass=config.samples_per_pass,
                              with_aov=needs_aov, progress=progress,
                              persistent=config.persistent,
                              rr_depth=config.rr_depth)
            except _Abort:
                continue
            state.publish(film, png_bytes(tonemap(film)),
                          int(film.samples), done=True)
            log(f"render complete at {int(film.samples)} spp; viewer "
                "stays live (Ctrl-C to quit)")
            while state.snapshot()[2] == epoch and not stop.is_set():
                f = state.film
                state.publish(f, png_bytes(tonemap(f)),
                              int(f.samples), done=True)
                self_export(state, f, config)
                time.sleep(0.4)
    except KeyboardInterrupt:
        log("viewer stopped")
    finally:
        httpd.shutdown()


def _play_loop(config, state, sc, stop, log, tonemap, httpd):
    """Interactive game loop: poll the browser's held keys into a
    per-frame InputCollection, regenerate the (dynamic) scene, render
    one short frame, repeat — the reference's playable Mario loop
    (main.rs:104-117 per-frame generate, 333-360 gamepad poll,
    scenes/mario.rs:121-276).  With --write-input the played session is
    recorded; replaying it through the --animate driver regenerates the
    identical frame sequence (mario.rs:318-343)."""
    import dataclasses

    from .driver import render_frame
    from .input import InputRecorder

    recorder = InputRecorder() if config.write_input else None
    fcfg = dataclasses.replace(config, spp=config.samples_per_frame)
    total = max(config.total_frames, 1)
    frame = 0
    film = None
    log(f"play mode: WASD + space in the browser drive the scene "
        f"({config.samples_per_frame} spp/frame)")
    try:
        while not stop.is_set():
            inp = state.input_collection()
            if recorder is not None:
                recorder.record(inp)
            scene, camera = sc.generate(frame / total, frame, inp)
            if config.nee:
                from ..geometry.scene import attach_lights
                scene = attach_lights(scene)
            film = render_frame(scene, camera, fcfg)
            film.sum.block_until_ready()
            with state.lock:
                state.frame = frame
            state.publish(film, png_bytes(tonemap(film)),
                          int(film.samples))
            self_export(state, film, config)
            frame += 1
    except KeyboardInterrupt:
        log("play loop stopped")
    finally:
        if recorder is not None and recorder.frames:
            recorder.save(config.write_input)
            log(f"recorded {len(recorder.frames)} frames -> "
                f"{config.write_input}")
        if film is not None:
            from .driver import export
            export(film, config.output, config)  # last played frame
        httpd.shutdown()


def self_export(state, film, config):
    _, _, _, want_export = state.snapshot()
    if want_export and film is not None:
        from .driver import export

        export(film, config.output, config)
        state.clear_export()
