"""Live watch mode (port of ``ofps_tpu.apps.watch``): a browser view of
the running pipeline, served over HTTP while it runs.

* ``/``           — single-page view: the overlay stream, a pose trace
                    canvas, a 3-D pose scene (orbit camera, per-estimator
                    frustum + keyframe quads + position trail) and the
                    detection status; the page loads nothing from elsewhere.
* ``/stream``     — ``multipart/x-mixed-replace`` MJPEG (or PNG parts where
                    OpenCV is not installed) of the HSV motion overlay.
* ``/state.json`` — latest frame index, per-estimator euler pose + history,
                    integrated pose quaternion/position + keyframe poses,
                    detection flag.

Run with ``python -m ofps_torch.apps.cli watch <config.json> [--port N]``
on any detection/tracking JSON config.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_PAGE = """<!DOCTYPE html>
<html><head><title>ofps-tpu watch</title><style>
body { font-family: sans-serif; background: #111; color: #ddd; margin: 1em; }
img { border: 1px solid #444; image-rendering: pixelated; max-width: 60vw; }
canvas { border: 1px solid #444; background: #181818; }
#status { margin: 0.5em 0; }
.det { color: #f55; font-weight: bold; }
</style></head><body>
<h3>ofps-tpu live view</h3>
<div id="status">waiting…</div>
<div style="display:flex; gap:1em; flex-wrap:wrap">
  <img src="/stream" alt="motion overlay">
  <canvas id="trace" width="480" height="360"></canvas>
  <canvas id="scene" width="480" height="360" title="drag to orbit, wheel to zoom"></canvas>
</div>
<script>
const colors = ["#6cf", "#fc6", "#6f6", "#f6f", "#ccc"];

// ---- 3-D pose scene: orbit camera + per-estimator frustum/keyframes ----
// (tracking/mod.rs:274-336 scene; camera_controller.rs orbit semantics)
const scn = document.getElementById("scene");
let orb = {yaw: 0.7, pitch: 0.3, dist: 4.0, drag: null};
let lastState = null;
scn.addEventListener("mousedown", e => { orb.drag = [e.clientX, e.clientY]; });
window.addEventListener("mouseup", () => { orb.drag = null; });
window.addEventListener("mousemove", e => {
  if (!orb.drag) return;
  orb.yaw   += (e.clientX - orb.drag[0]) * 0.01;
  orb.pitch += (e.clientY - orb.drag[1]) * 0.01;
  orb.pitch = Math.max(-1.5, Math.min(1.5, orb.pitch));
  orb.drag = [e.clientX, e.clientY];
  drawScene(lastState);
});
scn.addEventListener("wheel", e => {
  e.preventDefault();
  orb.dist = Math.max(0.5, Math.min(50, orb.dist * Math.exp(e.deltaY * 0.001)));
  drawScene(lastState);
}, {passive: false});

function qmat(q) {  // quat [w,x,y,z] -> row-major 3x3
  const w = q[0], x = q[1], y = q[2], z = q[3];
  return [1-2*(y*y+z*z), 2*(x*y-w*z), 2*(x*z+w*y),
          2*(x*y+w*z), 1-2*(x*x+z*z), 2*(y*z-w*x),
          2*(x*z-w*y), 2*(y*z+w*x), 1-2*(x*x+y*y)];
}
function mv(m, v) {
  return [m[0]*v[0]+m[1]*v[1]+m[2]*v[2],
          m[3]*v[0]+m[4]*v[1]+m[5]*v[2],
          m[6]*v[0]+m[7]*v[1]+m[8]*v[2]];
}
const dot = (a,b) => a[0]*b[0]+a[1]*b[1]+a[2]*b[2];
const cross = (a,b) => [a[1]*b[2]-a[2]*b[1], a[2]*b[0]-a[0]*b[2], a[0]*b[1]-a[1]*b[0]];
const norm3 = v => { const n = Math.hypot(v[0],v[1],v[2]) || 1; return [v[0]/n,v[1]/n,v[2]/n]; };
// World (image convention, y down) -> display (y up).
const disp = p => [p[0], -p[1], p[2]];

function drawScene(s) {
  const g = scn.getContext("2d");
  g.clearRect(0, 0, scn.width, scn.height);
  if (!s || !s.estimators.length) return;
  const cy = Math.cos(orb.yaw), sy = Math.sin(orb.yaw);
  const cp = Math.cos(orb.pitch), sp = Math.sin(orb.pitch);
  const eye = [orb.dist*cp*sy, orb.dist*sp, orb.dist*cp*cy];
  const fwd = norm3([-eye[0], -eye[1], -eye[2]]);
  const right = norm3(cross(fwd, [0, 1, 0]));
  const up = cross(right, fwd);
  function proj(p) {
    const d = [p[0]-eye[0], p[1]-eye[1], p[2]-eye[2]];
    const vz = dot(d, fwd);
    if (vz < 0.05) return null;
    const f = 0.9 * scn.height;
    return [scn.width/2 + f*dot(d, right)/vz, scn.height/2 - f*dot(d, up)/vz];
  }
  function seg(a, b, color, alpha) {
    const pa = proj(a), pb = proj(b);
    if (!pa || !pb) return;
    g.strokeStyle = color; g.globalAlpha = alpha;
    g.beginPath(); g.moveTo(pa[0], pa[1]); g.lineTo(pb[0], pb[1]); g.stroke();
  }
  for (let i = -3; i <= 3; i++) {  // ground grid (display y = -1)
    seg([i, -1, -3], [i, -1, 3], "#2a2a2a", 1.0);
    seg([-3, -1, i], [3, -1, i], "#2a2a2a", 1.0);
  }
  seg([0,0,0], [0.6,0,0], "#a33", 1.0);  // world axes
  seg([0,0,0], [0,0.6,0], "#3a3", 1.0);
  seg([0,0,0], [0,0,0.6], "#33a", 1.0);
  // Auto-scale positions so the largest excursion sits at ~1.5 units
  // (pure-rotation tracks keep everything at the origin).
  let pmax = 0;
  s.estimators.forEach(e => (e.path || []).forEach(p => {
    pmax = Math.max(pmax, Math.hypot(p[0], p[1], p[2]));
  }));
  const ps = pmax > 1e-6 ? 1.5 / pmax : 1.0;
  function frustum(q, t, color, alpha, sz) {
    const m = qmat(q);
    const apex = disp([t[0]*ps, t[1]*ps, t[2]*ps]);
    const cs = [[-sz, -sz*0.75, sz*1.6], [sz, -sz*0.75, sz*1.6],
                [sz, sz*0.75, sz*1.6], [-sz, sz*0.75, sz*1.6]].map(c => {
      const wp = mv(m, c);
      return [apex[0]+wp[0], apex[1]-wp[1], apex[2]+wp[2]];
    });
    for (let k = 0; k < 4; k++) {
      seg(apex, cs[k], color, alpha);
      seg(cs[k], cs[(k+1)%4], color, alpha);
    }
  }
  s.estimators.forEach((e, i) => {
    const col = colors[i % 5];
    (e.keyframes || []).forEach(kf =>
      frustum(kf.slice(0, 4), kf.slice(4), col, 0.25, 0.22));
    const path = e.path || [];
    for (let k = 1; k < path.length; k++)
      seg(disp([path[k-1][0]*ps, path[k-1][1]*ps, path[k-1][2]*ps]),
          disp([path[k][0]*ps, path[k][1]*ps, path[k][2]*ps]), col, 0.6);
    if (e.q) frustum(e.q, e.pos || [0,0,0], col, 1.0, 0.3);
  });
  g.globalAlpha = 1.0;
}
async function poll() {
  try {
    const s = await (await fetch("/state.json")).json();
    const el = document.getElementById("status");
    el.innerHTML = `frame ${s.frame}` +
      (s.detected === null ? "" :
        (s.detected ? ' — <span class="det">MOTION</span>' : " — still")) +
      (s.estimators.length ?
        " — " + s.estimators.map((e, i) =>
          `<span style="color:${colors[i%5]}">${e.name}` +
          ` r=${e.euler_deg[0].toFixed(2)}&deg;` +
          ` p=${e.euler_deg[1].toFixed(2)}&deg;` +
          ` y=${e.euler_deg[2].toFixed(2)}&deg;</span>`).join(" | ") : "");
    const c = document.getElementById("trace"), g = c.getContext("2d");
    g.clearRect(0, 0, c.width, c.height);
    g.strokeStyle = "#333";
    g.beginPath(); g.moveTo(0, c.height/2); g.lineTo(c.width, c.height/2);
    g.stroke();
    s.estimators.forEach((e, i) => {
      const hist = e.trace;  // [[r,p,y], ...] degrees
      [0, 1, 2].forEach(a => {
        g.strokeStyle = colors[i % 5];
        g.globalAlpha = 1.0 - 0.3 * a;
        g.beginPath();
        hist.forEach((v, t) => {
          const x = t * c.width / Math.max(hist.length - 1, 1);
          const y = c.height/2 - v[a] * c.height / (2 * s.trace_scale_deg);
          t ? g.lineTo(x, y) : g.moveTo(x, y);
        });
        g.stroke();
      });
    });
    g.globalAlpha = 1.0;
    lastState = s;
    drawScene(s);
  } catch (err) {}
  setTimeout(poll, 250);
}
poll();
</script></body></html>"""


class WatchState:
    """Shared latest-frame state between the pipeline loop and HTTP."""

    def __init__(
        self,
        trace_len: int = 300,
        trace_scale_deg: float = 60.0,
        kf_every: int = 12,
        kf_max: int = 32,
    ):
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.jpeg: Optional[bytes] = None
        self.jpeg_ctype = "image/jpeg"
        self.jpeg_seq = 0
        self.frame = -1
        self.detected: Optional[bool] = None
        self.ranges: List[tuple] = []
        self.names: List[str] = []
        self.euler: List[List[float]] = []
        self.trace: List[List[List[float]]] = []
        self.trace_len = trace_len
        self.trace_scale_deg = trace_scale_deg
        # 3-D pose scene state: integrated quaternion [w,x,y,z] + position
        # per estimator, a capped position trail, and keyframe poses
        # ([w,x,y,z,px,py,pz], one every kf_every frames) — the data behind
        # the suite's tracking scene (tracking/mod.rs:274-336).
        self.quat: List[List[float]] = []
        self.pos: List[List[float]] = []
        self.path: List[List[List[float]]] = []
        self.kf: List[List[List[float]]] = []
        self.kf_every = kf_every
        self.kf_max = kf_max
        self.done = False

    def push(
        self,
        frame_idx,
        overlay_rgba,
        detected,
        names,
        euler_deg,
        quats=None,
        positions=None,
    ):
        """Publish one processed frame (overlay may be None)."""
        blob = ctype = None
        if overlay_rgba is not None:
            blob, ctype = _encode_image(overlay_rgba)
        with self.cond:
            self.frame = frame_idx
            self.detected = detected
            self.names = list(names)
            if not self.trace:
                self.trace = [[] for _ in names]
                self.path = [[] for _ in names]
                self.kf = [[] for _ in names]
            self.euler = [list(map(float, e)) for e in euler_deg]
            for tr, e in zip(self.trace, self.euler):
                tr.append(e)
                del tr[: -self.trace_len]
            if quats is not None:
                self.quat = [list(map(float, q)) for q in quats]
                self.pos = [
                    list(map(float, p))
                    for p in (
                        positions
                        if positions is not None
                        else [[0.0, 0.0, 0.0]] * len(quats)
                    )
                ]
                for i, (q, p) in enumerate(zip(self.quat, self.pos)):
                    self.path[i].append(p)
                    del self.path[i][: -self.trace_len]
                    if frame_idx % self.kf_every == 0:
                        self.kf[i].append(q + p)
                        del self.kf[i][: -self.kf_max]
            if blob is not None:
                self.jpeg = blob
                self.jpeg_ctype = ctype
                self.jpeg_seq += 1
            self.cond.notify_all()

    def finish(self):
        with self.cond:
            self.done = True
            self.cond.notify_all()

    def snapshot(self) -> Dict[str, Any]:
        with self.lock:
            return {
                "frame": self.frame,
                "detected": self.detected,
                "done": self.done,
                "trace_scale_deg": self.trace_scale_deg,
                # Copy the traces while holding the lock: the handler
                # serializes AFTER release, racing push()'s append/trim on
                # the same inner lists otherwise.
                "estimators": [
                    {
                        "name": n,
                        "euler_deg": list(e),
                        "trace": [list(v) for v in t],
                        "q": list(self.quat[i]) if i < len(self.quat) else None,
                        "pos": list(self.pos[i]) if i < len(self.pos) else None,
                        "path": [list(p) for p in self.path[i]]
                        if i < len(self.path)
                        else [],
                        "keyframes": [list(k) for k in self.kf[i]]
                        if i < len(self.kf)
                        else [],
                    }
                    for i, (n, e, t) in enumerate(
                        zip(self.names, self.euler, self.trace)
                    )
                ],
            }


def _encode_image(rgba: np.ndarray):
    """RGBA float/uint8 -> (bytes, content_type): JPEG via OpenCV where it
    is installed, else PNG (the port's own writer)."""
    img = np.asarray(rgba)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    try:
        import cv2

        bgr = img[..., :3][..., ::-1]
        ok, buf = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 85])
        if ok:
            return buf.tobytes(), "image/jpeg"
    except ImportError:
        pass
    # Browsers accept image/png parts in an MJPEG stream, but each part
    # must declare its actual type.
    from ofps_torch.apps.viz import encode_png

    return encode_png(img), "image/png"


def make_server(state: WatchState, port: int = 8799) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/state.json":
                body = json.dumps(state.snapshot()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/stream":
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=ofpsframe",
                )
                self.end_headers()
                last = -1
                while True:
                    with state.cond:
                        state.cond.wait_for(
                            lambda: state.jpeg_seq != last or state.done,
                            timeout=5.0,
                        )
                        if state.jpeg_seq == last and state.done:
                            break
                        blob, last = state.jpeg, state.jpeg_seq
                        ctype = state.jpeg_ctype
                    if blob is None:
                        continue
                    try:
                        self.wfile.write(
                            f"--ofpsframe\r\nContent-Type: {ctype}\r\n"
                            f"Content-Length: {len(blob)}\r\n\r\n".encode()
                        )
                        self.wfile.write(blob)
                        self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        break
            else:
                self.send_error(404)

    srv = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    srv.daemon_threads = True
    return srv


def run_watch(
    config: Dict[str, Any],
    port: int = 8799,
    max_frames: Optional[int] = None,
    hold: bool = False,
    _server_box: Optional[list] = None,
    device="cuda",
) -> int:
    """Run a tracking/detection config with the live view served on
    ``port``; the pipeline steps on ``device`` (default the CUDA card;
    raises where there is none), one ``step_from_flow`` at B=1 per frame.

    ``hold=True`` keeps serving after the stream ends (Ctrl-C to quit).
    ``_server_box``: when given, the started server is appended so a caller
    (tests) can discover the bound port and shut it down.
    """
    from ofps_torch.apps import gt as gtmod
    from ofps_torch.apps.batch import FlowUploader
    from ofps_torch.apps.detection import _create_with_props
    from ofps_torch.apps.tracking import _estimator_with_props
    from ofps_torch.apps.viz import flow_to_rgba, overlay as blend_overlay
    from ofps_torch.core.camera import StandardCamera
    from ofps_torch.decoders.base import create_decoder
    from ofps_torch.detectors.base import create_detector
    from ofps_torch.device import resolve_device
    from ofps_torch.parallel.stream import StreamPipeline
    from ofps_torch.pipeline.runtime import DecoderFeed, RealtimeTimer

    dev = resolve_device(device)
    dec_cfg = config.get("decoder", {})
    est_cfgs = [e for e in config.get("estimators", []) if e.get("enabled", True)]
    det_cfg = config.get("detector")
    if det_cfg is None and config.get("app") == "detection":
        det_cfg = {"name": "block_motion"}
    insts = [_estimator_with_props(e["name"], e.get("properties") or {}) for e in est_cfgs]
    det = None
    if det_cfg:
        det = _create_with_props(create_detector, det_cfg.get("name", "block_motion"),
                                 det_cfg.get("properties") or {})
    camera = StandardCamera.create(
        float(config.get("camera_aspect", 16.0 / 9.0)),
        float(config.get("camera_fov_y", 90.0)),
    )
    pipe = StreamPipeline(camera=camera, estimators=insts, detector=det, device=dev)
    pstate = pipe.init_state(1, 1, 1)
    generator = torch.Generator(device=dev).manual_seed(0)
    capacity = int(config.get("capacity", 16384))
    uploader = FlowUploader(1, capacity, dev)

    decoder = create_decoder(dec_cfg["input"], dec_cfg.get("plugin"), device=dev,
                             **(dec_cfg.get("properties") or {}))

    state = WatchState()
    srv = make_server(state, port)
    if _server_box is not None:
        _server_box.append(srv)
    srv_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    srv_thread.start()
    print(f"watch: serving on http://localhost:{srv.server_address[1]}/")

    feed = DecoderFeed(decoder, want_frames=True)
    timer = RealtimeTimer(decoder.get_framerate() if config.get("realtime_processing") else None)
    frames = 0
    try:
        for frame in feed:
            uploader.pack([frame])
            pstate, out = pipe.step_from_flow(pstate, uploader.upload(), generator)
            # One copy: rotation and position per estimator, then the
            # detection flag.
            parts = [torch.cat([out.rot[t], out.pos[t]], -1)[0] for t in range(len(insts))]
            if det is not None:
                parts.append(out.detection.detected.to(torch.float32))
            host = torch.cat(parts).cpu().numpy() if parts else np.zeros(0, np.float32)

            img = None
            detected = None
            if det is not None:
                detected = bool(host[-1] > 0.5)
                rgba = flow_to_rgba(out.detection.field[0].cpu().numpy())
                img = (blend_overlay(frame.frame, rgba)
                       if getattr(frame, "frame", None) is not None else rgba)
            eulers, quats, positions = [], [], []
            for t in range(len(insts)):
                q = host[7 * t:7 * t + 4]  # integrated rotation
                eulers.append([float(np.degrees(v)) for v in gtmod._qeuler(q)])
                quats.append(q)
                positions.append(host[7 * t + 4:7 * t + 7])
            state.push(frames, img, detected, [i.name for i in insts], eulers,
                       quats=quats, positions=positions)
            frames += 1
            timer.tick()
            if max_frames is not None and frames >= max_frames:
                break
    finally:
        feed.stop()
        state.finish()
    print(f"watch: stream ended after {frames} frames")
    if hold:
        try:
            srv_thread.join()
        except KeyboardInterrupt:
            pass
    if _server_box is None:
        srv.shutdown()
        srv.server_close()
    return 0
