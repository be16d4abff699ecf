"""Browser viewer over the session of `gui_api.py`: a standard-library
HTTP server that serves rendered frames to a canvas and maps the
interactions:
  drag            orbit
  wheel           zoom
  shift+drag      pan
  right-click     3-D point prompt (pick_point)
  T               live training ticks on / off (with a training scene)
  S               save the picked prompts in the --point_file schema
plus sliders for fovy, background, SPP and a crop box, and keyframe
recording for `--trajectory_root` replays.

Frames are PNG (`data/png.py`), so no image library is needed.  Run with
`python -m sanerf_hq_tpu_torch <scene> --gui [...]` or serve() directly.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..data.png import encode_png

_PAGE = """<!doctype html>
<html><head><title>sanerf-hq-tpu viewer</title><style>
 body{margin:0;background:#111;color:#ddd;font-family:monospace}
 #bar{padding:6px 10px;background:#1b1b1b}
 #cv{display:block;margin:0 auto;cursor:crosshair}
 .on{color:#6f6}.off{color:#f66}
</style></head><body>
<div id="bar">
 <span id="stat">connecting...</span> |
 drag=orbit wheel=zoom shift+drag=pan right-click=point
 <b>[T]</b>rain <b>[S]</b>ave points <b>[N]</b>eg-label:
 <span id="neg" class="off">off</span>
</div>
<div id="bar">
 fovy <input id="fovy" type="range" min="20" max="120" value="60"
   oninput="post('/fovy',{value:+this.value})">
 bg <input id="bg" type="range" min="0" max="1" step="0.05" value="1"
   oninput="post('/bg',{value:+this.value})">
 spp <input id="spp" type="number" min="1" max="64" value="1" style="width:3em"
   onchange="post('/spp',{value:+this.value})">
 crop <input id="crop" type="range" min="0.05" max="1" step="0.05" value="1"
   oninput="setCrop(+this.value)">
 <button onclick="post('/record_pose',{}).then(r=>r.json()).then(
   j=>kf.textContent=j.n_keyframes)">rec pose</button>
 <button onclick="post('/save_trajectory',{})">save traj</button>
 <button onclick="post('/clear_trajectory',{});kf.textContent=0">clear</button>
 <span id="kf">0</span> keyframes
</div>
<canvas id="cv" width="{W}" height="{H}"></canvas>
<script>
const cv=document.getElementById('cv'),ctx=cv.getContext('2d');
// --gui_mouse_right_drag (nerf/gui.py:444-452): right-drag pans (moves the
// camera center) and right-click point-select is disabled
const RIGHT_DRAG_PAN={RDP};
let busy=false,drag=false,rdrag=false,lx=0,ly=0,neg=false,training=false;
async function post(p,b){return fetch(p,{method:'POST',
  headers:{'Content-Type':'application/json'},body:JSON.stringify(b||{})});}
async function frame(){
 if(busy)return; busy=true;
 try{
  const r=await fetch('/frame?ds='+(drag?4:2));
  const fps=r.headers.get('X-FPS'),step=r.headers.get('X-Step'),
        loss=r.headers.get('X-Loss');
  const blob=await r.blob(),img=await createImageBitmap(blob);
  ctx.imageSmoothingEnabled=false;
  ctx.drawImage(img,0,0,cv.width,cv.height);
  const pts=JSON.parse(r.headers.get('X-Points')||'[]');
  for(const p of pts){ctx.fillStyle=p[2]? '#2f2':'#f22';
    ctx.beginPath();ctx.arc(p[0]*cv.width,p[1]*cv.height,5,0,7);ctx.fill();}
  document.getElementById('stat').textContent=
    `render ${fps} fps | train ${training?'ON step '+step+' loss '+loss:'off'}`;
 }finally{busy=false;}
}
setInterval(frame,120);
cv.onmousedown=e=>{
 if(e.button===0){drag=true;lx=e.clientX;ly=e.clientY;}
 else if(e.button===2&&RIGHT_DRAG_PAN){rdrag=true;lx=e.clientX;ly=e.clientY;}};
window.onmouseup=()=>{drag=false;rdrag=false;};
window.onmousemove=e=>{if(!drag&&!rdrag)return;
 const dx=e.clientX-lx,dy=e.clientY-ly;lx=e.clientX;ly=e.clientY;
 post((rdrag||e.shiftKey)?'/pan':'/orbit',{dx:dx,dy:dy});};
cv.onwheel=e=>{e.preventDefault();post('/scale',{delta:e.deltaY>0?-1:1});};
cv.oncontextmenu=e=>{e.preventDefault();
 if(RIGHT_DRAG_PAN)return; // point-select disabled (nerf/gui.py:448-452)
 const r=cv.getBoundingClientRect();
 post('/click',{x:(e.clientX-r.left)/cv.width,y:(e.clientY-r.top)/cv.height,
                label:neg?0:1});};
window.onkeydown=e=>{
 if(e.key==='t'||e.key==='T'){training=!training;post('/train',{on:training});}
 if(e.key==='s'||e.key==='S')post('/save_points',{});
 if(e.key==='n'||e.key==='N'){neg=!neg;const el=document.getElementById('neg');
  el.textContent=neg?'ON':'off';el.className=neg?'on':'off';}};
const kf=document.getElementById('kf');
let bound=2.0;
fetch('/status').then(r=>r.json()).then(j=>{if(j.bound)bound=j.bound;});
function setCrop(f){ // symmetric AABB crop at fraction f of the bound
 if(f>=1){post('/aabb',{reset:true});return;}
 const b=f*bound;
 post('/aabb',{min:[-b,-b,-b],max:[b,b,b]});}
</script></body></html>"""


class ViewerState:
    """The server's shared state: the session, the lock that serialises
    renders, picks and training ticks, and the training thread (it runs
    ticks while `training` is on and the session has a scene)."""

    def __init__(self, session, points_path: str,
                 right_drag_pan: bool = False):
        self.session = session
        self.points_path = points_path
        self.right_drag_pan = right_drag_pan
        self.lock = threading.Lock()
        self.training = False
        self.last_train = {"loss": float("nan"), "step": 0}
        self._stop = False
        self.thread = threading.Thread(target=self._train_loop, daemon=True)
        self.thread.start()

    def _train_loop(self):
        while not self._stop:
            if self.training and self.session.scene is not None:
                with self.lock:
                    self.last_train = self.session.train_ticks(
                        target_seconds=0.5)
            else:
                time.sleep(0.05)

    def stop(self, timeout: float = 60.0):
        """End the training thread (after its current tick)."""
        self._stop = True
        self.thread.join(timeout)

    def projected_points(self):
        """The picked points projected into the current camera, as
        [x / W, y / H, label] (the canvas overlay); points behind it are
        left out."""
        s = self.session
        cam = s.camera
        pose = cam.pose
        R, t = pose[:3, :3], pose[:3, 3]
        fx, fy, cx, cy = cam.intrinsics
        out = []
        for p, l in zip(s.points_3d, s.point_labels):
            pc = R.T @ (np.asarray(p) - t)
            z = -pc[2]
            if z <= 1e-6:
                continue
            u = fx * pc[0] / z + cx
            v = -fy * pc[1] / z + cy
            out.append([float(u / cam.W), float(v / cam.H), int(l)])
        return out


def _make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, body: bytes, ctype: str, headers=(), code=200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(json.dumps(obj).encode(), "application/json",
                       code=code)

        def do_GET(self):
            s = state.session
            if self.path == "/" or self.path.startswith("/index"):
                page = (_PAGE.replace("{W}", str(s.camera.W))
                        .replace("{H}", str(s.camera.H))
                        .replace("{RDP}", "true" if state.right_drag_pan
                                 else "false")).encode()
                self._send(page, "text/html")
                return
            if self.path.startswith("/frame"):
                ds = 2
                if "ds=" in self.path:
                    ds = max(1, int(self.path.split("ds=")[1].split("&")[0]))
                with state.lock:
                    frame = s.render_frame(downscale=ds)
                img = (np.clip(frame["image"], 0, 1) * 255).astype(np.uint8)
                self._send(encode_png(img), "image/png", headers=(
                    ("X-FPS", f"{frame['fps']:.1f}"),
                    ("X-SPP", str(frame.get("spp", 1))),
                    ("X-Step", str(state.last_train.get("step", 0))),
                    ("X-Loss", f"{state.last_train.get('loss', 0):.4f}"),
                    ("X-Points", json.dumps(state.projected_points()))))
                return
            if self.path == "/status":
                self._json({"training": state.training,
                            **state.last_train,
                            "n_points": len(s.points_3d),
                            "fovy": s.camera.fovy,
                            "bg_color": s.bg_color,
                            "spp": s.spp,
                            "aabb": (None if s.aabb is None
                                     else np.asarray(s.aabb).tolist()),
                            "bound": float(s.trainer.cfg.bound),
                            "n_keyframes": len(s.trajectory)})
                return
            self._json({"error": "not found"}, 404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            s = state.session
            cam = s.camera
            if self.path == "/orbit":
                cam.orbit(body.get("dx", 0), body.get("dy", 0))
            elif self.path == "/pan":
                cam.pan(body.get("dx", 0), body.get("dy", 0))
            elif self.path == "/scale":
                cam.scale(body.get("delta", 0))
            elif self.path == "/click":
                with state.lock:
                    p = s.pick_point(int(body["x"] * cam.W),
                                     int(body["y"] * cam.H),
                                     label=int(body.get("label", 1)))
                self._json({"point": None if p is None else p.tolist()})
                return
            elif self.path == "/train":
                state.training = bool(body.get("on", False))
            elif self.path == "/save_points":
                path = body.get("path", state.points_path)
                s.save_points(path)
                self._json({"saved": path, "n": len(s.points_3d)})
                return
            elif self.path == "/fovy":
                cam.set_fovy(float(body.get("value", cam.fovy)))
            elif self.path == "/bg":
                s.bg_color = float(np.clip(body.get("value", 1.0), 0.0, 1.0))
                s._accum_sig = None
            elif self.path == "/spp":
                s.spp = int(np.clip(body.get("value", 1), 1, 64))
            elif self.path == "/aabb":
                if body.get("reset"):
                    s.set_aabb()
                else:
                    s.set_aabb(body.get("min"), body.get("max"))
            elif self.path == "/record_pose":
                self._json({"n_keyframes": s.record_pose()})
                return
            elif self.path == "/clear_trajectory":
                s.trajectory.clear()
            elif self.path == "/save_trajectory":
                path = body.get("path", "trajectory.json")
                self._json({"saved": path,
                            "n_keyframes": s.save_trajectory(path)})
                return
            else:
                self._json({"error": "not found"}, 404)
                return
            self._json({"ok": True})

    return Handler


def serve(session, host: str = "127.0.0.1", port: int = 7860,
          points_path: str = "picked_points.json", block: bool = True,
          right_drag_pan: bool = False):
    """Start the viewer on host:port (port 0 takes a free one).  Returns
    (server, state); with block=False the server runs on a daemon thread
    and the caller ends it with server.shutdown() and state.stop().
    right_drag_pan: --gui_mouse_right_drag (right-drag pans, right-click
    picks nothing)."""
    state = ViewerState(session, points_path, right_drag_pan=right_drag_pan)
    server = ThreadingHTTPServer((host, port), _make_handler(state))
    print(f"[viewer] serving on http://{host}:{server.server_address[1]}",
          flush=True)
    if block:
        try:
            server.serve_forever()
        finally:
            server.server_close()
            state.stop()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, state
