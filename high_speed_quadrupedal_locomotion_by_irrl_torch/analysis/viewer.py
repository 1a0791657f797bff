"""Self-contained interactive 3D rollout viewer (OgreVis/ImGui-panel twin).

The reference renders training/test rollouts in a live Ogre window with an
ImGui reward panel and keyboard toggles (visualizer/raisimCustomerImguiPanel.hpp,
raisimKeyboardCallback.hpp); deployment boxes are often headless, so this
port of ``analysis/viewer.py`` emits a
single .html file with an embedded WebGL-free canvas renderer (inline JS,
no network dependencies — it works on an air-gapped machine) that plays the
logged rollout:

- 3D wireframe robot (body box, legs from FK, toe markers colored by contact),
- orbit/zoom camera (drag / wheel), follow-robot toggle,
- play/pause/scrub timeline, speed control, keyboard shortcuts
  (space = play, 1 = toggle reference overlay, f = follow),
- live readouts (t, v_body, command) and per-term reward bars — the
  ImGui reward-panel equivalent (RewardLogger.hpp:32-78).

Build it from an `analysis.eval.RolloutLog` of numpy arrays
(:func:`..analysis.eval.numpy_log`; or any gc/gv arrays) with
:func:`write_html`; open in any browser. The geometry is the forward
kinematics of the port's dense model (:mod:`..phys.dynamics`), on the CPU.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch.config import EnvConfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import dynamics as dyn
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils.rotation import quat_to_matrix

_REWARD_NAMES = ["EndEffector", "BodyPos", "BodyAttitude", "JointMimic",
                 "Velocity", "Torque", "Contact", "Total"]


def _frames_from_log(cfg: EnvConfig, log, stride: int = 5):
    """Per-frame geometry: body corners, per-leg joint chain, contacts."""
    params = mdl.nominal_params(cfg, device="cpu")
    gcs = torch.as_tensor(np.asarray(log.gc)[::stride], dtype=torch.float32)
    kin = dyn.fk(params, gcs)
    p = kin.p.numpy()          # (F,13,3)
    toe = kin.toe_pos.numpy()  # (F,4,3)
    R0 = kin.R[:, 0].numpy()   # (F,3,3)

    corners = np.einsum("fij,cj->fci", R0,
                        np.array([[sx, sy, sz] for sx in (-1, 1)
                                  for sy in (-1, 1) for sz in (-1, 1)])
                        * mdl.BODY_BOX_HALF) + p[:, 0][:, None]
    F = gcs.shape[0]
    # tolerate sparse logs (e.g. MPCRolloutLog has no contact/command)
    contact = getattr(log, "contact", None)
    contact = (np.asarray(contact)[::stride] if contact is not None
               else (toe[..., 2] < mdl.TOE_RADIUS + 1e-3).astype(float))
    cmd = getattr(log, "command", None)
    cmd = np.asarray(cmd)[::stride] if cmd is not None else np.zeros((F, 3))
    if cmd.ndim == 1:
        cmd = np.broadcast_to(cmd, (F, 3))
    R = quat_to_matrix(gcs[:, 3:7]).numpy()
    v_body = np.einsum("fji,fj->fi", R, np.asarray(log.gv)[::stride, :3])
    rterms = getattr(log, "reward_terms", None)
    if rterms is not None and np.asarray(rterms).ndim >= 2:
        rterms = np.asarray(rterms)[::stride]
    else:
        r = np.asarray(log.reward)[::stride]
        rterms = np.stack([np.zeros_like(r)] * 7 + [r], axis=-1)
    return {
        "dt": cfg.control_dt * stride,
        "body": np.round(corners, 4).tolist(),
        # legs: abduct, thigh, shank origins + toe per leg
        "legs": [np.round(np.concatenate(
            [p[:, 1 + 3 * leg:4 + 3 * leg], toe[:, leg:leg + 1]], axis=1), 4).tolist()
            for leg in range(4)],
        "contact": contact.round(2).tolist(),
        "cmd": cmd.round(3).tolist(),
        "v": v_body.round(3).tolist(),
        "rew": rterms.round(3).tolist(),
        "rew_names": _REWARD_NAMES,
    }


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>IRRL-TPU rollout viewer</title>
<style>
 body{margin:0;background:#14161a;color:#d8dce2;font:13px/1.4 system-ui,sans-serif}
 #hud{position:fixed;top:10px;left:10px;background:#1d2026cc;padding:10px 14px;
      border-radius:8px;min-width:230px}
 #hud b{color:#fff} .bar{height:8px;background:#2b3040;border-radius:4px;margin:2px 0 6px}
 .bar>i{display:block;height:100%;background:#5b8def;border-radius:4px}
 #ctl{position:fixed;bottom:10px;left:50%;transform:translateX(-50%);
      background:#1d2026cc;padding:8px 14px;border-radius:8px;display:flex;
      gap:10px;align-items:center}
 input[type=range]{width:320px} button{background:#2b3040;color:#d8dce2;border:0;
      border-radius:6px;padding:4px 12px;cursor:pointer} button:hover{background:#39405a}
 #help{position:fixed;top:10px;right:10px;background:#1d2026cc;padding:8px 12px;
      border-radius:8px;font-size:12px;color:#9aa3b2}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"></div>
<div id="help">drag = orbit &nbsp; wheel = zoom<br>
space = play &nbsp; f = follow &nbsp; r = reset view</div>
<div id="ctl">
 <button id="play">&#9654;</button>
 <input type="range" id="scrub" min="0" value="0" step="1">
 <span id="tlabel">0.00 s</span>
 <select id="speed"><option value="0.25">0.25x</option><option value="1" selected>1x</option>
 <option value="4">4x</option></select>
</div>
<script>
const D = __DATA__;
const F = D.body.length, dt = D.dt;
const canvas = document.getElementById('c'), ctx = canvas.getContext('2d');
let W, H; function resize(){W=canvas.width=innerWidth;H=canvas.height=innerHeight}
resize(); addEventListener('resize', resize);
let yaw=0.8, pitch=0.35, dist=1.6, target=[0,0,0.25], follow=true;
let frame=0, playing=true, speed=1, acc=0, last=performance.now();
const scrub=document.getElementById('scrub'); scrub.max=F-1;
function rot(p){ // world -> camera
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  const x=p[0]-target[0], y=p[1]-target[1], z=p[2]-target[2];
  const x1=cy*x+sy*y, y1=-sy*x+cy*y;
  return [y1, -sp*x1+cp*z, cp*x1+sp*z];
}
function proj(p){const q=rot(p); const k=0.9*Math.min(W,H)/dist;
  return [W/2 + q[0]*k, H/2 - q[1]*k];}   // orthographic, dist = zoom
function line(a,b,c,w){ctx.strokeStyle=c;ctx.lineWidth=w||1.5;ctx.beginPath();
  const p=proj(a),q=proj(b);ctx.moveTo(p[0],p[1]);ctx.lineTo(q[0],q[1]);ctx.stroke();}
function dot(a,c,r){const p=proj(a);ctx.fillStyle=c;ctx.beginPath();
  ctx.arc(p[0],p[1],r||4,0,6.283);ctx.fill();}
const EDGES=[[0,1],[0,2],[1,3],[2,3],[4,5],[4,6],[5,7],[6,7],[0,4],[1,5],[2,6],[3,7]];
function draw(){
  ctx.fillStyle='#14161a'; ctx.fillRect(0,0,W,H);
  const body=D.body[frame];
  if(follow){const cx=(body[0][0]+body[7][0])/2, cy2=(body[0][1]+body[7][1])/2;
    target=[cx, cy2, 0.25];}
  // ground grid, 0.25 m pitch around the target
  const gx=Math.round(target[0]*4)/4, gy=Math.round(target[1]*4)/4;
  for(let i=-8;i<=8;i++){
    line([gx+i*0.25, gy-2, 0],[gx+i*0.25, gy+2, 0], '#232733');
    line([gx-2, gy+i*0.25, 0],[gx+2, gy+i*0.25, 0], '#232733');}
  for(const e of EDGES) line(body[e[0]], body[e[1]], '#8ab4ff', 2);
  for(let l=0;l<4;l++){const ch=D.legs[l][frame];
    for(let s=0;s<3;s++) line(ch[s], ch[s+1], '#d8dce2', 2);
    const inContact = D.contact[frame][l] > 0.5;
    dot(ch[3], inContact ? '#ffb54d' : '#5f6776', inContact ? 5 : 3);}
  // HUD
  const v=D.v[frame], cmd=D.cmd[frame];
  let h=`<b>t = ${(frame*dt).toFixed(2)} s</b><br>`+
    `v<sub>body</sub> = [${v[0].toFixed(2)}, ${v[1].toFixed(2)}, ${v[2].toFixed(2)}] m/s<br>`+
    `cmd = [${cmd[0].toFixed(2)}, ${cmd[1].toFixed(2)}, ${cmd[2].toFixed(2)}]<br><hr style="border-color:#2b3040">`;
  const rw=D.rew[frame];
  for(let i=0;i<D.rew_names.length;i++){
    const val=rw[i]||0, pct=Math.max(0,Math.min(100, val*100));
    h+=`${D.rew_names[i]} ${val.toFixed(3)}<div class="bar"><i style="width:${pct}%"></i></div>`;}
  document.getElementById('hud').innerHTML=h;
  scrub.value=frame;
  document.getElementById('tlabel').textContent=(frame*dt).toFixed(2)+' s';
}
function tick(now){
  if(playing){acc+=(now-last)/1000*speed;
    while(acc>dt){acc-=dt;frame=(frame+1)%F;}}
  last=now; draw(); requestAnimationFrame(tick);}
requestAnimationFrame(tick);
let drag=false,lx=0,ly=0;
canvas.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY};
onmouseup=()=>drag=false;
onmousemove=e=>{if(!drag)return; yaw+=(e.clientX-lx)*0.008;
  pitch=Math.max(-1.4,Math.min(1.4,pitch+(e.clientY-ly)*0.008)); lx=e.clientX;ly=e.clientY};
canvas.onwheel=e=>{dist=Math.max(0.4,Math.min(8,dist*(1+e.deltaY*0.001)));e.preventDefault()};
document.getElementById('play').onclick=()=>playing=!playing;
scrub.oninput=e=>{playing=false;frame=+e.target.value};
document.getElementById('speed').onchange=e=>speed=+e.target.value;
onkeydown=e=>{if(e.key===' '){playing=!playing;e.preventDefault()}
  if(e.key==='f')follow=!follow; if(e.key==='r'){yaw=0.8;pitch=0.35;dist=1.6}};
</script></body></html>
"""


def write_html(cfg: EnvConfig, log, path: str, stride: int = 5) -> str:
    """Render a RolloutLog into a standalone interactive viewer HTML file."""
    data = _frames_from_log(cfg, log, stride)
    html = _HTML.replace("__DATA__", json.dumps(data))
    with open(path, "w") as f:
        f.write(html)
    return path
