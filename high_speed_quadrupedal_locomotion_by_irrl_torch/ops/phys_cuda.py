"""Physics as hand-written CUDA kernels (``csrc/phys_substep.cu``).

Replaces the JAX package's TPU kernel ``ops/phys_pallas.py::_kernel`` (whose
body is ``ops/phys_lanes.substep_lanes``). Two entry points over one device
body:

* :func:`substep` takes the same arguments as the plain
  :func:`..ops.phys_lanes.substep` and returns the same tuple: the function
  the TPU kernel computes.
* :func:`control_step` runs the ``n_substeps`` substeps of a control step,
  each after the PD torque of :mod:`..ops.pd_torque` from the fresh state, in
  one launch with the state in registers. Its optional Convert2Torque inputs
  (a torque feedforward and a PD scale, (12, B) each) are held over the
  substeps. Its optional terrain puts the ground under each toe and base
  corner at its height: the bilinear height of the shared heightmap
  (:class:`..phys.terrain.TerrainRows`: the grid and per-env offset, cell and
  height scale), or the analytic fractal of per-env seeds and height scales
  (:class:`..phys.terrain.TerrainParams`), which is its own instantiation of
  the kernel. Its plain version is :func:`control_step_plain`, the Python
  loop over the two plain functions. :func:`substep` stays on flat ground, as
  the TPU kernel does.

For tensors on the CPU both run their plain version; for CUDA tensors they
launch the kernel (four lanes an env, one per leg) or raise, never falling
back. ``launches`` counts the kernel launches of both, ``analytic_launches``
those of the control step on the analytic fractal (counted in both).

The wrappers pack the per-env parameters as (208, B) rows in the layout of
``phys_pallas.pack_params``; the kernels write one (69, B) or (81, B) output
whose row blocks come back as views: gc' 19 | gv' 18 | toe 12 | toe vel 12 |
|f| 4 | fn 4 | torque 12 (control step only).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import _build
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import pd_torque as pdt
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import phys_lanes as lanes
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import terrain as tr

P_ROWS = 13 + 39 + 117 + 36 + 3   # mass com inertia joint_origin friction kn dn
OUT_ROWS = 19 + 18 + 12 + 12 + 4 + 4
STEP_OUT_ROWS = OUT_ROWS + 12     # + the last substep's torque

launches = 0  # kernel launches made by substep() and control_step() in this process
analytic_launches = 0  # of which control_step() launches on the analytic fractal


def pack_params(P: lanes.LaneParams) -> torch.Tensor:
    """LaneParams -> (208, B) rows (phys_pallas.pack_params layout)."""
    B = P.mass.shape[-1]
    return torch.cat([P.mass, P.com.reshape(39, B), P.inertia.reshape(117, B),
                      P.joint_origin.reshape(36, B), P.friction[None], P.kn[None],
                      P.dn[None]])


def pack_pd_consts(pd: pdt.PDConsts) -> list[float]:
    """The 22 floats the control-step kernel takes by value: kp, kd, knee
    ratio and gear ratio by link of a leg, the envelope's max torque, critical
    speed, max speed and slope, then the motor model of ops/pd_torque.py."""
    return [*pd.kp, *pd.kd, *pd.knee_ratio, *pd.gear, pd.max_torque, pd.critical_speed,
            pd.max_speed, pd.slope, *pdt.MOTOR_MODEL]


@functools.cache
def _fns():
    lib = _build.load("phys_substep")
    sub, step = lib.phys_substep_launch, lib.phys_control_step_launch
    sub.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    step.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_float] * 3
                     + [ctypes.POINTER(ctypes.c_float), ctypes.c_int]
                     + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5)
    sub.restype = step.restype = ctypes.c_int
    return sub, step


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(name: str, x: torch.Tensor, rows: int | None, B: int, device) -> None:
    """float32, contiguous, on ``device``, of shape (rows, B), or (B,) for
    ``rows`` None."""
    if x.device != device or x.dtype != torch.float32:
        raise ValueError(f"{name}: need float32 on {device}, got {x.dtype} on {x.device}")
    shape = (B,) if rows is None else (rows, B)
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: need shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous tensor")


def _check_terrain(terrain: tr.TerrainRows | tr.TerrainParams, B: int, device) -> None:
    if isinstance(terrain, tr.TerrainParams):
        _check("terrain seed", terrain.seed, None, B, device)
        _check("terrain z_scale", terrain.z_scale, None, B, device)
        return
    g = terrain.grid
    if g.device != device or g.dtype != torch.float32 or g.dim() != 2 or not g.is_contiguous():
        raise ValueError(f"terrain grid: need a contiguous float32 (ny, nx) tensor on {device}, "
                         f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    if min(g.shape) < 2:
        raise ValueError(f"terrain grid: need at least 2 x 2 samples, got {tuple(g.shape)}")
    _check("terrain offset", terrain.offset, 2, B, device)
    _check("terrain cell", terrain.cell, None, B, device)
    _check("terrain z_scale", terrain.z_scale, None, B, device)


def _views(out: torch.Tensor, B: int):
    return (out[:19], out[19:37], out[37:49].view(4, 3, B), out[49:61].view(4, 3, B),
            out[61:65], out[65:69])


def _substep_kernel(P, gcT, gvT, tauT, base_wrenchT, slip_vel, impulse_scale, dt):
    global launches
    device, B = gcT.device, gcT.shape[-1]
    prm = pack_params(P)
    for name, x, rows in (("params", prm, P_ROWS), ("gcT", gcT, 19), ("gvT", gvT, 18),
                          ("tauT", tauT, 12), ("base_wrenchT", base_wrenchT, 6)):
        _check(name, x, rows, B, device)
    out = torch.empty((OUT_ROWS, B), dtype=torch.float32, device=device)
    fn, _ = _fns()
    with torch.cuda.device(device):
        err = fn(prm.data_ptr(), gcT.data_ptr(), gvT.data_ptr(), tauT.data_ptr(),
                 base_wrenchT.data_ptr(), out.data_ptr(), B, float(slip_vel),
                 float(impulse_scale), float(dt), _stream(device))
    _build.check(err, "phys_substep_launch")
    launches += 1
    return _views(out, B)


def substep(P: lanes.LaneParams, gcT: torch.Tensor, gvT: torch.Tensor,
            tauT: torch.Tensor, base_wrenchT: torch.Tensor,
            slip_vel: float, impulse_scale: float, dt: float):
    """(19,B),(18,B),(12,B),(6,B) -> (gcT', gvT', toe (4,3,B), toe_vel (4,3,B),
    force norm (4,B), normal force (4,B)), as phys_lanes.substep."""
    if gcT.device.type == "cpu":
        return lanes.substep(P, gcT, gvT, tauT, base_wrenchT, slip_vel, impulse_scale, dt)
    if gcT.device.type != "cuda":
        raise ValueError(f"phys substep: unsupported device {gcT.device}")
    return _substep_kernel(P, gcT, gvT, tauT, base_wrenchT, slip_vel, impulse_scale, dt)


def control_step_plain(P: lanes.LaneParams, pd: pdt.PDConsts, gcT, gvT, ptargetT,
                       torque_norm_lastT, base_wrenchT, n_substeps: int, slip_vel: float,
                       impulse_scale: float, dt: float, tau_ffT=None, pd_scaleT=None,
                       terrain: tr.TerrainRows | tr.TerrainParams | None = None):
    """The plain version of :func:`control_step`: ``n_substeps`` times the
    plain PD torque from the fresh state, then the plain substep."""
    ptarget, tnl = ptargetT.T, torque_norm_lastT.T
    tau_ff = None if tau_ffT is None else tau_ffT.T
    pd_scale = None if pd_scaleT is None else pd_scaleT.T
    ground_fn = None if terrain is None else lambda x, y: tr.height(terrain, x, y)
    for _ in range(n_substeps):
        tauT = pdt.pd_torque(pd, ptarget, tnl, gcT[7:].T, gvT[6:].T, tau_ff,
                             pd_scale).T.contiguous()
        gcT, gvT, toe, toe_vel, fnorm, fnormal = lanes.substep(
            P, gcT, gvT, tauT, base_wrenchT, slip_vel, impulse_scale, dt, ground_fn)
    return gcT, gvT, toe, toe_vel, fnorm, fnormal, tauT


def _control_step_kernel(P, pd, gcT, gvT, ptargetT, torque_norm_lastT, base_wrenchT,
                         n_substeps, slip_vel, impulse_scale, dt, tau_ffT=None, pd_scaleT=None,
                         terrain=None):
    global launches, analytic_launches
    device, B = gcT.device, gcT.shape[-1]
    prm = pack_params(P)
    for name, x, rows in (("params", prm, P_ROWS), ("gcT", gcT, 19), ("gvT", gvT, 18),
                          ("ptargetT", ptargetT, 12),
                          ("torque_norm_lastT", torque_norm_lastT, 12),
                          ("base_wrenchT", base_wrenchT, 6), ("tau_ffT", tau_ffT, 12),
                          ("pd_scaleT", pd_scaleT, 12)):
        if x is not None:
            _check(name, x, rows, B, device)
    if terrain is not None:
        _check_terrain(terrain, B, device)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    analytic = isinstance(terrain, tr.TerrainParams)
    if terrain is None:
        ground = (None, 0, 0, None, None, None, None)
    elif analytic:
        ground = (None, 0, 0, None, None, terrain.z_scale.data_ptr(), terrain.seed.data_ptr())
    else:
        ny, nx = terrain.grid.shape
        ground = (terrain.grid.data_ptr(), nx, ny, terrain.offset.data_ptr(),
                  terrain.cell.data_ptr(), terrain.z_scale.data_ptr(), None)
    out = torch.empty((STEP_OUT_ROWS, B), dtype=torch.float32, device=device)
    consts = (ctypes.c_float * 22)(*pack_pd_consts(pd))
    _, fn = _fns()
    with torch.cuda.device(device):
        err = fn(prm.data_ptr(), gcT.data_ptr(), gvT.data_ptr(), ptargetT.data_ptr(),
                 torque_norm_lastT.data_ptr(), base_wrenchT.data_ptr(), ptr(tau_ffT),
                 ptr(pd_scaleT), out.data_ptr(), B, int(n_substeps), float(slip_vel),
                 float(impulse_scale), float(dt), consts, int(pd.motor_dynamics), *ground,
                 _stream(device))
    _build.check(err, "phys_control_step_launch")
    launches += 1
    analytic_launches += analytic
    return _views(out, B) + (out[69:81],)


def control_step(P: lanes.LaneParams, pd: pdt.PDConsts, gcT: torch.Tensor, gvT: torch.Tensor,
                 ptargetT: torch.Tensor, torque_norm_lastT: torch.Tensor,
                 base_wrenchT: torch.Tensor, n_substeps: int, slip_vel: float,
                 impulse_scale: float, dt: float, tau_ffT: torch.Tensor | None = None,
                 pd_scaleT: torch.Tensor | None = None,
                 terrain: tr.TerrainRows | tr.TerrainParams | None = None):
    """One control step of physics. (19,B),(18,B) state, (12,B) position
    targets and last normalized torques, (6,B) base wrench, optional (12,B)
    torque feedforward and PD scale, optional terrain -> (gcT', gvT') after
    ``n_substeps`` substeps, the last substep's toe (4,3,B), toe_vel (4,3,B),
    force norm (4,B) and normal force (4,B), and the last substep's joint
    torque (12,B). ``None`` for a Convert2Torque input is the PD path (a
    feedforward of 0, a scale of 1), bit for bit; ``None`` for the terrain is
    flat ground, a :class:`..phys.terrain.TerrainParams` (B,) rows of the
    analytic fractal."""
    if n_substeps < 1:
        raise ValueError(f"control step: need n_substeps >= 1, got {n_substeps}")
    args = (P, pd, gcT, gvT, ptargetT, torque_norm_lastT, base_wrenchT, n_substeps, slip_vel,
            impulse_scale, dt, tau_ffT, pd_scaleT, terrain)
    if gcT.device.type == "cpu":
        return control_step_plain(*args)
    if gcT.device.type != "cuda":
        raise ValueError(f"phys control step: unsupported device {gcT.device}")
    return _control_step_kernel(*args)
