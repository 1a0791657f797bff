"""Physics substep as a hand-written CUDA kernel (``csrc/phys_substep.cu``).

Replaces the JAX package's TPU kernel ``ops/phys_pallas.py::_kernel`` (whose
body is ``ops/phys_lanes.substep_lanes``). :func:`substep` takes the same
arguments as the plain :func:`..ops.phys_lanes.substep` and returns the same
tuple. For tensors on the CPU it runs that plain version; for CUDA tensors it
launches the kernel (one thread per env) or raises, never falling back.

The wrapper packs the per-env parameters as (208, B) rows in the layout of
``phys_pallas.pack_params`` and the kernel writes one (69, B) output, whose
row blocks come back as views: gc' 19 | gv' 18 | toe 12 | toe vel 12 | |f| 4 |
fn 4.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import _build
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import phys_lanes as lanes

P_ROWS = 13 + 39 + 117 + 36 + 3   # mass com inertia joint_origin friction kn dn
OUT_ROWS = 19 + 18 + 12 + 12 + 4 + 4

launches = 0  # kernel launches made by substep() in this process


def pack_params(P: lanes.LaneParams) -> torch.Tensor:
    """LaneParams -> (208, B) rows (phys_pallas.pack_params layout)."""
    B = P.mass.shape[-1]
    return torch.cat([P.mass, P.com.reshape(39, B), P.inertia.reshape(117, B),
                      P.joint_origin.reshape(36, B), P.friction[None], P.kn[None],
                      P.dn[None]])


@functools.cache
def _fn():
    lib = _build.load("phys_substep")
    fn = lib.phys_substep_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, x: torch.Tensor, rows: int, B: int, device) -> None:
    if x.device != device or x.dtype != torch.float32:
        raise ValueError(f"{name}: need float32 on {device}, got {x.dtype} on {x.device}")
    if tuple(x.shape) != (rows, B):
        raise ValueError(f"{name}: need shape {(rows, B)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous tensor")


def substep(P: lanes.LaneParams, gcT: torch.Tensor, gvT: torch.Tensor,
            tauT: torch.Tensor, base_wrenchT: torch.Tensor,
            slip_vel: float, impulse_scale: float, dt: float):
    """(19,B),(18,B),(12,B),(6,B) -> (gcT', gvT', toe (4,3,B), toe_vel (4,3,B),
    force norm (4,B), normal force (4,B)), as phys_lanes.substep."""
    global launches
    if gcT.device.type == "cpu":
        return lanes.substep(P, gcT, gvT, tauT, base_wrenchT, slip_vel, impulse_scale, dt)
    if gcT.device.type != "cuda":
        raise ValueError(f"phys substep: unsupported device {gcT.device}")
    device, B = gcT.device, gcT.shape[-1]
    prm = pack_params(P)
    for name, x, rows in (("params", prm, P_ROWS), ("gcT", gcT, 19), ("gvT", gvT, 18),
                          ("tauT", tauT, 12), ("base_wrenchT", base_wrenchT, 6)):
        _check(name, x, rows, B, device)
    out = torch.empty((OUT_ROWS, B), dtype=torch.float32, device=device)
    fn = _fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(prm.data_ptr(), gcT.data_ptr(), gvT.data_ptr(), tauT.data_ptr(),
                 base_wrenchT.data_ptr(), out.data_ptr(), B, float(slip_vel),
                 float(impulse_scale), float(dt), stream)
    _build.check(err, "phys_substep_launch")
    launches += 1
    return (out[:19], out[19:37], out[37:49].view(4, 3, B), out[49:61].view(4, 3, B),
            out[61:65], out[65:69])
