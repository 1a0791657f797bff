"""BlackPanther rigid-body model compiled to static arrays.

Port of ``phys/model.py``: the same 13-moving-body model (body + 4 x
abduct/thigh/shank, toe links merged into the shanks) from black_panther.urdf,
as numpy constants, plus the per-env randomizable :class:`RobotParams`
(tensors with a leading env axis once batched).

Body indices: 0 = base, then FR(1,2,3) FL(4,5,6) HR(7,8,9) HL(10,11,12) in
abduct/thigh/shank order. Joint j (0..11) drives body j+1; dof index 6+j.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod

NUM_BODIES = 13
NUM_JOINTS = 12
NV = 18  # generalized velocities: [v_world(3), omega_world(3), qd(12)]
NQ = 19  # generalized coords:     [pos(3), quat wxyz(4), q(12)]

PARENT = np.array([-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11])

# Legs: (sign_x fore/hind, sign_y right/left). Right legs have y<0.
LEG_SIGNS = [(+1, -1), (+1, +1), (-1, -1), (-1, +1)]  # FR, FL, HR, HL
IS_RIGHT = np.array([True, False, True, False])

# Gait/IK link constants (Environment.hpp:1949-1952); they differ slightly
# from the URDF joint offsets, as in the reference.
L_HIP = 0.085
L_THIGH = 0.209
L_CALF = 0.2175

TOE_OFFSET_Z = -0.19      # toe joint origin in shank frame (urdf:162)
TOE_RADIUS = 0.0275       # urdf:148
KNEE_OFFSET_Z = -0.201    # thigh->shank joint origin (urdf:106)
HIP_OFFSET_Y = 0.085      # abduct->thigh joint origin (urdf:80)
ABAD_OFFSET = (0.212, 0.051)  # body->abduct joint origin magnitudes (urdf:52)

# Hip positions relative to body center (EndEffectorOffset_, Environment.hpp:331-334).
EE_OFFSET = np.array([
    [0.19, -0.058, 0.0],
    [0.19, 0.058, 0.0],
    [-0.19, -0.058, 0.0],
    [-0.19, 0.058, 0.0],
])

BODY_BOX_HALF = np.array([0.15, 0.10, 0.05])  # collision box size/2 (urdf:26)

TORQUE_LIMIT = np.array([18.0, 18.0, 27.0] * 4)       # Environment.hpp:354
TORQUE_LIMIT_J = TORQUE_LIMIT
ROTOR_INERTIA = np.array([0.003708, 0.003708, 0.008966] * 4)  # urdf:56,110
JOINT_DAMPING = 0.01                                   # urdf <dynamics damping>
GEAR_RATIO = np.array([6.0, 6.0, 9.33] * 4)            # Environment.hpp:167
KNEE_RATIO = 1.55                                      # torque_clamp, Environment.hpp:1291

SHANK_BODY_IDX = np.array([3, 6, 9, 12])  # bodies carrying the toe spheres

# Toe-normal effective (Delassus) mass at the stand pose (phys/model.py notes).
TOE_EFF_MASS = 0.47

# Stand pose = action mean (Environment.hpp:317-322).
STAND_JOINT_POS = np.array([0.0, -0.78, 1.57] * 4)
STAND_BASE_Z = 0.35


def _leg_inertials(sx: int, sy: int):
    """(mass, com, inertia) for abduct/thigh/shank+toe of one leg."""
    abd_m = 0.54
    abd_com = np.array([0.058 * sx, 0.00485 * sy, 0.0])
    abd_I = np.diag([0.000391, 0.000739, 0.000488])
    thigh_m = 0.636
    thigh_com = np.array([0.0, -0.019 * sy, -0.01865])
    thigh_I = np.array([
        [0.001724, 0.0, 0.0],
        [0.0, 0.001907, -0.000228 * sy],
        [0.0, -0.000228 * sy, 0.000468],
    ])
    sh_m, sh_com, sh_I = 0.064, np.array([0.0, 0.0, -0.0865]), np.diag([0.000716, 0.000721, 0.000012])
    toe_m, toe_com, toe_I = 0.05, np.array([0.0, 0.0, TOE_OFFSET_Z]), np.diag([2.5e-5] * 3)
    m = sh_m + toe_m
    com = (sh_m * sh_com + toe_m * toe_com) / m

    def shift(I, mm, c, c_new):
        d = c - c_new
        return I + mm * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    I = shift(sh_I, sh_m, sh_com, com) + shift(toe_I, toe_m, toe_com, com)
    return [(abd_m, abd_com, abd_I), (thigh_m, thigh_com, thigh_I), (m, com, I)]


def _build_static():
    masses = [3.72]
    coms = [np.array([0.0, 0.0, -0.003])]
    inertias = [np.diag([0.016269, 0.050813, 0.060989])]
    joint_origin = []   # joint j origin in parent frame
    joint_axis = []     # joint j axis in parent frame
    for (sx, sy) in LEG_SIGNS:
        for (m, c, I) in _leg_inertials(sx, sy):
            masses.append(m); coms.append(c); inertias.append(I)
        joint_origin += [
            np.array([ABAD_OFFSET[0] * sx, ABAD_OFFSET[1] * sy, 0.0]),
            np.array([0.0, HIP_OFFSET_Y * sy, 0.0]),
            np.array([0.0, 0.0, KNEE_OFFSET_Z]),
        ]
        joint_axis += [np.array([1.0, 0.0, 0.0]),
                       np.array([0.0, -1.0, 0.0]),
                       np.array([0.0, -1.0, 0.0])]
    return (np.array(masses), np.stack(coms), np.stack(inertias),
            np.stack(joint_origin), np.stack(joint_axis))


(_MASS, _COM, _INERTIA, _JORIGIN, JAXIS) = _build_static()


def _ancestor_mask() -> np.ndarray:
    """(13, 18): dof d moves body b (the 6 base dofs move every body; a joint
    moves the bodies below it)."""
    A = np.zeros((NUM_BODIES, NV))
    A[:, :6] = 1.0
    for b in range(1, NUM_BODIES):
        p = b
        while p > 0:
            A[b, 6 + p - 1] = 1.0
            p = PARENT[p]
    return A


ANC_MASK = _ancestor_mask()


@dataclasses.dataclass
class RobotParams:
    """Per-environment physical parameters; leading env axis when batched.

    Same fields and layouts as the JAX package's ``RobotParams``."""
    mass: torch.Tensor           # (13,)
    com: torch.Tensor            # (13, 3) in body frame
    inertia: torch.Tensor        # (13, 3, 3) about com, body frame
    joint_origin: torch.Tensor   # (12, 3) in parent frame
    friction: torch.Tensor       # ()
    restitution: torch.Tensor    # ()
    res_threshold: torch.Tensor  # ()
    contact_stiffness: torch.Tensor  # ()
    contact_damping: torch.Tensor    # () already restitution-mapped

    def map(self, fn) -> "RobotParams":
        return RobotParams(**{f.name: fn(getattr(self, f.name))
                              for f in dataclasses.fields(self)})

    def expand(self, batch: int) -> "RobotParams":
        """Unbatched params -> (batch, ...) copies."""
        return self.map(lambda x: x.expand((batch,) + x.shape).contiguous())


def damping_for_restitution(kn, d0, e):
    """Linear contact damping realizing coefficient of restitution ``e``
    (phys/model.damping_for_restitution): e <= 1e-3 keeps ``d0``, e >= 2e-3
    uses the spring-damper impact law at mass TOE_EFF_MASS, linear between."""
    kn, d0 = torch.as_tensor(kn), torch.as_tensor(d0)
    e = torch.clamp(torch.as_tensor(e, dtype=d0.dtype, device=d0.device), 0.0, 1.0)
    ln_e = torch.log(torch.clamp_min(e, 1e-6))
    zeta = -ln_e / torch.sqrt(math.pi ** 2 + ln_e ** 2)
    d_e = 2.0 * zeta * torch.sqrt(kn * TOE_EFF_MASS)
    w = torch.clamp((e - 1e-3) / 1e-3, 0.0, 1.0)
    return d0 + w * (torch.minimum(d0, d_e) - d0)


def nominal_params(cfg=None, device=None) -> RobotParams:
    """Unbatched nominal parameters on ``device`` (default ``cuda``)."""
    device = dev_mod.resolve(device)
    t = lambda x: dev_mod.tensor(x, device)  # noqa: E731
    kn = 30000.0 if cfg is None else cfg.contact_stiffness
    dn = 1000.0 if cfg is None else cfg.contact_damping
    mu = 0.6 if cfg is None else cfg.contact_friction
    rest = 0.0 if cfg is None else cfg.contact_restitution
    thresh = 0.01 if cfg is None else cfg.contact_res_threshold
    return RobotParams(
        mass=t(_MASS), com=t(_COM), inertia=t(_INERTIA), joint_origin=t(_JORIGIN),
        friction=t(mu), restitution=t(rest), res_threshold=t(thresh),
        contact_stiffness=t(kn),
        contact_damping=damping_for_restitution(t(kn), t(dn), t(rest)),
    )


def randomize(gen: torch.Generator, cfg, batch: int, device=None) -> RobotParams:
    """Domain-randomized params for ``batch`` envs (Environment.hpp:435-477):
    friction ~ U(0.4, 1.0), restitution ~ U(0, 0.3), threshold ~ U(0, 2);
    per-link mass * U(1 +- mass_disturbance_ratio); com + U(+-com_disturbance);
    calf length (knee joint z) + one shared U(+-calf_disturbance) per env.
    ``gen`` must live on ``device``."""
    device = dev_mod.resolve(device)
    p = nominal_params(cfg, device).expand(batch)

    def u(shape, lo=-1.0, hi=1.0):
        x = torch.rand((batch,) + shape, generator=gen, device=device, dtype=dev_mod.DTYPE)
        return lo + (hi - lo) * x
    mass = p.mass * (1.0 + u((NUM_BODIES,)) * cfg.mass_disturbance_ratio)
    com = p.com + u((NUM_BODIES, 3)) * cfg.com_disturbance
    dcalf = u(()) * cfg.calf_disturbance
    knee_mask = dev_mod.tensor(np.outer([0.0, 0.0, 1.0] * 4, [0.0, 0.0, 1.0]), device)
    joint_origin = p.joint_origin + knee_mask * dcalf[:, None, None]
    friction = u((), 0.4, 1.0)
    restitution = u((), 0.0, 0.3)
    res_threshold = u((), 0.0, 2.0)
    return dataclasses.replace(
        p, mass=mass, com=com, joint_origin=joint_origin, friction=friction,
        restitution=restitution, res_threshold=res_threshold,
        contact_damping=damping_for_restitution(
            p.contact_stiffness, dev_mod.tensor(cfg.contact_damping, device),
            restitution))


def robot_params_from_numpy(tree, device=None) -> RobotParams:
    """Carry a JAX ``RobotParams`` over to the port. ``tree`` is any object
    with the same field names holding numpy arrays (e.g. the JAX params after
    ``jax.tree.map(np.asarray, params)``)."""
    device = dev_mod.resolve(device)
    return RobotParams(**{f.name: dev_mod.tensor(np.asarray(getattr(tree, f.name)), device)
                          for f in dataclasses.fields(RobotParams)})


def stand_gc(abad: float = 0.0) -> np.ndarray:
    """gc_init_ (Environment.hpp:317-322): abad sign alternates -,+,-,+."""
    sign = np.array([-1.0, 0.0, 0.0, 1.0, 0.0, 0.0, -1.0, 0.0, 0.0, 1.0, 0.0, 0.0])
    q = STAND_JOINT_POS + sign * abad
    return np.concatenate([[0.0, 0.0, STAND_BASE_Z, 1.0, 0.0, 0.0, 0.0], q])
