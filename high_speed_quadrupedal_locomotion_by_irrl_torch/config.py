"""Single-source-of-truth configuration for the BlackPanther MDP.

Mirrors the reference's YAML key set (parameter_load_from_yaml,
``Environment.hpp:1594-1659``) plus the vectorization keys consumed at
``VectorizedEnvironment.hpp:145-153``, as one frozen dataclass. The reference
duplicated its normalization constants between C++ (``Environment.hpp:375-393``)
and Python (``bp5_config.py``); here they are derived from this config in one
place (:mod:`..envs.blackpanther`).

The PyTorch port's own copy of ``high_speed_quadrupedal_locomotion_by_irrl_tpu
.config``: same fields, defaults and YAML keys. All fields are static Python
values, so every flag selects a Python branch (no data-dependent branching on
the device). PyYAML is imported only by :func:`from_yaml`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    # --- timing (RaisimGymEnv.hpp:117-119, yaml simulation_dt/control_dt/max_time)
    simulation_dt: float = 0.00025
    control_dt: float = 0.002
    max_time: float = 1.5

    # --- gait parameters (Environment.hpp:1598-1613)
    abad: float = 0.0
    period: float = 0.2
    lam: float = 0.5                    # stance fraction of the gait cycle
    stand_height: float = 0.28
    up_height: float = 0.08             # swing apex height
    down_height: float = 0.0
    gait_step: float = 0.15
    vx_max: float = 5.0                 # yaml key "Vx"
    vx_min: float = 0.0                 # NOTE: the reference never loads Vx_min; it stays 0.0
    vy_max: float = 0.0                 # yaml key "Vy"; vy_min = -vy_max
    omega_max: float = 1.0              # yaml key "Omega"; omega_min = -omega_max
    lean_front: float = 0.0             # yaml "LeanFront"
    lean_hind: float = 0.0              # yaml "LeanHind"
    gait_type: int = 0                  # 0 trot / 1 bound / 2 gallop (Environment.hpp:398-409)

    # --- mode flags (Environment.hpp:1616-1629)
    terrain: bool = False
    # sampled 500x20 m heightmap (the reference's Raisim grid,
    # Environment.hpp:252-265) vs analytic fractal value noise; only
    # meaningful when terrain=True
    terrain_sampled: bool = True
    # heightmap amplitude [m] (Environment.hpp zScale; DR/curriculum write
    # the live value through EnvState.terrain.z_scale — this is the init)
    terrain_z_scale: float = 0.1
    manual: bool = False
    crucial: bool = False               # meteorite-attack curriculum
    action_filter: bool = False         # yaml "Filter"
    stochastic_dynamics: bool = False
    height_variable: bool = False
    time_based_contact: bool = False
    manual_traj: bool = True
    motor_dynamics: bool = False
    obs_filter: bool = False
    wildcat: bool = False               # mirror vx (run "backwards")
    force_disturbance: bool = False
    convert2torque: bool = False

    # --- reward coefficients (Environment.hpp:1632-1639)
    terminal_reward: float = -1.0
    ee_coeff: float = 0.0               # EndEffectorRewardCoeff
    body_pos_coeff: float = 0.05
    body_atti_coeff: float = 0.05
    joint_mimic_coeff: float = 0.1
    vel_keep_coeff: float = 0.6
    torque_coeff: float = 0.3
    contact_coeff: float = 0.0

    # --- control / PD (Environment.hpp:1643-1653)
    stiffness: float = 40.0
    stiffness_low: float = 40.0
    abad_ratio: float = 1.0
    damping: float = 1.0
    freq: float = 30.0                  # action low-pass cut-off (used iff action_filter)
    num_cube: int = 6
    action_noise: float = 0.0
    obs_noise: float = 2.0              # yaml "ObsNoise" — global scale on all obs noise
    obs_filter_freq: float = 20.0

    # --- motor envelope (Environment.hpp:1656-1658, torque_clamp :1273-1312)
    motor_max_torque: float = 18.0
    motor_critical_speed: float = 100.0
    motor_max_speed: float = 200.0

    # --- noise magnitudes (Environment.hpp:1987-2003, fixed in C++)
    joint_noise: float = 0.002          # uniform +-, scaled by obs_noise
    joint_velocity_noise: float = 0.8   # uniform +-
    posture_noise_std: float = 0.02     # gaussian
    omega_noise_std: float = 0.5        # gaussian

    # --- command filtering (Environment.hpp:2043)
    cmd_update_param: float = 0.995

    # --- contact material defaults (Environment.hpp:433, SetContactCoefficient :1407-1418)
    # Restitution is LIVE in both contact models (round 4): the hard solver
    # adds e*|vn-| bounce rows above the threshold (phys/hard_contact.py),
    # the compliant surrogate maps e to its damping
    # (phys/model.damping_for_restitution). The reference's default material
    # is (0.6, 0.2, 0.01) (Environment.hpp:433) and its *test* path sets
    # (0.8, 0.2, 0.01) (run_bp_v5.py:317); this framework's calibrated
    # surrogate default keeps e=0 (the overdamped contact every committed
    # table/artifact was produced under — with d0=1000, zeta~4.2, the old
    # model already behaved as e~0, so 0.0 is the honest default where the
    # previous 0.2 was a dead knob). The reference materials are measured
    # explicitly in scripts/bp5_replica_ablation.py.
    contact_friction: float = 0.6
    contact_restitution: float = 0.0
    contact_res_threshold: float = 0.01

    # --- compliant-contact model (replacement for Raisim's hard solver;
    #     stiffness/damping seeded from the URDF toe <contact> tags, black_panther.urdf:131-137)
    contact_stiffness: float = 30000.0
    contact_damping: float = 1000.0
    contact_slip_vel: float = 0.1       # regularized-Coulomb slip velocity scale [m/s]
    # capped-impulse friction: effective contact mass [kg]; > 0 switches the
    # tangential model to min(mu*fn, m_eff/dt * |vt|) — true stiction like
    # Raisim's hard solver, stable at any stiffness (phys/contact.py notes)
    contact_impulse_mass: float = 0.0
    # hard (impulse/LCP-class) toe contact: velocity-level friction-cone
    # complementarity solved by fixed-iteration projected Gauss-Seidel per
    # substep (phys/hard_contact.py) — the Raisim-class solver the reference
    # trains in. Runs on the per-env envs.blackpanther.step only (step_batch
    # refuses it, as JAX's asserts); YAML extension key "HardContact".
    hard_contact: bool = False
    hard_contact_iters: int = 12
    # the PPO rollout's physics: step_batch (batch-in-lanes, the fused kernel
    # launch) when set, else the per-env step; cli/train.py sets it by the
    # JAX package's rule (lanes at --num-envs >= 1024 or with --lanes)
    use_lanes_physics: bool = False

    # --- domain randomization magnitudes (Environment.hpp:2069-2071)
    mass_disturbance_ratio: float = 0.15
    com_disturbance: float = 0.02
    calf_disturbance: float = 0.01

    # --- vectorization (VectorizedEnvironment.hpp:145-153)
    num_envs: int = 200
    seed: int = 1                       # yaml "seedd"

    # --- attack curriculum geometry (Environment.hpp:1973-1976)
    cube_len: float = 0.08
    cube_mass: float = 0.4
    cube_place_radius: float = 0.0

    # ---- derived quantities -------------------------------------------------
    @property
    def substeps(self) -> int:
        """Physics substeps per control step (Environment.hpp:711)."""
        return int(self.control_dt / self.simulation_dt + 1e-10)

    @property
    def episode_len(self) -> int:
        """Control steps per episode = n_steps (run_bp_v5.py:232-233)."""
        return int(self.max_time / self.control_dt)

    @property
    def vy_min(self) -> float:
        return -self.vy_max

    @property
    def omega_min(self) -> float:
        return -self.omega_max

    @property
    def filter_para(self) -> float:
        """Action low-pass coefficient (Environment.hpp:396)."""
        return (1.0 - self.freq * self.control_dt) if self.action_filter else 0.0

    @property
    def obs_filter_alpha(self) -> float:
        """Observation low-pass coefficient (Environment.hpp:423-427)."""
        w = 2.0 * 3.14 * self.control_dt * self.obs_filter_freq
        return w / (w + 1.0)

    @property
    def phase_offsets(self) -> tuple[float, float, float, float]:
        """Per-leg gait phase offsets [FR, FL, HR, HL] (Environment.hpp:398-409)."""
        return {
            0: (0.5, 0.0, 0.0, 0.5),    # trot
            1: (0.5, 0.5, 0.0, 0.0),    # bound
            2: (0.0, 0.25, 0.5, 0.75),  # gallop
        }[self.gait_type]

    def replace(self, **kw: Any) -> "EnvConfig":
        return dataclasses.replace(self, **kw)


# Mapping from the reference's YAML keys to EnvConfig field names.
_YAML_KEYS: Mapping[str, str] = {
    "simulation_dt": "simulation_dt", "control_dt": "control_dt", "max_time": "max_time",
    "abad": "abad", "period": "period", "lam": "lam", "stand_height": "stand_height",
    "up_height": "up_height", "down_height": "down_height", "gait_step": "gait_step",
    "Vx": "vx_max", "Vy": "vy_max", "Omega": "omega_max",
    "LeanFront": "lean_front", "LeanHind": "lean_hind", "GaitType": "gait_type",
    "Terrain": "terrain", "TerrainZScale": "terrain_z_scale",
    "Manual": "manual", "Crutial": "crucial", "Filter": "action_filter",
    "StochasticDynamics": "stochastic_dynamics", "HeightVariable": "height_variable",
    "TimeBasedContact": "time_based_contact", "ManualTraj": "manual_traj",
    "MotorDynamics": "motor_dynamics", "ObsFilter": "obs_filter", "WILDCAT": "wildcat",
    "ForceDisturbance": "force_disturbance", "Convert2Torque": "convert2torque",
    "HardContact": "hard_contact",  # extension key (no reference equivalent)
    # extension keys for the contact material (the reference sets materials
    # in C++ — setDefaultMaterial(0.6, 0.2, 0.01), Environment.hpp:433 — and
    # at runtime via SetContactCoefficient; these make the same triple
    # drivable from YAML, restitution-live since round 4)
    "ContactFriction": "contact_friction",
    "ContactRestitution": "contact_restitution",
    "ContactResThreshold": "contact_res_threshold",
    "terminalRewardCoeff": "terminal_reward", "EndEffectorRewardCoeff": "ee_coeff",
    "BodyPosRewardCoeff": "body_pos_coeff", "BodyAttitudeRewardCoeff": "body_atti_coeff",
    "JointRewardCoeff": "joint_mimic_coeff", "VelRewardCoeff": "vel_keep_coeff",
    "TorqueCoeff": "torque_coeff", "ContactCoeff": "contact_coeff",
    "Stiffness": "stiffness", "Stiffness_Low": "stiffness_low", "AbadRatio": "abad_ratio",
    "Damping": "damping", "Freq": "freq", "CubeNum": "num_cube",
    "ActionNoise": "action_noise", "ObsNoise": "obs_noise",
    "MotorMaxTorque": "motor_max_torque", "MotorCriticalSpeed": "motor_critical_speed",
    "MotorMaxSpeed": "motor_max_speed",
    "num_envs": "num_envs", "seedd": "seed",
}


def from_yaml(path_or_str: str) -> EnvConfig:
    """Load an :class:`EnvConfig` from a reference-format YAML file or string.

    Accepts both the full file (with an ``environment:`` subtree, as consumed
    by run_bp_v5.py:202-207) and the bare subtree.
    Unknown keys (render, num_threads, RefTraj, FPS, Camera, visual-only and
    spring keys) are ignored — they configure host-side concerns handled
    elsewhere in this framework.
    """
    import yaml

    looks_like_path = ("\n" not in path_or_str and ":" not in path_or_str)
    if looks_like_path and not os.path.exists(path_or_str):
        # never silently fall back to defaults for a mistyped path (a round-2
        # training run burned 4 hours on EnvConfig() defaults this way)
        raise FileNotFoundError(f"config YAML not found: {path_or_str!r}")
    try:
        with open(path_or_str) as f:
            doc = yaml.safe_load(f)
    except (OSError, ValueError):
        doc = yaml.safe_load(path_or_str)
    if isinstance(doc, str):
        raise ValueError(f"not a YAML mapping: {path_or_str[:80]!r}")
    if "environment" in doc:
        doc = doc["environment"]
    kw = {}
    for yk, fk in _YAML_KEYS.items():
        if yk in doc:
            ftype = EnvConfig.__dataclass_fields__[fk].type
            v = doc[yk]
            if ftype == "bool" or isinstance(getattr(EnvConfig, fk, None), bool):
                v = bool(v)
            kw[fk] = v
    return EnvConfig(**kw)


def train_default() -> EnvConfig:
    """The reference's training config (default_cfg.yaml:5-62)."""
    return EnvConfig(
        num_envs=200, seed=1, stand_height=0.28, manual=False, manual_traj=True,
        stochastic_dynamics=True, wildcat=True, gait_type=1, obs_noise=2.0,
        terminal_reward=-1.0, ee_coeff=0.0, body_pos_coeff=0.05, body_atti_coeff=0.05,
        joint_mimic_coeff=0.1, vel_keep_coeff=0.6, torque_coeff=0.3, contact_coeff=0.0,
        motor_critical_speed=100.0, motor_max_speed=200.0,
    )


def test_default() -> EnvConfig:
    """The reference's deployment/test config (bp5_test.yaml:5-63)."""
    return EnvConfig(
        num_envs=1, seed=10, stand_height=0.30, manual=True, manual_traj=True,
        height_variable=True, stochastic_dynamics=False, wildcat=False, gait_type=0,
        obs_noise=0.0, action_noise=0.0,
        terminal_reward=0.0, ee_coeff=0.0, body_pos_coeff=0.2, body_atti_coeff=0.2,
        joint_mimic_coeff=0.4, vel_keep_coeff=0.2, torque_coeff=0.1, contact_coeff=0.1,
        motor_critical_speed=14.2, motor_max_speed=40.0,
    )
