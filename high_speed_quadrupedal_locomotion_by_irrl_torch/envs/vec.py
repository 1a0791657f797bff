"""Vectorized environment API.

Port of ``envs/vec.py``. :class:`VecEnv` is the state-in/state-out interface
over the per-env control step (``envs.blackpanther.step``, the counterpart
of the JAX package's ``vmap(bp.step)``): every method takes and returns the
batched :class:`~.blackpanther.EnvState`, and the randomness of one
``VecEnv`` comes from one ``torch.Generator`` on its device, seeded by
:meth:`VecEnv.init`. An optional RefTraj table (:mod:`.reftraj`) is held
once on the device and handed to every call. :class:`NumpyVecEnv` is a host-side adapter with the
reference's ``RaisimGymVecEnv`` surface (step/observe/reset, the episode
info dicts and the batched introspection getters, RaisimGymVecEnv.py:6-189),
numpy in and out.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import figures
from high_speed_quadrupedal_locomotion_by_irrl_torch.config import EnvConfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as bp
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl


class VecEnv:
    """``cfg.num_envs`` BlackPanther MDPs stepped as one batch on the per-env
    physics, on ``device`` (default ``cuda``). ``ref_table``: an optional
    (N, 30) RefTraj table (array or tensor), shared by every env."""

    def __init__(self, cfg: EnvConfig, ref_table=None, device=None):
        self.cfg = cfg
        self.num_envs = cfg.num_envs
        self.ob_dim = bp.OBS_DIM
        self.act_dim = bp.ACT_DIM
        self.device = dev_mod.resolve(device)
        self.ref_table = (None if ref_table is None
                          else dev_mod.tensor(ref_table, self.device).contiguous())
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed)

    def init(self, seed: int | None = None) -> bp.EnvState:
        """Fresh envs, with the generator re-seeded (``cfg.seed`` by default)."""
        self.gen.manual_seed(self.cfg.seed if seed is None else seed)
        return bp.env_init(self.cfg, self.num_envs, self.gen, self.device,
                           ref_table=self.ref_table)

    def step(self, state: bp.EnvState, action: torch.Tensor) -> bp.StepOut:
        return bp.step(self.cfg, state, action, self.gen, ref_table=self.ref_table)

    def reset(self, state: bp.EnvState) -> bp.EnvState:
        return bp.reset(self.cfg, state, self.gen, self.ref_table)

    def observe(self, state: bp.EnvState) -> torch.Tensor:
        return bp.observe(self.cfg, state)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class NumpyVecEnv:
    """RaisimGymVecEnv-compatible host adapter (numpy in/out).

    Keeps the per-env episode-reward bookkeeping and ``{"r", "l"}`` info dicts
    of the reference adapter (RaisimGymVecEnv.py:42-50).
    """

    def __init__(self, cfg: EnvConfig, seed: int | None = None, device=None):
        self.env = VecEnv(cfg, device=device)
        self.cfg = cfg
        self.num_envs = cfg.num_envs
        self.num_obs = bp.OBS_DIM
        self.num_acts = bp.ACT_DIM
        self.state = self.env.init(seed)
        self._ep_rewards = [[] for _ in range(self.num_envs)]
        self._video_gc = None

    def seed(self, seed: int) -> None:
        self.state = self.env.init(seed)

    def observe(self) -> np.ndarray:
        return _np(self.env.observe(self.state))

    def reset(self) -> np.ndarray:
        self.state = self.env.reset(self.state)
        return self.observe()

    def reset_and_update_info(self):
        return self.reset(), self._update_epi_info()

    def _update_epi_info(self):
        info = [{} for _ in range(self.num_envs)]
        for i in range(self.num_envs):
            info[i]["episode"] = {"r": sum(self._ep_rewards[i]), "l": len(self._ep_rewards[i])}
            self._ep_rewards[i].clear()
        return info

    def step(self, action: np.ndarray, visualize: bool = False):
        out = self.env.step(self.state, dev_mod.tensor(action, self.env.device))
        self.state = out.state
        if self._video_gc is not None:
            self._video_gc.append(_np(out.state.gc[0]))
        reward, done = _np(out.reward), _np(out.done)
        terms, height = _np(out.info["reward_terms"]), _np(out.info["base_height"])
        info = [{} for _ in range(self.num_envs)]
        for i in range(self.num_envs):
            self._ep_rewards[i].append(float(reward[i]))
            info[i]["extra_info"] = {
                "EndEffectorReward(0.15)": terms[i, 0],
                "Height_Keep_Reward(0.1)": terms[i, 1],
                "Balance_Keep_Reward(0.1)": terms[i, 2],
                "base height": float(height[i]),
                "JointReward(0.65)": terms[i, 3] + terms[i, 4],
                "VelocityReward(0.2)": terms[i, 5],
            }
            if done[i]:
                info[i]["episode"] = {"r": sum(self._ep_rewards[i]),
                                      "l": len(self._ep_rewards[i])}
                self._ep_rewards[i].clear()
        return _np(out.obs), reward, done, info

    # --- introspection passthroughs (RaisimGymVecEnv.py:54-93) ---------------
    def origin_state(self) -> np.ndarray:
        return _np(bp.origin_state(self.state))

    def reference_state(self) -> np.ndarray:
        return _np(bp.reference_state(self.state))

    def get_joint_effort(self) -> np.ndarray:
        return _np(bp.joint_effort(self.state))

    def get_generalized_force(self) -> np.ndarray:
        return _np(bp.generalized_force(self.state))

    def get_sphere_info(self) -> np.ndarray:
        """Attack-sphere state (GetSphereInfo parity; requires Crutial)."""
        if not self.cfg.crucial:
            raise ValueError("Please make sure the [Flag_Crutial] is True")
        return _np(bp.sphere_info(self.state))

    def get_inverse_mass_matrix(self) -> np.ndarray:
        return _np(bp.inverse_mass_matrix(self.state)).reshape(self.num_envs, -1)

    def get_nonlinear(self) -> np.ndarray:
        return _np(bp.nonlinear(self.state))

    # --- host-side stubs for the reference's visualization controls ----------
    def show_window(self):
        pass

    def hide_window(self):
        pass

    def start_recording_video(self, name: str = ""):
        """Begin capturing env 0's state each step (startRecordingVideo,
        RaisimGymEnv.hpp:88-94)."""
        self._video_path = name or "video.gif"
        self._video_gc = []

    def stop_recording_video(self):
        """Stop capturing and render the captured states, if any, with the
        writer behind ``cli/test --vid`` (:func:`..analysis.figures.rollout_animation`,
        gif or mp4 by the name's suffix)."""
        gcs, self._video_gc = self._video_gc, None
        if gcs:
            figures.rollout_animation(SimpleNamespace(gc=np.stack(gcs)), self._video_path)

    def curriculum_update(self):
        pass

    def set_contact_coefficient(self, coeff) -> None:
        """SetContactCoefficient parity: [friction, restitution, threshold]
        (Environment.hpp:1407-1418). Restitution re-maps the compliant damping
        (``phys.model.damping_for_restitution``) and sets the hard solver's
        bounce rows; the threshold gates the hard solver's bounce."""
        p = self.state.params
        full = lambda v: torch.full_like(p.contact_stiffness, float(v))  # noqa: E731
        restitution = full(coeff[1])
        damping = mdl.damping_for_restitution(p.contact_stiffness, full(self.cfg.contact_damping),
                                              restitution)
        params = dataclasses.replace(p, friction=full(coeff[0]), restitution=restitution,
                                     res_threshold=full(coeff[2]), contact_damping=damping)
        self.state = self.state.replace(params=params)

    def set_command(self, command) -> None:
        """Manual-mode command injection (run_bp_v5.py:408-409 path)."""
        cmd = dev_mod.tensor(np.asarray(command, np.float32), self.env.device)
        cmd = cmd.expand(self.num_envs, 3).clone()
        self.state = self.state.replace(command=cmd, command_filtered=cmd)
