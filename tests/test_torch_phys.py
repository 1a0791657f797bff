"""PyTorch port: robot model and the physics substep against the JAX package.

The port's plain substep (ops/phys_lanes.substep) is held against the JAX
``phys_lanes.substep`` run eagerly (no jit: the jitted lanes graph is the
slow compile of the JAX suite). Inputs are made with numpy from a seed and
handed to both. The plain control step (PD torque + substep, iterated) is
held against the JAX package's ``_pd_torque`` and ``phys_lanes.substep``
iterated the same way. The CUDA kernels (ops/phys_cuda) are held against the
plain versions on the card in tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import pd_torque, phys_cuda
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import phys_lanes as tlanes
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as tmdl
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import rotation as trot
from high_speed_quadrupedal_locomotion_by_irrl_tpu import config as jconfig
from high_speed_quadrupedal_locomotion_by_irrl_tpu.envs import blackpanther as jbp
from high_speed_quadrupedal_locomotion_by_irrl_tpu.ops import phys_lanes as jlanes
from high_speed_quadrupedal_locomotion_by_irrl_tpu.ops import phys_pallas as jpallas
from high_speed_quadrupedal_locomotion_by_irrl_tpu.phys import model as jmdl
from high_speed_quadrupedal_locomotion_by_irrl_tpu.utils import rotation as jrot

torch.set_num_threads(1)


def _states(B, seed):
    """Perturbed stand states, some toes in contact (test_phys_lanes.py:18-28)."""
    rng = np.random.default_rng(seed)
    gc = np.tile(np.asarray(jmdl.stand_gc(0.0)), (B, 1))
    gc[:, 2] = 0.30
    gc = gc + 0.05 * rng.normal(size=(B, 19))
    gc[:, 3:7] /= np.linalg.norm(gc[:, 3:7], axis=-1, keepdims=True)
    gv = 0.5 * rng.normal(size=(B, 18))
    tau = 5.0 * rng.normal(size=(B, 12))
    bw = np.concatenate([rng.normal(size=(B, 3)) * 20.0, rng.normal(size=(B, 3))], axis=-1)
    return [x.astype(np.float32) for x in (gc, gv, tau, bw)]


def _random_params(B, seed):
    """Per-env domain-randomized JAX params (numpy leaves, leading env axis)."""
    cfg = jconfig.train_default()
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return jax.tree.map(np.asarray, jax.vmap(lambda k: jmdl.randomize(k, cfg))(keys))


@pytest.mark.parametrize("impulse_scale", [0.0, 400.0])
def test_plain_substep_matches_jax(impulse_scale):
    B = 16
    cfg = jconfig.test_default()
    jp = _random_params(B, 0)
    gc, gv, tau, bw = _states(B, 1)
    a = jlanes.substep(jlanes.params_to_lanes(jax.tree.map(jnp.asarray, jp)),
                       jnp.asarray(gc.T), jnp.asarray(gv.T), jnp.asarray(tau.T),
                       jnp.asarray(bw.T), cfg.contact_slip_vel, impulse_scale,
                       cfg.simulation_dt)
    P = tlanes.params_to_lanes(tmdl.robot_params_from_numpy(jp, "cpu"))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x.T))  # noqa: E731
    b = phys_cuda.substep(P, t(gc), t(gv), t(tau), t(bw), cfg.contact_slip_vel,
                          impulse_scale, cfg.simulation_dt)
    # the tolerances of the Pallas-vs-lanes test (test_phys_pallas.py:41-46):
    # the same f32 graph summed in another order
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), atol=1e-5)   # gc
    np.testing.assert_allclose(b[1].numpy(), np.asarray(a[1]), atol=1e-3)   # gv
    np.testing.assert_allclose(b[2].numpy(), np.asarray(a[2]), atol=1e-5)   # toe
    np.testing.assert_allclose(b[3].numpy(), np.asarray(a[3]), atol=1e-3)   # toe vel
    # force norms: fp-association noise on multi-newton magnitudes
    np.testing.assert_allclose(b[4].numpy(), np.asarray(a[4]), atol=5e-3, rtol=1e-4)
    np.testing.assert_allclose(b[5].numpy(), np.asarray(a[5]), atol=5e-3, rtol=1e-4)
    assert (np.asarray(a[5]) > 0).any(), "no toe in contact: the contact branch went untested"


@pytest.mark.parametrize("impulse_scale", [0.0, 400.0])
@pytest.mark.parametrize("motor_dynamics", [False, True])
def test_plain_control_step_matches_jax(motor_dynamics, impulse_scale):
    """cfg.substeps x {PD torque from the fresh state -> substep}: the port's
    control_step on the CPU (its plain version) against the JAX package's
    _pd_torque and phys_lanes.substep iterated as its step_batch does."""
    B = 8
    jcfg = jconfig.test_default().replace(motor_dynamics=motor_dynamics)
    tcfg = tconfig.test_default().replace(motor_dynamics=motor_dynamics)
    jp = _random_params(B, 3)
    gc, gv, _, bw = _states(B, 5)
    rng = np.random.default_rng(6)
    gv[:, 6:] *= 30.0   # joint speeds that reach the envelope's speed-dependent part
    pt = (gc[:, 7:] + 0.3 * rng.normal(size=(B, 12))).astype(np.float32)
    tnl = (0.5 * rng.normal(size=(B, 12))).astype(np.float32)

    jP = jlanes.params_to_lanes(jax.tree.map(jnp.asarray, jp))
    gcT, gvT = jnp.asarray(gc.T), jnp.asarray(gv.T)
    for _ in range(jcfg.substeps):
        tau = jbp._pd_torque(jcfg, jnp.asarray(pt), jnp.asarray(tnl), gcT[7:].T, gvT[6:].T)
        gcT, gvT, toe, toe_vel, fnorm, fn = jlanes.substep(
            jP, gcT, gvT, tau.T, jnp.asarray(bw.T), jcfg.contact_slip_vel, impulse_scale,
            jcfg.simulation_dt)
    want = (gcT, gvT, toe, toe_vel, fnorm, fn, tau.T)

    P = tlanes.params_to_lanes(tmdl.robot_params_from_numpy(jp, "cpu"))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x.T))  # noqa: E731
    got = phys_cuda.control_step(P, pd_torque.from_config(tcfg), t(gc), t(gv), t(pt), t(tnl),
                                 t(bw), tcfg.substeps, tcfg.contact_slip_vel, impulse_scale,
                                 tcfg.simulation_dt)
    assert tcfg.substeps == jcfg.substeps == 8
    assert (np.asarray(want[5]) > 0).any(), "no toe in contact: the contact branch went untested"
    # the single-substep tolerances, gv and the forces widened for 8 stiff substeps
    # that feed rounding back through the PD law (the step_batch-vs-JAX test's scale)
    for i, (atol, rtol) in enumerate(((1e-5, 0), (1e-2, 0), (1e-5, 0), (1e-2, 0), (5e-2, 1e-3),
                                      (5e-2, 1e-3), (2e-3, 0))):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), atol=atol, rtol=rtol,
                                   err_msg=f"output {i}")


def test_control_step_refuses_no_substeps():
    with pytest.raises(ValueError, match="n_substeps"):
        phys_cuda.control_step(None, None, torch.zeros(19, 1), None, None, None, None, 0, 0.1,
                               0.0, 2.5e-4)


def test_pack_params_matches_pallas_layout():
    """The kernel's (208, B) parameter rows are phys_pallas.pack_params'."""
    B = 5
    jp = _random_params(B, 2)
    want = jpallas.pack_params(jlanes.params_to_lanes(jax.tree.map(jnp.asarray, jp)), B)
    got = phys_cuda.pack_params(tlanes.params_to_lanes(tmdl.robot_params_from_numpy(jp, "cpu")))
    assert got.shape == (phys_cuda.P_ROWS, B)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("material", [None, (0.8, 0.2, 0.01)])
def test_nominal_params_match_jax(material):
    jc, tc = jconfig.test_default(), tconfig.test_default()
    if material is not None:
        f, e, th = material
        jc = jc.replace(contact_friction=f, contact_restitution=e, contact_res_threshold=th)
        tc = tc.replace(contact_friction=f, contact_restitution=e, contact_res_threshold=th)
    want = jmdl.nominal_params(jc)
    got = tmdl.nominal_params(tc, "cpu")
    for name in want._fields:
        # restitution-mapped damping: a log/sqrt chain evaluated by two libraries
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, err_msg=name)


def test_robot_params_from_numpy_roundtrip():
    jp = _random_params(3, 4)
    got = tmdl.robot_params_from_numpy(jp, "cpu")
    for name in jp._fields:
        x = getattr(got, name)
        assert x.dtype == torch.float32 and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), getattr(jp, name), err_msg=name)


def test_static_model_arrays_match_jax():
    for name in ("PARENT", "SHANK_BODY_IDX", "ROTOR_INERTIA", "BODY_BOX_HALF", "GEAR_RATIO",
                 "STAND_JOINT_POS", "EE_OFFSET"):
        np.testing.assert_array_equal(getattr(tmdl, name), np.asarray(getattr(jmdl, name)))
    np.testing.assert_array_equal(tmdl.JAXIS, np.asarray(jmdl.JAXIS))
    np.testing.assert_array_equal(tmdl.TORQUE_LIMIT_J, np.asarray(jmdl.TORQUE_LIMIT_J))
    for name in ("TOE_RADIUS", "TOE_OFFSET_Z", "JOINT_DAMPING", "KNEE_RATIO"):
        assert getattr(tmdl, name) == getattr(jmdl, name)
    np.testing.assert_allclose(tmdl.stand_gc(0.1), np.asarray(jmdl.stand_gc(0.1)), atol=1e-7)


def test_randomize_ranges():
    cfg = tconfig.train_default()
    gen = torch.Generator().manual_seed(0)
    p = tmdl.randomize(gen, cfg, 64, "cpu")
    nom = tmdl.nominal_params(cfg, "cpu")
    assert p.mass.shape == (64, 13) and p.inertia.shape == (64, 13, 3, 3)
    ratio = p.mass / nom.mass
    assert (ratio >= 1 - cfg.mass_disturbance_ratio).all()
    assert (ratio <= 1 + cfg.mass_disturbance_ratio).all()
    assert ((p.friction >= 0.4) & (p.friction <= 1.0)).all()
    assert ((p.restitution >= 0.0) & (p.restitution <= 0.3)).all()
    # only the knee joint origins move, by one shared draw per env
    d = p.joint_origin - nom.joint_origin
    assert torch.all(d[:, [0, 1, 3, 4, 6, 7, 9, 10]] == 0)
    assert torch.allclose(d[:, 2::3, 2], d[:, 2:3, 2].expand(64, 4))
    assert (d[:, 2, 2].abs() <= cfg.calf_disturbance).all()
    # the damping follows the drawn restitution as in JAX
    want = jmdl.damping_for_restitution(np.float32(cfg.contact_stiffness),
                                        np.float32(cfg.contact_damping), p.restitution.numpy())
    np.testing.assert_allclose(p.contact_damping.numpy(), np.asarray(want), rtol=1e-5)


def test_rotation_helpers_match_jax():
    rng = np.random.default_rng(8)
    a, b = (rng.normal(size=(16, 4)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(16, 3)).astype(np.float32)
    an = np.array(jrot.quat_normalize(a))
    t = torch.from_numpy
    np.testing.assert_allclose(trot.quat_normalize(t(a)).numpy(), an, atol=1e-6)
    np.testing.assert_allclose(trot.quat_to_matrix(t(an)).numpy(),
                               np.asarray(jrot.quat_to_matrix(an)), atol=1e-6)
    np.testing.assert_allclose(trot.quat_mul(t(a), t(b)).numpy(),
                               np.asarray(jrot.quat_mul(a, b)), atol=1e-5)
    np.testing.assert_allclose(trot.quat_rotate(t(an), t(v)).numpy(),
                               np.asarray(jrot.quat_rotate(an, v)), atol=1e-5)
