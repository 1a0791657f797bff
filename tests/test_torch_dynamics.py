"""PyTorch port: the per-env rigid-body dynamics against the JAX package.

``phys/spatial``, ``phys/contact`` (flat ground and the sampled heightmap),
every function of ``phys/dynamics`` and the clamped factorization of
``ops/linalg`` against jitted JAX on seeded numpy states, with randomized
``RobotParams`` carried across by ``phys/model.robot_params_from_numpy``;
then the physics properties of ``tests/test_dynamics.py`` on the port alone.

Tolerance: "float32 rounding" is held as max |port - JAX| <= RTOL *
max(1, max |JAX|) over each output; the two sides sum in other orders
(einsum paths, the factorization's solves), which costs a few ulp of the
largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import linalg as tlinalg
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import contact as tct
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import dynamics as tdyn
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as tmdl
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import spatial as tsp
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import terrain as ttr
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import rotation as trot
from high_speed_quadrupedal_locomotion_by_irrl_tpu import config as jconfig
from high_speed_quadrupedal_locomotion_by_irrl_tpu.ops import linalg as jlinalg
from high_speed_quadrupedal_locomotion_by_irrl_tpu.phys import contact as jct
from high_speed_quadrupedal_locomotion_by_irrl_tpu.phys import dynamics as jdyn
from high_speed_quadrupedal_locomotion_by_irrl_tpu.phys import model as jmdl
from high_speed_quadrupedal_locomotion_by_irrl_tpu.phys import spatial as jsp
from high_speed_quadrupedal_locomotion_by_irrl_tpu.phys import terrain as jtr
from high_speed_quadrupedal_locomotion_by_irrl_tpu.utils import rotation as jrot

torch.set_num_threads(1)

RTOL = 2e-6      # float32 rounding of the largest entry, a few ulp
B = 6


def _close(got, want, rtol: float = RTOL, what: str = "") -> None:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(want).all(), what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: max |err| {err:.3g} x {scale:.3g} > rtol {rtol}"


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def _states(seed: int, z: float = 0.3, n: int = B):
    """n states near the stand pose, toes in and out of the ground."""
    rng = np.random.default_rng(seed)
    gc = np.zeros((n, 19))
    gc[:, :2] = rng.uniform(-0.5, 0.5, (n, 2))
    gc[:, 2] = z + rng.uniform(-0.03, 0.03, n)
    q = np.array([1.0, 0.0, 0.0, 0.0]) + rng.normal(0.0, 0.15, (n, 4))
    gc[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    gc[:, 7:] = tmdl.STAND_JOINT_POS + rng.uniform(-0.3, 0.3, (n, 12))
    gv = rng.uniform(-1.0, 1.0, (n, 18))
    tau = rng.uniform(-10.0, 10.0, (n, 12))
    wrench = rng.uniform(-20.0, 20.0, (n, 6))
    return [a.astype(np.float32) for a in (gc, gv, tau, wrench)]


def _params(seed: int, n: int = B):
    """n randomized JAX RobotParams, and the same on the port's side."""
    cfg = jconfig.train_default()
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    jp = jax.vmap(lambda k: jmdl.randomize(k, cfg))(keys)
    return jp, tmdl.robot_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _jax_terrain(seed: int, n: int = B, z_scale: float = 0.08):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    jt = jax.vmap(lambda k: jtr.sampled_fractal(k, z_scale))(keys)
    return jt, ttr.at_offsets(_t(jt.offset), z_scale)


# --- spatial, rotation, linalg ---------------------------------------------------

def test_spatial_algebra_matches_jax():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(2, 7, 6)).astype(np.float32)
    m, c = rng.uniform(0.1, 4.0, 7).astype(np.float32), rng.normal(size=(7, 3)).astype(np.float32)
    I = rng.normal(size=(7, 3, 3)).astype(np.float32)
    I = I @ np.swapaxes(I, -1, -2)
    p = rng.normal(size=(7, 3)).astype(np.float32)
    _close(tsp.skew(_t(c)), jsp.skew(c), what="skew")
    _close(tsp.spatial_inertia(_t(m), _t(c), _t(I)), jsp.spatial_inertia(m, c, I),
           what="spatial_inertia")
    _close(tsp.cross_motion(_t(a), _t(b)), jsp.cross_motion(a, b), what="cross_motion")
    _close(tsp.cross_force(_t(a), _t(b)), jsp.cross_force(a, b), what="cross_force")
    _close(tsp.force_at_point(_t(a[:, 3:]), _t(p)), jsp.force_at_point(a[:, 3:], p),
           what="force_at_point")
    _close(tsp.point_velocity(_t(a), _t(p)), jsp.point_velocity(a, p), what="point_velocity")
    q = rng.normal(size=(7, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w = rng.normal(size=(7, 3)).astype(np.float32) * 5.0
    w[0] = 0.0   # the zero-rate branch
    _close(trot.quat_integrate(_t(q), _t(w), 0.001), jrot.quat_integrate(q, w, 0.001),
           what="quat_integrate")


def _spd(rng, n: int, k: int) -> np.ndarray:
    A = rng.normal(size=(k, n, n)).astype(np.float32)
    return (A @ np.swapaxes(A, -1, -2) + n * np.eye(n, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("n", [12, 18])
def test_cholesky_unrolled_and_inv_spd_match_jax(n):
    rng = np.random.default_rng(n)
    M = _spd(rng, n, 4)
    b = rng.normal(size=(4, n, 3)).astype(np.float32)
    L = tlinalg.cholesky_unrolled(_t(M))
    _close(L, jax.vmap(jlinalg.cholesky_unrolled)(M), what="cholesky_unrolled")
    _close(tlinalg.solve_cholesky(L, _t(b)), jax.vmap(jlinalg.solve_spd)(M, b), rtol=2e-5,
           what="solve_cholesky")
    _close(tlinalg.inv_spd(_t(M)), jax.vmap(jlinalg.inv_spd)(M), rtol=2e-5, what="inv_spd")


def test_cholesky_unrolled_clamps_an_indefinite_pivot_like_jax():
    """An indefinite matrix does not raise (torch.linalg.cholesky would): the
    pivot is clamped to sqrt(1e-12) as in the JAX package, and what follows is
    huge but finite and the same on both sides (relative 1e-5)."""
    M = np.diag([2.0, -1.0, 3.0, 0.5]).astype(np.float32)
    M[0, 1] = M[1, 0] = 0.3
    M[2, 3] = M[3, 2] = 0.2
    b = np.arange(1.0, 5.0, dtype=np.float32)[:, None]
    L = tlinalg.cholesky_unrolled(_t(M)[None])[0]
    Lj = np.asarray(jlinalg.cholesky_unrolled(M))
    assert float(L[1, 1]) == pytest.approx(1e-6)
    _close(L, Lj, what="clamped factor")
    x = tlinalg.solve_cholesky(L[None], _t(b)[None])[0]
    xj = np.asarray(jlinalg.solve_spd(M, b))
    assert np.abs(xj).max() > 1e10 and np.isfinite(xj).all()
    _close(x, xj, rtol=1e-5, what="solve through the clamped factor")
    with pytest.raises(torch.linalg.LinAlgError):
        tlinalg.solve_spd(_t(M), _t(b))


# --- contact -----------------------------------------------------------------------

@pytest.mark.parametrize("impulse_scale", [0.0, 400.0])
@pytest.mark.parametrize("ground", ["flat", "sampled"])
def test_point_contact_force_matches_jax(impulse_scale, ground):
    rng = np.random.default_rng(3)
    pos = np.concatenate([rng.uniform(-1.0, 1.0, (B, 5, 2)),
                          rng.uniform(-0.08, 0.06, (B, 5, 1))], -1).astype(np.float32)
    vel = rng.uniform(-1.0, 1.0, (B, 5, 3)).astype(np.float32)
    kn, dn, mu = (rng.uniform(2e4, 4e4, B).astype(np.float32),
                  rng.uniform(500.0, 1500.0, B).astype(np.float32),
                  rng.uniform(0.4, 1.0, B).astype(np.float32))
    if ground == "flat":
        jt, tt = jtr.flat(), None
        fj = jax.vmap(lambda p, v, k, d, f: jct.point_contact_force(
            p, v, 0.0275, jt, k, d, f, 0.1, impulse_scale))
    else:
        jt, tt = _jax_terrain(5)
        fj = jax.vmap(lambda p, v, k, d, f, t: jct.point_contact_force(
            p, v, 0.0275, t, k, d, f, 0.1, impulse_scale))
    want = fj(pos, vel, kn, dn, mu) if tt is None else fj(pos, vel, kn, dn, mu, jt)
    got = tct.point_contact_force(_t(pos), _t(vel), 0.0275, tt, _t(kn)[:, None], _t(dn)[:, None],
                                  _t(mu)[:, None], 0.1, impulse_scale)
    assert float(want[1].max()) > 0 and float(want[1].min()) == 0   # both sides of contact
    rtol = RTOL if ground == "flat" else 2e-5   # the normal's central differences
    for g, w, name in zip(got, want, ("force", "normal force")):
        _close(g, w, rtol, name)
    R = jax.vmap(jrot.quat_to_matrix)(jnp.asarray(_states(4)[0][:, 3:7]))
    p0 = pos[:, 0]
    _close(tct.box_corner_points(_t(R), _t(p0)), jax.vmap(jct.box_corner_points)(R, p0),
           what="box corners")


# --- dynamics ----------------------------------------------------------------------

def _jax_kin(jp, gc):
    return jax.jit(jax.vmap(jdyn.fk))(jp, gc)


def test_fk_and_body_quantities_match_jax():
    jp, tp = _params(7)
    gc, gv, _, _ = _states(7)
    kin_j = _jax_kin(jp, gc)
    kin_t = tdyn.fk(tp, _t(gc))
    for f in tdyn.Kinematics._fields:
        _close(getattr(kin_t, f), getattr(kin_j, f), what=f"fk.{f}")
    _close(tdyn.body_velocities(kin_t, _t(gv)),
           jax.vmap(jdyn.body_velocities)(kin_j, gv), what="body_velocities")
    _close(tdyn.spatial_inertias(tp, kin_t), jax.vmap(jdyn.spatial_inertias)(jp, kin_j),
           what="spatial_inertias")
    _close(tdyn.mass_matrix(tp, kin_t), jax.vmap(jdyn.mass_matrix)(jp, kin_j),
           what="mass_matrix")
    f_ext = np.random.default_rng(8).normal(0.0, 5.0, (B, 13, 6)).astype(np.float32)
    _close(tdyn.bias_forces(tp, kin_t, _t(gv), _t(f_ext)),
           jax.vmap(jdyn.bias_forces)(jp, kin_j, gv, f_ext), what="bias_forces")
    _close(tdyn.nonlinearities(tp, _t(gc), _t(gv)),
           jax.vmap(jdyn.nonlinearities)(jp, gc, gv), what="nonlinearities")
    _close(tdyn.inverse_mass_matrix(tp, _t(gc)),
           jax.vmap(jdyn.inverse_mass_matrix)(jp, gc), rtol=2e-5, what="inverse_mass_matrix")


def test_dynamics_leading_dims_and_shared_params():
    """Two leading dims against per-robot params (B, ...), and one robot for
    all, give what one dim gives."""
    jp, tp = _params(9)
    gc, gv, _, _ = _states(9)
    g2 = np.stack([gc, gc[::-1]])
    M = tdyn.mass_matrix(tp, tdyn.fk(tp, _t(gc)))
    M2 = tdyn.mass_matrix(tp, tdyn.fk(tp, _t(g2)))
    assert torch.equal(M2[0], M)
    nominal = tmdl.nominal_params(device="cpu")
    h = tdyn.nonlinearities(nominal, _t(gc), _t(gv))
    h_b = tdyn.nonlinearities(nominal.expand(B), _t(gc), _t(gv))
    assert torch.equal(h, h_b)


@pytest.mark.parametrize("ground", ["flat", "sampled"])
def test_contact_wrenches_match_jax(ground):
    jp, tp = _params(11)
    gc, gv, _, _ = _states(11, z=0.29)
    jt, tt = (jtr.flat(), None) if ground == "flat" else _jax_terrain(11)
    kin_j, kin_t = _jax_kin(jp, gc), tdyn.fk(tp, _t(gc))
    in_axes = (0, 0, 0, None) if tt is None else (0, 0, 0, 0)
    want = jax.vmap(lambda p, k, v, t: jdyn.contact_wrenches(p, k, v, t, 0.1),
                    in_axes=in_axes)(jp, kin_j, gv, jt)
    got = tdyn.contact_wrenches(tp, kin_t, _t(gv), tt, 0.1)
    assert float(want[2].max()) > 0
    rtol = RTOL if ground == "flat" else 2e-5
    for g, w, name in zip(got, want, ("f_ext", "toe |f|", "toe fn", "toe vel")):
        _close(g, w, rtol, name)


@pytest.mark.parametrize("solver", ["unrolled", "native"])
def test_forward_dynamics_and_integrate_match_jax(solver):
    jp, tp = _params(13)
    gc, gv, tau, wrench = _states(13, z=0.29)
    f_extra = np.random.default_rng(14).normal(0.0, 3.0, (B, 13, 6)).astype(np.float32)
    qdd_j, diag_j = jax.jit(jax.vmap(lambda p, g, v, t, w, f: jdyn.forward_dynamics(
        p, g, v, t, w, jtr.flat(), 0.1, solver=solver, f_ext_extra=f)))(
        jp, gc, gv, tau, wrench, f_extra)
    qdd_t, diag_t = tdyn.forward_dynamics(tp, _t(gc), _t(gv), _t(tau), _t(wrench), None, 0.1,
                                          solver=solver, f_ext_extra=_t(f_extra))
    # qdd: a solve with the mass matrix (condition ~1e4) of contact forces of ~1e3 N
    _close(qdd_t, qdd_j, rtol=2e-5, what="qdd")
    for f in tdyn.StepDiagnostics._fields:
        _close(getattr(diag_t, f), getattr(diag_j, f), what=f"diag.{f}")
    gc2_j, gv2_j = jax.vmap(lambda g, v, a: jdyn.integrate(g, v, a, 0.001))(gc, gv, qdd_j)
    gc2_t, gv2_t = tdyn.integrate(_t(gc), _t(gv), _t(qdd_j), 0.001)
    _close(gc2_t, gc2_j, what="integrate gc")
    _close(gv2_t, gv2_j, what="integrate gv")


def test_forward_dynamics_on_sampled_terrain_matches_jax():
    jp, tp = _params(15)
    gc, gv, tau, wrench = _states(15, z=0.29)
    jt, tt = _jax_terrain(15)
    qdd_j, _ = jax.jit(jax.vmap(lambda p, g, v, t, w, tp_: jdyn.forward_dynamics(
        p, g, v, t, w, tp_, 0.1, solver="native", impulse_scale=300.0)))(
        jp, gc, gv, tau, wrench, jt)
    qdd_t, _ = tdyn.forward_dynamics(tp, _t(gc), _t(gv), _t(tau), _t(wrench), tt, 0.1,
                                     solver="native", impulse_scale=300.0)
    _close(qdd_t, qdd_j, rtol=1e-4, what="qdd on terrain")


@pytest.mark.parametrize("terrain", [False, True])
def test_substep_hard_matches_jax(terrain):
    """One hard-contact substep (PGS warm-started, the attack spheres' extra
    wrenches, randomized restitution) against JAX's: gc within 1e-5, gv and
    the impulses within 1e-4."""
    jp, tp = _params(16)
    gc, gv, tau, wrench = _states(16, z=0.29)
    rng = np.random.default_rng(16)
    extra = rng.uniform(-5.0, 5.0, (B, 13, 6)).astype(np.float32)
    lam0 = (1e-3 * np.abs(rng.normal(size=(B, 4, 3)))).astype(np.float32)
    jt, tt = _jax_terrain(16) if terrain else (None, None)
    if terrain:
        want = jax.jit(jax.vmap(lambda p, g, v, t, w, tp_, e, l: jdyn.substep_hard(
            p, g, v, t, w, tp_, 2.5e-4, e, 12, l)))(jp, gc, gv, tau, wrench, jt, extra, lam0)
    else:
        want = jax.jit(jax.vmap(lambda p, g, v, t, w, e, l: jdyn.substep_hard(
            p, g, v, t, w, jtr.flat(), 2.5e-4, e, 12, l)))(jp, gc, gv, tau, wrench, extra, lam0)
    gc2, gv2, diag, lam = tdyn.substep_hard(tp, _t(gc), _t(gv), _t(tau), _t(wrench), tt, 2.5e-4,
                                            _t(extra), 12, _t(lam0))
    _close(gc2, want[0], rtol=1e-5, what="gc")
    _close(gv2, want[1], rtol=1e-4, what="gv")
    _close(lam, want[3], rtol=1e-4, what="lam")
    _close(diag.toe_vel, want[2].toe_vel, rtol=1e-4, what="toe_vel")
    assert (np.asarray(want[3])[..., 0] > 0).any(), "no contact: the impulse solve went untested"


# --- the physics properties of tests/test_dynamics.py, on the port ---------------------

def _nominal():
    return tmdl.nominal_params(device="cpu")


def test_mass_matrix_spd_and_total_mass():
    p = _nominal()
    gc, _, _, _ = _states(21, z=0.6)
    M = tdyn.mass_matrix(p, tdyn.fk(p, _t(gc))).double()
    torch.testing.assert_close(M, M.transpose(-1, -2), atol=1e-5, rtol=0)
    assert float(torch.linalg.eigvalsh(M).min()) > 0
    total = float(p.mass.sum())
    torch.testing.assert_close(M[:, :3, :3], total * torch.eye(3, dtype=M.dtype).expand(B, 3, 3),
                               atol=1e-5, rtol=0)
    assert abs(total - 9.0) < 0.2


def test_kinetic_energy_consistency():
    p = _nominal()
    gc, gv, _, _ = _states(22, z=0.6)
    kin = tdyn.fk(p, _t(gc))
    rotor = torch.diag(torch.cat([torch.zeros(6), _t(tmdl.ROTOR_INERTIA)]))
    M = tdyn.mass_matrix(p, kin) - rotor
    v = tdyn.body_velocities(kin, _t(gv))
    ke_bodies = 0.5 * torch.einsum("nbp,nbpq,nbq->n", v, tdyn.spatial_inertias(p, kin), v)
    ke_joint = 0.5 * torch.einsum("nd,nde,ne->n", _t(gv), M, _t(gv))
    torch.testing.assert_close(ke_joint, ke_bodies, rtol=1e-4, atol=0)


def test_gravity_vector_and_free_fall():
    p = _nominal()
    gc, _, _, _ = _states(23, z=5.0)
    zero = torch.zeros(B, 18)
    h = tdyn.nonlinearities(p, _t(gc), zero)
    total = float(p.mass.sum())
    torch.testing.assert_close(h[:, :3], torch.tensor([0.0, 0.0, 9.81 * total]).expand(B, 3),
                               rtol=1e-4, atol=1e-4)
    qdd, _ = tdyn.forward_dynamics(p, _t(gc), zero, torch.zeros(B, 12), torch.zeros(6))
    kin = tdyn.fk(p, _t(gc))
    anc = _t(tmdl.ANC_MASK)
    a = torch.einsum("npd,bd,nd->nbp", kin.S, anc, qdd)
    acc_com = a[..., 3:] + torch.cross(a[..., :3], kin.com_w, dim=-1)
    com_acc = (p.mass[:, None] * acc_com).sum(1) / p.mass.sum()
    torch.testing.assert_close(com_acc, torch.tensor([0.0, 0.0, -9.81]).expand(B, 3),
                               atol=1e-3, rtol=0)


def test_momentum_conservation_zero_gravity():
    """Internal joint torques cannot change total spatial momentum (gravity
    cancelled, no contact)."""
    p = _nominal()
    gc, gv, tau, _ = _states(24, z=50.0, n=2)
    gc, gv, tau = _t(gc), _t(gv), _t(tau) * 0.5
    grav = torch.tensor(tdyn.GRAVITY)

    def momentum(gc, gv):
        kin = tdyn.fk(p, gc)
        return torch.einsum("nbpq,nbq->np", tdyn.spatial_inertias(p, kin),
                            tdyn.body_velocities(kin, gv))

    m0 = momentum(gc, gv)
    for _ in range(200):
        kin = tdyn.fk(p, gc)
        f_grav = tsp.force_at_point(grav * p.mass[:, None], kin.com_w)
        h = tdyn.bias_forces(p, kin, gv, -f_grav)
        qdd = torch.linalg.solve(tdyn.mass_matrix(p, kin),
                                 torch.cat([torch.zeros(2, 6), tau], -1) - h)
        gc, gv = tdyn.integrate(gc, gv, qdd, 1e-4)
    torch.testing.assert_close(momentum(gc, gv), m0, atol=2e-2, rtol=0)


def test_standing_equilibrium():
    """PD toward the stand pose settles near stand height without NaNs (1 s
    of 4 kHz substeps on flat ground)."""
    p = _nominal()
    gc = torch.tensor(tmdl.stand_gc(), dtype=torch.float32)[None].clone()
    gc[:, 2] = 0.301
    gv = torch.zeros(1, 18)
    target = _t(tmdl.STAND_JOINT_POS)
    limit = _t(tmdl.TORQUE_LIMIT)
    for _ in range(4000):
        tau = torch.clamp(40.0 * (target - gc[:, 7:]) - 1.0 * gv[:, 6:], -limit, limit)
        qdd, _ = tdyn.forward_dynamics(p, gc, gv, tau, torch.zeros(6))
        gc, gv = tdyn.integrate(gc, gv, qdd, 0.00025)
    assert torch.isfinite(gc).all()
    assert 0.25 < float(gc[0, 2]) < 0.33, f"settled z={float(gc[0, 2])}"
    assert float(gv.abs().max()) < 0.5


def test_dynamics_entry_points_take_the_config_robot():
    """nominal_params(cfg) on the CPU drives the dense step (the MPC model's
    robot) without a device argument anywhere below it."""
    cfg = tconfig.test_default()
    p = tmdl.nominal_params(cfg, device="cpu")
    gc, gv, tau, wrench = _states(25)
    qdd, diag = tdyn.forward_dynamics(p, _t(gc), _t(gv), _t(tau), _t(wrench), None,
                                      cfg.contact_slip_vel)
    assert qdd.shape == (B, 18) and diag.toe_pos.shape == (B, 4, 3)
    assert torch.isfinite(qdd).all()
