"""Operations and bytes of one physics control step, counted on the
algorithm, whatever implements it.

A frozen copy of ``chip_smoke.phys_ops_per_env`` (flat ground): a multiply,
an add and a compare count one each (a fused multiply-add two), as do a
square root, a division, a sine, a cosine and a tanh; composite RNEA and CRBA
about the world origin and the leg-first solve of the block-arrow mass
matrix, the base body's terms and the 6x6 solve taken once an env. The bytes
are the kernel's inputs read once and its outputs written once.
"""

PARAM_ROWS = 13 + 39 + 117 + 36 + 3   # mass, com, inertia, joint origins, friction, kn, dn
STATE_ROWS = 19 + 18
OUT_ROWS = 19 + 18 + 12 + 12 + 4 + 4 + 12   # state, toes, toe velocities, |f|, fn, torque


def ops_per_env(n_substeps: int, pd_law: bool = True, motor_dynamics: bool = False,
                convert2torque: bool = False) -> int:
    cross, dot6 = 9, 11
    si_apply = 2 * cross + 18 + 6
    project = cross + 3
    contact = 24
    body = 18 + 105 + 2 * si_apply + 3 * cross + 17
    leg = (43 + 46 + 46
           + 6 + 3 * cross
           + 3 * (3 * cross + 27)
           + cross + 3 + contact + cross + 6
           + 2 * (18 + cross + 3 + contact + 2 + cross + 6)
           + 3 * (body + 16)
           + 22 + project
           + 6 * (si_apply + project) + 3 * cross
           + 3 * (dot6 + si_apply + 1 + project) + 6 * dot6
           + 20 + 6 * 9 + 18
           + 21 * 8 + 6 * 9
           + 3 * 12 + 9
           + 12)
    base = 39 + 21 + body + 2 * cross + 103 + 36 + 36 + 18 + 56
    pd_joint = (7 + 14 + (22 if motor_dynamics else 0)) if pd_law else 0
    # the Convert2Torque inputs: a multiply and an add more a joint and substep
    c2t = 12 * 2 if convert2torque else 0
    return n_substeps * (4 * leg + base + 12 * pd_joint + c2t)


def bytes_per_env(convert2torque: bool = False) -> int:
    """Parameters, state, PD targets, last torques, base wrench (and the
    Convert2Torque inputs) read; the outputs written; float32."""
    rows = PARAM_ROWS + STATE_ROWS + 12 + 12 + 6 + OUT_ROWS + (24 if convert2torque else 0)
    return 4 * rows
