"""PyTorch (aten) ops the host issues a control step of the MPC loop (the
problem, the solve, the torque map, the gait reference, ``step_batch``, the
log): a 16-step rollout's less an 8-step one's, over 8."""

LAYER = ("MPC host dispatch: mpc/runtime.mpc_rollout, mpc/srb.solve, "
         "envs/blackpanther.step_batch")
SOURCE, MOVES = "program_counter", "mpc_robot_steps_per_s"


def read(obs):
    return obs["ops"].get("control_step")
