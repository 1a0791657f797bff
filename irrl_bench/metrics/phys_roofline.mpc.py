"""``phys_control_step_kernel`` (the Convert2Torque instantiation) against its
bound: the frozen operations and bytes of a launch at the fleet's size
(``counts/phys.py``) over the device time the profiler gives it."""

from irrl_bench.core import readings

LAYER = "physics kernel: phys_control_step_kernel (csrc/phys_substep.cu)"
SOURCE, MOVES = "device_trace", "mpc_robot_steps_per_s"


def read(obs):
    return readings.roofline(obs, "phys_control_step_kernel", obs["work"].get("phys_kernel"))
