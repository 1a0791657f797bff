"""``phys_control_step_kernel`` against its bound in the profiled rollout:
the frozen operations and bytes of a launch at the sweep's size
(``counts/phys.py``) over the device time the profiler gives it."""

from irrl_bench.core import readings

LAYER = "physics kernel: phys_control_step_kernel (csrc/phys_substep.cu)"
SOURCE, MOVES = "device_trace", "eval_env_steps_per_s"


def read(obs):
    return readings.roofline(obs, "phys_control_step_kernel", obs["work"].get("phys_kernel"))
