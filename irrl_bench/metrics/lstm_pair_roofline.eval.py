"""``lstm_cell_pair_kernel`` (both towers' layer a launch, two launches a
step) against its bound in the profiled rollout: the frozen operations and
bytes of each layer's launch (``counts/lstm.py``) over the device time."""

from irrl_bench.core import readings

LAYER = "LSTM pair kernel: lstm_cell_pair_kernel (csrc/lstm_cell.cu)"
SOURCE, MOVES = "device_trace", "eval_env_steps_per_s"


def read(obs):
    return readings.roofline(obs, "lstm_cell_pair_kernel", obs["work"].get("pair_kernel"))
