"""The sequence kernels' share of their bound in the profiled update:
``lstm_seq_train_kernel`` and ``lstm_seq_bwd_kernel`` of every layer and
epoch, the frozen operations and bytes of each launch (``counts/lstm.py``)
against the device time the profiler gives them."""

from irrl_bench.core import readings
from irrl_bench.counts import peaks

LAYER = ("LSTM sequence kernels: lstm_seq_train_kernel, lstm_seq_bwd_kernel "
         "(csrc/lstm_cell.cu)")
SOURCE, MOVES = "device_trace", "train_env_steps_per_s"


def read(obs):
    seq = obs["work"].get("seq_kernels")
    fwd = readings.kernel_seconds(obs, "lstm_seq_train_kernel")
    bwd = readings.kernel_seconds(obs, "lstm_seq_bwd_kernel")
    if not seq or fwd is None or bwd is None:
        return None
    epochs = obs["work"]["epochs"]
    bound = epochs * sum(peaks.bound_s(ops, nbytes) for ops, nbytes in seq.values())
    return 100.0 * bound / (fwd[0] + bwd[0])
