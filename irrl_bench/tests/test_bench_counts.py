"""The frozen counts of work hold the figures the repository's kernel table
records, so the rooflines read the same work whatever later implements it."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from irrl_bench.counts import lstm, peaks, phys, srb  # noqa: E402


def test_physics_control_step_at_1024():
    assert round(1024 * phys.ops_per_env(8) / 1e5) / 10 == 83.6      # 83.6 M ops
    assert round(1024 * phys.bytes_per_env() / 1e4) / 100 == 1.46     # 1.46 MB
    assert phys.ops_per_env(8, convert2torque=True) == phys.ops_per_env(8) + 8 * 24
    assert phys.bytes_per_env(convert2torque=True) == phys.bytes_per_env() + 4 * 24


def test_lstm_pair_and_sequence():
    assert round(1024 * lstm.pair_ops(35, 48) / 1e5) / 10 == 67.1
    assert round(1024 * lstm.pair_ops(48, 48) / 1e5) / 10 == 77.4
    assert round(lstm.seq_forward_ops(750, 1024, 35, 48) / 1e8) / 10 == 50.4
    assert round(lstm.seq_forward_ops(750, 1024, 48, 48) / 1e8) / 10 == 58.0
    # the bounds of the kernel table: 0.7516 / 0.8660 ms forward, by operations
    assert abs(peaks.bound_s(lstm.seq_forward_ops(750, 1024, 35, 48),
                             lstm.seq_forward_bytes(750, 1024, 35, 48)) - 0.7516e-3) < 1e-7
    assert abs(peaks.bound_s(lstm.seq_backward_ops(750, 1024, 35, 48, False),
                             lstm.seq_backward_bytes(750, 1024, 35, 48, False)) - 0.8816e-3) < 1e-7
    assert abs(peaks.bound_s(lstm.seq_backward_ops(750, 1024, 48, 48, True),
                             lstm.seq_backward_bytes(750, 1024, 48, 48, True)) - 0.9697e-3) < 1e-7


def test_srb_knot_matches_chip_smoke():
    assert srb.riccati_ops() == 32310
    try:
        import chip_smoke
    except Exception:   # its imports need what only some machines have
        return
    assert srb.riccati_ops() == chip_smoke.riccati_flops()


def test_update_is_some_13_tera_ops():
    ops = lstm.update_ops(750, 4096, 10, 35, (48, 48), 12, phys.ops_per_env(8))
    assert 12.5e12 < ops < 13.5e12
    towers = 2 * (83 * 192 + 192 + 96 * 192 + 192)
    assert lstm.n_params(35, (48, 48), 12) == towers + 48 * 12 + 24 + 49
