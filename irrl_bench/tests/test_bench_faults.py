"""The comparison that decides ``correct`` catches the faults each cell can
have. Each case drives a whole run of a cut-down cell on the CPU (the port's
plain versions in place of its kernels) with the timed path broken
underneath, and sees ``correct`` come out false; the same run unbroken comes
out true. The faults: a step that hands back its state unchanged, half of
the batch left out, the physics kernel leaving the last tenth of the envs
unstepped, an answer altered where it is produced. (No cell spans
chips, so none can leave out an exchange between them.)"""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

SMALL = {"bp5_train_4096": {"traffic": {"num_envs": 4, "n_steps": 8, "checked_steps": 3},
                            "workload": {"reference_block": 2}},
         "srb_fleet_8192": {"traffic": {"num_envs": 4, "n_steps": 6, "checked_steps": 3}},
         "bp5_eval_20480": {"traffic": {"num_envs": 4, "n_steps": 6, "checked_steps": 3}}}
CASES = [(cell, fault) for cell in SMALL for fault in
         (None, "unchanged", "half", "minority", "altered")]


def run_cell(cell: str, fault, seed: int = 2147483713) -> dict:
    argv = [sys.executable, os.path.join(HERE, "run.py"), "--workload", cell, "--seed",
            str(seed), "--seconds", "0.01", "--trace", "0", "--device", "cpu",
            "--override", json.dumps(SMALL[cell])]
    if fault:
        argv += ["--fault", fault]
    out = subprocess.run(argv, capture_output=True, text=True, cwd=ROOT, timeout=1200,
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell,fault", CASES)
def test_correct_comes_out_false_exactly_under_a_fault(cell, fault):
    line = run_cell(cell, fault)
    assert line["correct"] is (fault is None), line["checks"]
