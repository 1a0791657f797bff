"""Per-update training-metrics persistence (JSONL).

Port of ``utils/metrics.py``. The reference launches TensorBoard against the
logger directory (raisim_gym_helper.py:21-32, TensorboardLauncher); here it is
a metrics.jsonl in the run dir, one JSON object per PPO update: no daemon,
air-gap safe, and the raw numbers stay machine-readable.
"""

from __future__ import annotations

import json
import os


class JsonlLogger:
    """Append-only JSONL metrics writer; one dict per line, flushed."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f = open(path, "a", buffering=1)

    def write(self, metrics: dict) -> None:
        self._f.write(json.dumps({k: (float(v) if hasattr(v, "__float__") else v)
                                  for k, v in metrics.items()}) + "\n")

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_jsonl(path: str) -> list:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows
