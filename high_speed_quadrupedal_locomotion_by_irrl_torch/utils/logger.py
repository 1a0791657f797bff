"""Training metrics logging.

Port of ``utils/logger.py``: replaces the reference's stable-baselines
`logger.logkv` table + TensorBoard summaries (ppo2.py:177-231, :419-435) with
a JSONL metrics stream (one line per update) plus the same human-readable
console table.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping, Optional


class MetricsLogger:
    def __init__(self, run_dir: Optional[str] = None, echo: bool = True):
        self.echo = echo
        self._f = None
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self._f = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: Mapping[str, float]) -> None:
        rec = {"step": step, "wall_s": round(time.time() - self._t0, 3),
               **{k: (float(v) if hasattr(v, "__float__") else v)
                  for k, v in metrics.items()}}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self.echo:
            body = " | ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                              for k, v in rec.items() if k != "step")
            print(f"[{step}] {body}")

    def close(self) -> None:
        if self._f:
            self._f.close()
