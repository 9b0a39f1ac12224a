"""Metrics logging to stdout and a JSONL file (counterpart of `trafficbotsv15_tpu/utils/logging.py`).

Metrics stream to a JSONL file that any dashboard can tail, under the JAX
package's namespaces (training/*, reactive_replay/*, joint_future_pred/*, ...).
Over several ranks only rank 0 writes and echoes: the metrics a rank logs are
global (`parallel/mesh.py`), the same on every rank.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

from trafficbotsv15_tpu_torch.parallel.mesh import process_index


class MetricsLogger:
    def __init__(self, path: Optional[str] = "metrics.jsonl", echo: bool = True):
        rank0 = process_index() == 0
        self.path = Path(path) if path and rank0 else None
        self.echo = echo and rank0
        self.t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float]):
        rec = {"step": step, "t": round(time.time() - self.t0, 2), **metrics}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec, default=float) + "\n")  # numpy scalars slip into metric dicts
        if self.echo:
            parts = " ".join(f"{k}={v:.4g}" for k, v in metrics.items() if isinstance(v, (int, float)))
            print(f"[step {step}] {parts}", flush=True)
