"""Structured metrics logging.

Copy of ``moleculardiffusion_mivit_tpu/utils/metrics.py``: metrics stream
to JSONL, one record per event (``{"event": ..., "t": seconds since the
logger was made, ...}``), and optionally to stderr, so long runs are
inspectable while in flight and afterwards.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, stdout: bool = False):
        self.path = path
        self.stdout = stdout
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, event: str, **fields: Any) -> None:
        record: Dict[str, Any] = {
            "event": event,
            "t": round(time.time() - self._t0, 3),
            **fields,
        }
        line = json.dumps(record, default=float)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.stdout:
            print(line, file=sys.stderr)

    def cycle_callback(self):
        """A callback suitable for ``Experiment.run(callback=...)``."""

        def cb(cycle: int, avgs: Dict[str, float]):
            self.log("cycle", cycle=cycle, val_avg=avgs)

        return cb

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
