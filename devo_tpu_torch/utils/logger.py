"""Training logger (the port's own copy of devo_tpu/utils/logger.py, after
upstream DEVO's devo/logger.py): running means flushed every SUM_FREQ
steps, to TensorBoard event files where `tensorboard` imports and to a
JSONL metric log otherwise.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

SUM_FREQ = 100


class Logger:
    def __init__(self, name: str, total_steps: int = 0, logdir: str = "runs"):
        self.total_steps = total_steps
        self.running: Dict[str, float] = {}
        self.path = os.path.join(logdir, name)
        os.makedirs(self.path, exist_ok=True)
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._writer = SummaryWriter(self.path)
        except Exception:
            self._jsonl = open(os.path.join(self.path, "metrics.jsonl"), "a")

    def _write(self, metrics: Dict[str, float], step: int):
        if self._writer is not None:
            for k, v in metrics.items():
                self._writer.add_scalar(k, v, step)
        else:
            self._jsonl.write(json.dumps({"step": step, "t": time.time(), **metrics}) + "\n")
            self._jsonl.flush()

    def push(self, metrics: Dict[str, float]):
        self.total_steps += 1
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
        if self.total_steps % SUM_FREQ == 0:
            means = {k: v / SUM_FREQ for k, v in self.running.items()}
            self._write(means, self.total_steps)
            self.running = {}

    def write_dict(self, metrics: Dict[str, float]):
        self._write(metrics, self.total_steps)

    def close(self):
        """Flush tail metrics: SummaryWriter's event writer only flushes
        every flush_secs (120 s default), so a run that exits without this
        can lose its final scalars — including the last validation ATE."""
        if self._writer is not None:
            self._writer.flush()
            self._writer.close()
        elif getattr(self, "_jsonl", None) is not None:
            self._jsonl.close()
            self._jsonl = None

    def __del__(self):  # best-effort on interpreter exit / crash paths
        try:
            self.close()
        except Exception:
            pass
