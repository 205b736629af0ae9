"""Structured metrics (port of diff_qp_mpc_tpu.utils.metrics): JSON lines
always, TensorBoard when it imports."""
from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    def __init__(self, logdir: str, name: str = "metrics"):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, f"{name}.jsonl"), "a")
        try:  # tensorboard is optional
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(logdir)
        except ImportError:
            self._tb = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps(
            {"t": time.time(), "step": step, tag: float(value)}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
