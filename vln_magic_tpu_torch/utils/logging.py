"""Observability: record files, running meters, JSONL metrics, optional
tensorboard.

Covers the reference's logging surface (reference: map_nav_src/utils/
logger.py:8-80 write_to_record_file/Timer/progress; pretrain_src/utils/
logger.py:27-95 TensorboardLogger/RunningMeter; main_nav.py:371-430 scalar
logging) in one module.  A copy of ``vln_magic_tpu/utils/logging.py``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict


def write_to_record_file(data: str, file_path: str, verbose: bool = True):
    if verbose:
        print(data)
    with open(file_path, "a") as f:
        f.write(data + "\n")


class Timer:
    def __init__(self):
        self.t0 = time.time()
        self.acc = defaultdict(float)
        self._open = {}

    def tic(self, name):
        self._open[name] = time.time()

    def toc(self, name):
        self.acc[name] += time.time() - self._open.pop(name)

    def show(self):
        total = time.time() - self.t0
        parts = ", ".join(f"{k}: {v:.1f}s" for k, v in self.acc.items())
        return f"total {total:.1f}s ({parts})"


class RunningMeter:
    """Exponentially smoothed scalar (pretrain logger.py RunningMeter)."""

    def __init__(self, name, smooth=0.99):
        self.name = name
        self.smooth = smooth
        self.val = None

    def update(self, v):
        self.val = v if self.val is None else \
            self.val * self.smooth + v * (1 - self.smooth)
        return self.val


class MetricsLogger:
    """JSONL metrics stream + optional tensorboard (torch's SummaryWriter
    when importable, mirroring the reference's tensorboardX usage)."""

    def __init__(self, log_dir: str, tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self.meters = {}
        self.tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(log_dir)
            except Exception:
                self.tb = None

    def log(self, step: int, scalars: dict, smooth: bool = False):
        rec = {"step": step}
        for k, v in scalars.items():
            v = float(v)
            if smooth:
                m = self.meters.setdefault(k, RunningMeter(k))
                v = m.update(v)
            rec[k] = v
            if self.tb is not None:
                self.tb.add_scalar(k, v, step)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec

    def close(self):
        if self.tb is not None:
            self.tb.close()
