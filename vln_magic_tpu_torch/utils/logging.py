"""Observability: record files, running meters, JSONL metrics, optional
tensorboard.

Covers the reference's logging surface (reference: map_nav_src/utils/
logger.py:8-80 write_to_record_file/Timer/progress; pretrain_src/utils/
logger.py:27-95 TensorboardLogger/RunningMeter; main_nav.py:371-430 scalar
logging) in one module.  A copy of ``vln_magic_tpu/utils/logging.py``
without its ``Timer`` (the program's spans are ``utils.profiling.span``),
except that with several processes only rank 0 writes.
"""

from __future__ import annotations

import json
import os

from .dist import is_primary


def write_to_record_file(data: str, file_path: str, verbose: bool = True):
    """Print ``data`` and append it to ``file_path``; with several
    processes only rank 0 does."""
    if not is_primary():
        return
    if verbose:
        print(data)
    with open(file_path, "a") as f:
        f.write(data + "\n")


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
        # with several processes only rank 0 writes
        self.primary = is_primary()
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self.meters = {}
        self.tb = None
        if tensorboard and self.primary:
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
        if self.primary:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    def close(self):
        if self.tb is not None:
            self.tb.close()
