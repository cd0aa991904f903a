"""Profiling: device traces, step timing and memory figures.

Port of ``vln_magic_tpu/utils/profiling.py``, which replaces the
reference's wall-clock heuristics (reference: map_nav_src/utils/
logger.py:21-57 Timer/ETA; pretrain tok_per_s counters,
train_r2r_magic.py:464-584; pynvml GPU monitors, pretrain_src/data/
common.py:171-225).  Here the trace is ``torch.profiler``'s (a Chrome
trace, viewable in Perfetto), sub-regions are ``record_function``s, the
step timer synchronises the device around each step, and the memory
figures come from the CUDA caching allocator.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region (the host, and every CUDA device when
    there is one) and write its Chrome trace to ``log_dir/trace.json``.
    Yields
    the ``torch.profiler.profile``, whose ``key_averages()`` and events
    the caller may read after the region."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named sub-region inside a trace (shows in the timeline)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """A blocking step timer and running throughput (nav steps/s,
    items/s): the CUDA device, where there is one, is synchronised on
    entry and exit, so a step's time includes its queued kernels.  The
    first ``warmup`` steps are not counted."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self._t0 = None
        self._sync = (torch.cuda.synchronize if torch.cuda.is_available()
                      else (lambda: None))

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.total += dt
        return False

    @property
    def mean(self) -> float:
        n = max(self.count - self.warmup, 1)
        return self.total / n

    def throughput(self, units_per_step: float) -> float:
        return units_per_step / self.mean if self.mean > 0 else 0.0


def device_memory_stats() -> dict:
    """Per-device memory use, by device name, with JAX's keys: bytes in
    use, the peak since the last reset and the device's capacity (the
    pynvml monitor's counterpart).  Without a CUDA device: the CPU, with
    no figures, as JAX reports a device without memory statistics."""
    if not torch.cuda.is_available():
        return {"cpu": {}}
    out = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[str(torch.device("cuda", i))] = {
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i)
                               .total_memory),
        }
    return out
