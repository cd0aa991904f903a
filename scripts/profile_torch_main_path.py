"""Where one wave of the PyTorch port's main path spends its time on the card.

    python3 scripts/profile_torch_main_path.py

Builds the full-width MAGIC-S evaluation of ``chip_smoke.py`` (256 items,
bf16, the packed-attention kernel on), runs it once to warm up, then runs one
``Navigator.evaluate`` under ``torch.profiler`` and prints one JSON line: the
host wall time of the wave (without and under the profiler), the device time
summed over its kernels, the device's idle share (against the wall time
without the profiler), the number of kernel launches, the packed-attention
kernel's share, and the kernels that take the most device time.  Needs one
CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    if not torch.cuda.is_available():
        print("profile_torch_main_path: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    import chip_smoke

    card = chip_smoke.card_line()
    nav, items, _ = chip_smoke.build_main_path()
    nav.evaluate(items)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nav.evaluate(items)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0          # without the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        (avg, _), _ = nav.evaluate(items)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    by_name = defaultdict(lambda: [0, 0.0])
    intervals = []
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_name[e.name][0] += 1
        by_name[e.name][1] += dur
        intervals.append((e.time_range.start, e.time_range.end))
    device_us = sum(v[1] for v in by_name.values())
    busy_us = chip_smoke._busy_us(intervals)
    attn_us = sum(v[1] for k, v in by_name.items()   # both routes
                  if "packed_attention" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    print(json.dumps({
        "wall_ms": wall_s * 1e3,
        "profiled_wall_ms": profiled_s * 1e3,
        "device_kernel_ms": device_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / (wall_s * 1e3),
        "kernel_launches": len(kernels),
        "packed_attention_ms": attn_us / 1e3,
        "packed_attention_share_of_device": attn_us / device_us,
        "semantic_steps_per_s": avg["semantic_steps"] / wall_s,
        "top_kernels": [{"name": k[:120], "count": c, "ms": us / 1e3}
                        for k, (c, us) in top],
        "card": card}))


if __name__ == "__main__":
    main()
