"""Reading a profiled stretch: device kernels, busy time, launches, the
longest idle gaps and what the host was doing in them, and the packed
attention kernel's work against its roofline.

``bound``, ``busy_us`` and the kernel reading are frozen copies of
``chip_smoke.py``'s ``bound``, ``_busy_us`` and ``device_breakdown``: the
profiler's raw records (``kineto_results``) are read in memory, since
building its event tree takes minutes for a train step's 10^5 kernels and
a Chrome trace of them is very large.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM
PEAK_FLOPS = {torch.float32: 67e12,            # f32 outside the tensor cores
              torch.bfloat16: 989e12}          # dense bf16 tensor cores
SPAN_PREFIX = "portbench."


def bound(b, h, lq, lk, hd, dtype, sprel):
    """The least time of one packed-attention call, in ms, and its two
    parts: the bytes (each input read once, the output written once) over
    the memory rate, and the FLOPs (two products of 2*Lq*Lk*hd per batch
    row and head) over the peak rate of the inputs' type."""
    el = torch.finfo(dtype).bits // 8
    d = h * hd
    nbytes = el * b * (2 * lq * d + 2 * lk * d) + 4 * b * lk
    if sprel:
        nbytes += 4 * b * h * lq * lk
    flops = 4 * b * h * lq * lk * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, t_bytes * 1e3, t_ops * 1e3


def busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


@contextlib.contextmanager
def packed_shapes(calls: list):
    """Record the shape of every packed-attention call the model makes, at
    the model's boundary (``models.layers.packed_attention``): (B, H, Lq,
    Lk, hd, dtype, sprel) per call, whatever the kernel makes of it."""
    from vln_magic_tpu_torch.models import layers

    real = layers.packed_attention

    def recorded(q, k, v, mask_bias, sprel_bias=None, *, num_heads):
        calls.append((q.shape[0], num_heads, q.shape[1], k.shape[1],
                      q.shape[2] // num_heads, q.dtype,
                      sprel_bias is not None))
        return real(q, k, v, mask_bias, sprel_bias, num_heads=num_heads)

    layers.packed_attention = recorded
    try:
        yield calls
    finally:
        layers.packed_attention = real


class Profiled:
    """``with Profiled(device) as p:`` runs the block under
    ``torch.profiler`` (CPU and CUDA) and times it; ``p.read()`` then gives
    the stretch.  On a CPU device (the harness's own tests) the host's
    ``aten`` ops stand in for the device records."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        self._prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else []))
        self._prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.wall_s = time.perf_counter() - self.t0
        return self._prof.__exit__(*exc)

    def read(self, top: int = 10) -> dict:
        """Kernels (name, start, end in us), launches, busy seconds, the
        ``top`` kernels by device time and the ``top`` longest idle gaps,
        each named by the harness span and the innermost host op that
        covered its start."""
        dev, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            start = e.start_ns() / 1e3
            item = (e.name(), start, start + e.duration_ns() / 1e3)
            if item[0].startswith(SPAN_PREFIX):
                if e.device_type() != torch.autograd.DeviceType.CUDA:
                    host.append(item)       # a span's device mirror is not
            elif (e.device_type() == torch.autograd.DeviceType.CUDA
                  or not self.cuda and item[0].startswith("aten::")):
                dev.append(item)
            else:
                host.append(item)
        kernels = [k for k in dev if "Memcpy" not in k[0]
                   and "Memset" not in k[0]]
        if not kernels:
            raise RuntimeError("the profiler recorded no device activity")
        by_name = defaultdict(float)
        for name, s, e in dev:
            by_name[name] += e - s
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"kernels": kernels, "launches": len(kernels),
                "busy_s": busy_us([(s, e) for _, s, e in dev]) / 1e6,
                "wall_s": self.wall_s,
                "device_ops": [[n[:200], us / 1e6] for n, us in ranked],
                "idle_gaps": _idle_gaps(dev, host, top)}


def _idle_gaps(dev, host, top):
    """The ``top`` longest stretches with no device activity between the
    first and last device record, each named "<harness span> / <innermost
    host op>" as the host stood at the gap's start."""
    merged = []
    for _, s, e in sorted(dev, key=lambda k: k[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:])),
                  reverse=True)[:top]
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    out = []
    for length, at in gaps:
        span, op, op_start = "outside any span", "no host op", -1.0
        for name, s, e in host[:bisect.bisect_right(starts, at)]:
            if e >= at:
                if name.startswith(SPAN_PREFIX):
                    span = name
                elif s >= op_start:
                    op, op_start = name, s
        out.append([f"{span} / {op}"[:200], length / 1e6])
    return out


def span(name: str):
    """A harness span in the trace (``record_function``)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)
