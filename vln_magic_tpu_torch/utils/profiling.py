"""Profiling: device traces, the program's own spans, step timing and
memory figures.

Port of ``vln_magic_tpu/utils/profiling.py``, which replaces the
reference's wall-clock heuristics (reference: map_nav_src/utils/
logger.py:21-57 Timer/ETA; pretrain tok_per_s counters,
train_r2r_magic.py:464-584; pynvml GPU monitors, pretrain_src/data/
common.py:171-225).  Here the trace is ``torch.profiler``'s (a Chrome
trace, viewable in Perfetto), sub-regions are the program's spans
(``span``), the step timer synchronises the device around each step, and
the memory figures come from the CUDA caching allocator.

Spans are kept in memory, stamped on ``time.time_ns()``, the clock the
profiler's own records are stamped on, so a span's interval can be set
against the kernels it issued.  They are not ``record_function`` ranges:
the profiler mirrors each of those onto the device timeline as a CUDA
record, which a reader of the device trace counts as a launch and as busy
time.
A span records only while ``recording()`` or ``trace()`` is open, or a
``torch.profiler`` session is active in the process; otherwise it is a
shared no-op.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch

# spans past this many since the last ``reset`` are counted, not kept
MAX_SPANS = 100_000
# the row of the exported trace that holds the spans, in the host process
_SPAN_TID = 0


class Span(NamedTuple):
    """A closed span: its id, name, the id of the span open around it on
    its thread (``None`` for a root) and of the outermost one (its own for
    a root), its start and end in ns on ``time.time_ns()``'s clock, and its
    self time (its duration less what its child spans cover)."""

    id: int
    name: str
    parent: int | None
    root: int
    start_ns: int
    end_ns: int
    self_ns: int


class _Spans:
    """The process's span record: the spans closed since the last
    ``reset``, each thread's open spans, and how many ``recording()`` or
    ``trace()`` blocks are open.  Ids are unique in the process."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.on = 0
        self.closed: list[tuple] = []
        self.next_id = 0
        self.kept = self.dropped = 0

    def open(self, name: str):
        with self.lock:
            if self.kept >= MAX_SPANS:
                self.dropped += 1
                return _OFF
            self.kept += 1
            sid = self.next_id
            self.next_id += 1
        return _Open(self, name, sid)

    def reset(self):
        with self.lock:
            self.closed = []
            self.kept = self.dropped = 0


class _Open:
    """An open span: on exit it joins the record."""

    __slots__ = ("rec", "name", "id", "parent", "root", "start", "stack")

    def __init__(self, rec: _Spans, name: str, sid: int):
        self.rec, self.name, self.id = rec, name, sid

    def __enter__(self):
        stack = self.stack = self.rec.local.__dict__.setdefault("stack", [])
        up = stack[-1] if stack else None
        self.parent = up.id if up is not None else None
        self.root = up.root if up is not None else self.id
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.stack.pop()
        self.rec.closed.append((self.id, self.name, self.parent, self.root,
                                self.start, end))
        return False


_SPANS = _Spans()
_OFF = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled


def span(name: str):
    """A named region of the program, as a context manager: recorded
    (``recorded()``) while ``recording()`` or ``trace()`` is open or a
    ``torch.profiler`` session is active, else a shared no-op.  It adds
    no profiler event and no device work."""
    if not (_SPANS.on or _profiler_enabled()):
        return _OFF
    return _SPANS.open(name)


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with no profiler."""
    with _SPANS.lock:
        _SPANS.on += 1
    try:
        yield
    finally:
        with _SPANS.lock:
            _SPANS.on -= 1


def recorded() -> list[Span]:
    """The spans closed since the last ``reset``, in order of start."""
    closed = list(_SPANS.closed)
    covered = defaultdict(int)
    for _, _, parent, _, start, end in closed:
        if parent is not None:
            covered[parent] += end - start
    return sorted((Span(sid, name, parent, root, start, end,
                        end - start - covered[sid])
                   for sid, name, parent, root, start, end in closed),
                  key=lambda s: (s.start_ns, s.id))


def dropped() -> int:
    """How many spans were not kept since the last ``reset``, past
    ``MAX_SPANS``."""
    return _SPANS.dropped


def reset():
    """Forget the recorded spans."""
    _SPANS.reset()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region (the host, and every CUDA device when
    there is one) and write its Chrome trace to ``log_dir/trace.json``,
    with the spans recorded in it as complete events on a row of their own
    in the host process.  Yields the ``torch.profiler.profile``, whose
    ``key_averages()`` and events the caller may read after the region."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    t0 = time.time_ns()
    prof.__enter__()
    try:
        with recording():
            yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        _write_spans(path, [s for s in recorded() if s.start_ns >= t0])


def _write_spans(path: str, spans: list[Span]):
    """Add ``spans`` to a Chrome trace as complete events, on the trace's
    own time base (``baseTimeNanoseconds``; us)."""
    with open(path) as f:
        data = json.load(f)
    base = data.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = data.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid,
                   "tid": _SPAN_TID, "args": {"name": "program spans"}})
    events.extend({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                   "tid": _SPAN_TID, "ts": (s.start_ns - base) / 1e3,
                   "dur": (s.end_ns - s.start_ns) / 1e3,
                   "args": {"id": s.id, "parent": s.parent, "root": s.root,
                            "self_us": s.self_ns / 1e3}}
                  for s in spans)
    with open(path, "w") as f:
        json.dump(data, f)


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
