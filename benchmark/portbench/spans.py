"""The program's own spans (``vln_magic_tpu_torch.utils.profiling.span``)
in a profiled stretch: the time spent in spans of some names, and the
device's idle time inside them.

The program records its spans in memory while a profiler session is
active, stamped on the clock of the profiler's records, so they are set
against the stretch's kernels (``run.profile["kernels"]``, us) directly.
A program that records no spans gives nothing to read: each function
here returns None then.
"""

from __future__ import annotations


def recorded(run):
    """The spans the program recorded in the run's profiled stretch, or
    None.  Taken once a run and cleared from the program's record, so a
    later run in the same process reads only its own."""
    if not hasattr(run, "program_spans"):
        try:
            from vln_magic_tpu_torch.utils import profiling
        except ImportError:
            profiling = None
        take = getattr(profiling, "recorded", None)
        spans = take() if take is not None else []
        if spans:
            profiling.reset()
        run.program_spans = spans or None
    return run.program_spans


def ms_per_unit(run, names) -> float | None:
    """The total duration of the spans named in ``names``, in ms per unit
    of the stretch (a wave; a round)."""
    spans = recorded(run)
    if spans is None:
        return None
    ns = sum(s.end_ns - s.start_ns for s in spans if s.name in names)
    return ns / 1e6 / run.profile["units"]


def _union(intervals):
    """Sorted, disjoint [start, end] intervals covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_inside(kernels, spans) -> float:
    """The time, in the units of both, in which no kernel runs between the
    first and the last kernel and some interval of ``spans`` is open."""
    busy = _union((s, e) for _, s, e in kernels)
    idle = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    covered = _union(spans)
    total, j = 0.0, 0
    for s, e in idle:
        while j < len(covered) and covered[j][1] <= s:
            j += 1
        k = j
        while k < len(covered) and covered[k][0] < e:
            total += min(e, covered[k][1]) - max(s, covered[k][0])
            k += 1
    return total


def issue_idle_ms_per_unit(run, names) -> float | None:
    """The device's idle time inside the spans named in ``names``, in ms
    per unit of the stretch."""
    spans = recorded(run)
    if spans is None:
        return None
    inside = [(s.start_ns / 1e3, s.end_ns / 1e3) for s in spans
              if s.name in names]
    return idle_inside(run.profile["kernels"], inside) / 1e3 \
        / run.profile["units"]
