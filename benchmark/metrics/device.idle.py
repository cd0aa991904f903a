"""device.idle.<kind> (``device.idle.eval``, ``device.idle.serve``): the
share of a unit's wall time in which no device operation runs, a unit
being what the cell's end-to-end metric is made of (a wave of evaluation;
a round of the fleet, restarts and tick).  The device's busy time per unit
in the profiled stretch, against the wall time per unit of the measured
window (timed without the profiler, in the same run)."""


def read(run):
    p, w = run.profile, run.window
    return 100.0 * (1.0 - p["busy_s"] / p["units"] / w["unit_wall_s"])
