"""eval.tail_ms_per_wave: the host's work on an evaluation wave after its
results reach the host, when the device has nothing queued: the
``eval.trajectories`` and ``eval.score`` spans of the profiled waves, per
wave.  Nothing to read where the program records no spans."""

from portbench.spans import ms_per_unit


def read(run):
    return ms_per_unit(run, ("eval.trajectories", "eval.score"))
