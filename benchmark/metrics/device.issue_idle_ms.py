"""device.issue_idle_ms.<kind> (``.eval``, ``.serve``): the device's idle
time a unit (a wave; a round) inside the program's spans that only issue
device work (``rollout.language`` and ``rollout.step`` in evaluation;
``fleet.language``, ``fleet.decide`` and ``fleet.walk`` in the fleet):
the idle that fewer launches would win back, apart from the idle in the
host's other work.  Idle is taken between the profiled stretch's first
and last kernel.  Nothing to read where the program records no spans."""

from portbench.spans import issue_idle_ms_per_unit

LAUNCH_ONLY = {"eval": ("rollout.language", "rollout.step"),
              "serve": ("fleet.language", "fleet.decide", "fleet.walk")}


def read(run):
    return issue_idle_ms_per_unit(run, LAUNCH_ONLY[run.mix["kind"]])
