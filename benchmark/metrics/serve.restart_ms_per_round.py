"""serve.restart_ms_per_round: the fleet's session restarts in a round,
from the program's spans: the ``fleet.finish`` and ``fleet.join`` spans of
the profiled rounds, per round.  Nothing to read where the program records
no spans."""

from portbench.spans import ms_per_unit


def read(run):
    return ms_per_unit(run, ("fleet.finish", "fleet.join"))
