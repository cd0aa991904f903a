"""serve.ingest_ms_per_round: the tick's Python over the robots in a round,
from the program's spans: the ``fleet.ingest`` (checks, mirrors, the
upload's rows) and ``fleet.record`` (each robot's decision) spans of the
profiled rounds, per round.  Nothing to read where the program records no
spans."""

from portbench.spans import ms_per_unit


def read(run):
    return ms_per_unit(run, ("fleet.ingest", "fleet.record"))
