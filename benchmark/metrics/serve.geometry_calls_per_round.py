"""serve.geometry_calls_per_round: the fleet's geometry calls in a round,
from the program's spans: the number of ``fleet.geometry`` spans (the
tick's one batched call for every edge that needs heading, elevation or
view) of the profiled rounds, per round.  Nothing to read where the
program records no spans, or none of that name: a program that folds its
observations one edge at a time makes no such call to count."""

from portbench.spans import recorded


def read(run):
    spans = recorded(run)
    if spans is None:
        return None
    calls = sum(s.name == "fleet.geometry" for s in spans)
    return calls / run.profile["units"] if calls else None
