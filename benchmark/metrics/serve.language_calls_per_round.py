"""serve.language_calls_per_round: the fleet's instruction encodings in a
round, from the program's spans: the number of ``fleet.language`` spans of
the profiled rounds, per round.  Nothing to read where the program records
no spans."""

from portbench.spans import recorded


def read(run):
    spans = recorded(run)
    if spans is None:
        return None
    return sum(s.name == "fleet.language" for s in spans) \
        / run.profile["units"]
