"""eval.issue_ms_per_step: the host's time to issue one rollout step of an
evaluation wave, from the program's spans: the total duration of the
``rollout.step`` spans of the profiled waves over waves x max_action_len.
Nothing to read where the program records no spans."""

from portbench.spans import ms_per_unit


def read(run):
    ms = ms_per_unit(run, ("rollout.step",))
    return None if ms is None else ms / run.mix["max_action_len"]
