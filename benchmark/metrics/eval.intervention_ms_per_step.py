"""eval.intervention_ms_per_step: the host's time in the causal-intervention
heads of an evaluation wave, from the program's spans: the total duration
of the ``intervention.*`` spans (the text backdoors and frontdoor at the
instruction, the image backdoor, the viewpoint and map frontdoors at every
step) of the profiled waves over waves x max_action_len.  Nothing to read
where the program records no such span."""

from portbench.spans import ms_per_unit, recorded

SPANS = ("intervention.backdoor_txt", "intervention.frontdoor_txt",
         "intervention.backdoor_img", "intervention.frontdoor_vp",
         "intervention.frontdoor_gmap")


def read(run):
    spans = recorded(run)
    if not spans or not any(s.name in SPANS for s in spans):
        return None
    return ms_per_unit(run, SPANS) / run.mix["max_action_len"]
