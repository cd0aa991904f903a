"""eval.launches_per_step: device kernels launched per rollout step of
an evaluation wave (every kernel record of the profiled waves, over waves x
max_action_len).  The evaluation loop's host cost scales with it."""


def read(run):
    p = run.profile
    return p["launches"] / (p["units"] * run.mix["max_action_len"])
