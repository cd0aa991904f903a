"""serve.launches_per_round: device kernels launched per round of the robot
fleet (the session restarts and the tick that follows them: the work every
decision of the round waits for), from the profiled rounds.  The serving
path's host cost scales with it."""


def read(run):
    p = run.profile
    return p["launches"] / p["units"]
