"""Device busy time (the union of kernel, copy and memset intervals) of
the profiled sweep call, over the lane steps it ran."""

UNIT, BETTER, SOURCE = "ms/step", "lower", "device_trace"
LAYER, MOVES = "engine (train/engine.py)", "lane_steps_per_s"


def read(rec):
    p = rec["profile"]
    if not p or not p["lane_steps"] or not p["busy_s"]:
        return None
    return 1e3 * p["busy_s"] / p["lane_steps"]
