"""The device's idle share of the profiled sweep call: 1 - (union of its
busy intervals) / (the call's wall time)."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "device (H100)", "lane_steps_per_s"


def read(rec):
    p = rec["profile"]
    if not p or not p["wall_s"] or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
