"""Device time of the conv kernel (conv3x3_*_kernel) over all device
busy time in the profiled sweep call."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "kernel (kernels/conv.py, csrc/conv3x3.cu)", \
    "lane_steps_per_s"


def read(rec):
    p = rec["profile"]
    if not p or not p["conv_s"] or not p["busy_s"]:
        return None
    return 100.0 * p["conv_s"] / p["busy_s"]
