"""The conv kernel's share of its roofline: the least time of its
launches in the profiled sweep call (counts.least_time, from the shapes),
over the device time of the kernels named conv3x3_*_kernel there."""

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernel (kernels/conv.py, csrc/conv3x3.cu)", \
    "lane_steps_per_s"


def read(rec):
    p = rec["profile"]
    if not p or not p["conv_s"]:
        return None
    return 100.0 * p["least_conv_s"] / p["conv_s"]
