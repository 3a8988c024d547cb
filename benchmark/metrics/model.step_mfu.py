"""The whole step's share of the chip's float32 peak: the model FLOP of
the window's lane epochs (every 3x3 conv, transposed conv and the 1x1
head; forward, input gradient and weight gradient of each training row,
forward of each val row; counts.lane_epoch_flops) over the window's
seconds, over peaks.FLOAT32_3XTF32."""

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER, MOVES = "model step (models/unet.py)", "lane_steps_per_s"


def read(rec):
    w = rec["window"]
    if not w["flops"] or not w["seconds"]:
        return None
    return 100.0 * w["flops"] / w["seconds"] / rec["peaks"]["flops"]
