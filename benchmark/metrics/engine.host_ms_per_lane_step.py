"""The host's work at epoch boundaries per lane step: the span
engine.epoch (from an epoch's stop check, which has waited for the device,
or the loop's start, up to its replay's launch: the batch orders drawn and
uploaded, in batched lanes a program change) summed over the window's
calls, over their lane steps (benchmark/spans.py). The device idles through
it in every cell; the launch that follows is programs.train_replay_ms.
Compare it with engine.device_ms_per_lane_step."""

from benchmark import spans

UNIT, BETTER, SOURCE = "ms/step", "lower", "program_span"
LAYER, MOVES = "engine (train/engine.py)", "lane_steps_per_s"


def read(rec):
    win = spans.window_calls(rec)
    if win is None or not rec["window"]["steps"]:
        return None
    return 1e3 * spans.total(win, "engine.epoch") / rec["window"]["steps"]
