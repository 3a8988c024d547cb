"""The share of the window's sweep calls spent collecting: the winner
choice and the winner forwards (SweepResult.timings collect_s), over
execute_s + collect_s, summed over the calls."""

UNIT, BETTER, SOURCE = "%", "lower", "program_span"
LAYER, MOVES = "sweep (train/sweep.py)", "lane_steps_per_s"


def read(rec):
    w = rec["window"]
    total = w["execute_s"] + w["collect_s"]
    return 100.0 * w["collect_s"] / total if total > 0 else None
