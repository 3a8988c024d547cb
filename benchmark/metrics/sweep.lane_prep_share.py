"""The share of the window's sweep execution the host spends preparing
lanes: each bucket's U-Nets built with their own inits and generators
(span sweep.lane_models), the handed inits and batch orders made
(sweep.overrides) and each lane loaded into its program up to its first
replay (engine.load), over sweep.execute, summed over the window's calls
(benchmark/spans.py)."""

from benchmark import spans

UNIT, BETTER, SOURCE = "%", "lower", "program_span"
LAYER, MOVES = "sweep (train/sweep.py)", "lane_steps_per_s"


def read(rec):
    win = spans.window_calls(rec)
    if win is None:
        return None
    execute = spans.total(win, "sweep.execute")
    if execute <= 0:
        return None
    prep = spans.total(win, "sweep.lane_models", "sweep.overrides",
                       "engine.load")
    return 100.0 * prep / execute
