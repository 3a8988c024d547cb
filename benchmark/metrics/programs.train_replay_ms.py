"""One epoch graph's launch with no profiler running: the span
programs.train_replay (Program.run of a training program) summed over the
window's calls, over its count (benchmark/spans.py). Each launch in the
window starts on an idle device (the stop check or the epochs-run read
before it waited) and returns at the host's pace. In ecmwf32_serial the
launch hands the 10,202-node graph over whole in 1.0-1.6 ms. The 19,231-node
(iitm64_serial) and 18,493-node (ecmwf32_vmap) graphs go over node by node,
about 2.4 us a node, 45 ms, while the device runs the nodes behind the
host: the launch takes the same 45 ms at 4.9 and 8.5 us of device time a
node, so it does not wait for the device. Behind queued device work such
a launch waits for it."""

from benchmark import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "programs (programs.py)", "lane_steps_per_s"


def read(rec):
    win = spans.window_calls(rec)
    if win is None:
        return None
    n = spans.count(win, "programs.train_replay")
    if not n:
        return None
    return 1e3 * spans.total(win, "programs.train_replay") / n
