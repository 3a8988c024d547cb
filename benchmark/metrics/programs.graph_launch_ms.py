"""One CUDA graph launch of a training program with no profiler running:
the span programs.graph_launch (one per graph that Program.run launches:
an epoch's one graph, or a chunked epoch's prologue, chunk, single-step
and epilogue graphs) summed over the window's calls, over its count
(benchmark/spans.py). Where an epoch is one graph, the launch starts on an
idle device and this is programs.train_replay_ms less the span's own cost.
In a chunked epoch a launch queued behind a graph that still runs waits
for it, so this reads the device time of the graph before it spread over
the epoch's launches, not the host's cost of a launch. None where the
program opens no such span."""

from benchmark import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "programs (programs.py)", "lane_steps_per_s"


def read(rec):
    win = spans.window_calls(rec)
    if win is None:
        return None
    n = spans.count(win, "programs.graph_launch")
    if not n:
        return None
    return 1e3 * spans.total(win, "programs.graph_launch") / n
