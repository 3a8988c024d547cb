"""Minibatch steps captured into training programs' graphs during set-up:
the counter captured_steps of the set-up call's record (call 0, the
process's first sweep call; benchmark/spans.py), to which each training
program's build adds the steps its graphs hold (a batched step of L lanes
once). An epoch of n real steps captures n; past the engine's chunk every
epoch of the shapes shares one chunked program of chunk + 1 steps. None
where the program keeps no such counter."""

UNIT, BETTER, SOURCE = "steps", "lower", "program_counter"
LAYER, MOVES = "programs (programs.py)", "setup_s"


def read(rec):
    try:
        from s2s_ismr_tpu_torch import profiling
    except ImportError:
        return None
    calls = getattr(profiling, "calls", None)
    if calls is None:
        return None
    setup = [c for c in calls() if c["id"] == 0]
    if not setup:
        return None
    steps = setup[0]["counters"].get("captured_steps")
    return steps if steps else None
