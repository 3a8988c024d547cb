"""Seconds the program memo spent building programs during set-up
(warm-up, checks and CUDA graph capture; programs.STATS['build_s'])."""

UNIT, BETTER, SOURCE = "s", "lower", "program_counter"
LAYER, MOVES = "programs (programs.py)", "setup_s"


def read(rec):
    b = rec["setup"]["build_s"]
    return b if b > 0 else None
