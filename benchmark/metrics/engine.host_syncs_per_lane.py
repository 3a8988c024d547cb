"""Synchronizing CUDA calls over one whole sweep call of the cell under
torch.cuda.set_sync_debug_mode('warn'), per lane."""

UNIT, BETTER, SOURCE = "syncs/lane", "lower", "program_counter"
LAYER, MOVES = "engine (train/engine.py)", "lane_steps_per_s"


def read(rec):
    s = rec["syncs"]
    return s["count"] / s["lanes"] if s else None
