"""The program's own spans over the window: the call records that
`s2s_ismr_tpu_torch.profiling.calls()` keeps, one per `run_unet_sweep`
call, numbered from 0 in the process. Call 0 is the set-up call (the
process's first), so the window's calls are ids 1 to
rec['window']['calls']."""

from __future__ import annotations


def window_calls(rec):
    """The window's call records, or None where the program keeps none,
    one of them is missing, or their lane_steps do not sum to the window's
    steps: a reader then reports nothing rather than other calls."""
    try:
        from s2s_ismr_tpu_torch import profiling
    except ImportError:
        return None
    calls = getattr(profiling, "calls", None)
    if calls is None:
        return None
    by_id = {c["id"]: c for c in calls()}
    win = [by_id.get(i) for i in range(1, rec["window"]["calls"] + 1)]
    if not win or any(c is None for c in win):
        return None
    steps = sum(c["counters"].get("lane_steps", 0) for c in win)
    return win if steps == rec["window"]["steps"] else None


def total(calls, *names):
    """Seconds of the spans `names`, summed over `calls`."""
    return sum(c["spans"][n]["total_s"] for c in calls for n in names
               if n in c["spans"])


def count(calls, name):
    """How often the span `name` closed in `calls`."""
    return sum(c["spans"][name]["count"] for c in calls
               if name in c["spans"])

