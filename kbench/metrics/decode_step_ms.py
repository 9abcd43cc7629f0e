"""Mean wall time of a decode step in the window's committed calls: the
decode part of every committed engine call (from its prefill's end to
its return) over the decode steps it ran.  Layer: the serving engine's
decode loop (``kermit/serving/engine.py``, ``models/*`` decode)."""


def read(run: dict):
    calls = run["measured"]
    steps = sum(c["steps"] for c in calls)
    if not steps:
        return None
    return sum(c["t1"] - c["tp"] for c in calls) / steps * 1e3
