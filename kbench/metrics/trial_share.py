"""Share of the window's wall time spent in trials, in %: the spans of
every ``measure`` and ``measure_batch`` call (the Plan phase replaying
the probe window under candidate configurations) over the window."""


def read(run: dict):
    return run["trial_s"] / run["wall_s"] * 100.0
