"""Share of the traced committed calls' wall time in which no kernel ran
on the device, in %: 1 − (the union of their device events' intervals)
/ (their host spans)."""


def read(run: dict):
    wall = sum(t["wall_s"] for t in run["traces"])
    if not wall:
        return None
    return (1.0 - sum(t["busy_s"] for t in run["traces"]) / wall) * 100.0
