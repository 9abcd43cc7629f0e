"""Share of the window's wall time spent in the executor's warm-up and
calibration serves, in %: the program's ``engine.serve`` spans with
purpose ``warm`` (the untimed first serve of each new configuration and
shape, ``ServeExecutor._serve_chunk``) or ``calibrate`` (the service
unit's two serves, ``_calibrate``), in committed windows and trials
alike, over the window (profiler time taken out)."""
from kbench import spans


def read(run: dict):
    got = spans.run_spans()
    if got is None or not run["wall_s"]:
        return None
    warm = sum(s.end - s.start for s in got[1] if s.name == "engine.serve"
               and s.attrs.get("purpose") in ("warm", "calibrate"))
    return warm / run["wall_s"] * 100.0
