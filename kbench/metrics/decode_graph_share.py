"""Share of the run's decode steps replayed from a CUDA graph, in %: over
every ``engine.decode`` span under the run's root (committed calls,
trials, warm and calibration serves alike), the steps of those whose
``graph`` attribute is true over all their steps.  Layer: the serving
engine's decode loop (``kermit/serving/engine.py``), which replays a
captured step on the card for the dense and ssm families at two steps or
more, and runs its eager loop otherwise.  None where the program records
no spans or its decode spans carry no ``graph`` attribute (a program
without the decode graph)."""
from kbench import spans


def read(run: dict):
    got = spans.run_spans()
    if got is None:
        return None
    decodes = [s for s in got[1] if s.name == "engine.decode"]
    if not decodes or any("graph" not in s.attrs for s in decodes):
        return None
    steps = sum(s.attrs["steps"] for s in decodes)
    graphed = sum(s.attrs["steps"] for s in decodes if s.attrs["graph"])
    return graphed / steps * 100.0 if steps else None
