"""Device idle per decode launch, in us: over the complete traced
committed calls' ``engine.decode`` spans (the program's spans), the span
time that the union of the decode loop's device operations leaves (laid
on the host's clock step by step, ``kbench/spans.py``), over those
operations.  Layer: the serving engine's decode loop, whose host time
between launches the device waits for."""
from kbench import spans


def read(run: dict):
    calls = spans.traced_calls(run)
    if calls is None:
        return None
    launches, _, idle_us = spans.decode_idle(calls)
    return idle_us / launches if launches else None
