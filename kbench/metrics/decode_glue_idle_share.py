"""Share of the decode idle put down to host code outside the model's
layers, in %: each idle gap inside an ``engine.decode`` span of the
complete traced committed calls (the decode operations laid on the
host's clock step by step, ``kbench/spans.py``) is put down to the
innermost program span open on the host when the operation that ends it
was issued (where it lies on that clock, each step's first operation at
its step's opening; the span's end for the last gap); the share that
falls outside every ``model.layer`` (the embedding, the per-step
parameter views, the head, sampling and the loop itself) of all the
decode idle.  Needs the decode step's detail spans, which the program
records only while a profiler records."""
from kbench import spans


def read(run: dict):
    calls = spans.traced_calls(run)
    if calls is None:
        return None
    gaps = spans.idle_by_span(calls)
    if not gaps:
        return None
    total = sum(us for _, _, us in gaps)
    glue = sum(us for c, s, us in gaps if not c.in_layer(s))
    return glue / total * 100.0 if total else None
