"""Device operations launched per decode step: over the complete traced
committed calls, the device operations (kernels, copies, sets) of the
decode loop inside each call's ``engine.decode`` span
(``repro_torch/kermit/serving/engine.py``; found as ``kbench/spans.py``
says: the run of equal blocks, one a step), over the steps those spans
ran.  Layer: the model's decode step (``models/transformer.py:
decode_step``, ``models/ssm_lm.py:decode_mamba``), which issues them."""
from kbench import spans


def read(run: dict):
    calls = spans.traced_calls(run)
    if calls is None:
        return None
    launches, steps, _ = spans.decode_idle(calls)
    return launches / steps if steps else None
