"""Prefill wall time per 1,000 prompt tokens in the window's committed
calls: the prefill part of every committed engine call over the tokens
it prefilled (batch × prompt, the padding rows included, as the engine
computes them).  Layer: the serving engine's prefill (``train/step.py``,
``models/model.py:prefill``)."""


def read(run: dict):
    calls = run["measured"]
    tokens = sum(c["batch"] * c["prompt"] for c in calls)
    if not tokens:
        return None
    return sum(c["tp"] - c["t0"] for c in calls) / tokens * 1e6
