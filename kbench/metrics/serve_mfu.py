"""Model FLOP utilisation of the committed calls, in %: the model
operations of each call's prefill and decode steps (the family's
``call_flops`` in ``kbench/reference/``: 2 per parameter and token,
attention or the SSD scan included, the head at the positions whose
logits are used) over the calls' wall time at the H100's dense bf16
peak, 989 TFLOP/s."""
from kbench import yardstick


def read(run: dict):
    calls = run["measured"]
    wall = sum(c["t1"] - c["t0"] for c in calls)
    if not wall:
        return None
    flops = sum(run["call_flops"](run["model"], c["batch"], c["prompt"],
                                  c["steps"], run["chunk"]) for c in calls)
    return flops / (wall * yardstick.PEAK_BF16_FLOPS) * 100.0
