"""The SSD scan's share of its roofline, in %: over every launch of
``ssd_fwd_*`` in the traced committed calls, the least time the chip
needs for the launch's shape (``kbench/yardstick.ssd_bound``) over its
device time in the trace.  Read only where the model has SSD layers."""
from kbench import yardstick


def read(run: dict):
    m, bound, dev = run["model"], 0.0, 0.0
    if m["family"] != "ssm":
        return None
    for t in run["traces"]:
        ops = [(b, e) for n, b, e in t["ops"] if "ssd_fwd" in n]
        Q = yardstick.ssd_chunk(t["prompt"], run["chunk"])
        one = yardstick.ssd_bound(t["batch"], t["prompt"], m["ssm_heads"],
                                  m["ssm_head_dim"], m["groups"],
                                  m["d_state"], Q)["bound_s"]
        bound += one * len(ops)
        dev += sum(e - b for b, e in ops) / 1e6
    return bound / dev * 100.0 if dev else None
