"""Flash attention's share of its roofline, in %: over every launch of
``flash_fwd_*`` in the traced committed calls, the least time the chip
needs for the launch's shape (``kbench/yardstick.flash_bound``: the
larger of bytes at 3.35 TB/s and operations at 989 TFLOP/s) over its
device time in the trace.  Read only where the model has attention."""
from kbench import yardstick


def read(run: dict):
    m, bound, dev = run["model"], 0.0, 0.0
    if m["family"] != "dense":
        return None
    for t in run["traces"]:
        ops = [(b, e) for n, b, e in t["ops"] if "flash_fwd" in n]
        one = yardstick.flash_bound(t["batch"], t["prompt"], m["heads"],
                                    m["kv_heads"], m["head_dim"])["bound_s"]
        bound += one * len(ops)
        dev += sum(e - b for b, e in ops) / 1e6
    return bound / dev * 100.0 if dev else None
