"""The program's own spans (``repro_torch.runtime.trace``), laid against
the device traces of the committed calls, for the per-layer metrics that
read them.

A run's spans are the last ``session.run_live`` root in the program's
ring and its descendants.  Each complete trace of ``run["traces"]`` is
the trace of the ``engine.serve`` span whose start, mapped onto the
trace's clock by the call's own ``time.time_ns()`` anchor
(``trace.trace_us``), lies nearest its first operation; a trace farther
than ``MATCH_US`` from every call means the clocks disagree.

The device clock drifts against the host's inside a traced call (on the
H100 machine by up to 1.7 % of the call, in either direction, and the
anchor itself may be off by a millisecond: PERF.md), so the readers do
not lay single operations by that anchor.  The decode steps' operations
are found in the trace by their structure: every step issues the same
operations, so the decode loop is the run of ``steps`` equal blocks just
before the call's last few operations (the tokens' concatenation and
copy).  Each block is then laid on the host's clock by its own step: its
first operation at its ``engine.step`` span's opening, the rest at the
rate from that operation to the next step's first (the last step at the
rate before it).  So the latency from the host's issue of an operation
to its start is taken, step by step, as that step's own (its opening to
its first operation): no constant is assumed.  A gap is put down to the
span open on the host when the operation that ends it was issued, which
on this clock is where the operation lies.

Every reader returns None where the program records no spans (a program
without the recorder), where a span was dropped after the run opened,
where a trace lies in no call, or where no traced call's decode could be
laid out.
"""
from __future__ import annotations

import bisect

# the most by which a call's first device operation may lie from its
# span's start on the trace's clock (the anchor's error at a call's
# start: up to about 1 ms)
MATCH_US = 20_000.0
# operations after the decode loop, at most; host time over device time
# between two steps' first operations beyond which one of them is out of
# its place or the trace's clock jumped (a drift runs within 1 +- 0.02,
# a step's own latency moves a few tens of us in a step of 50-100 ms);
# the share of operations the trace may put out of their places
MAX_TAIL = 4
RATE = (0.97, 1.03)
MISPLACED = 0.01


def run_spans():
    """(root, its descendants in order of opening), or None."""
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    spans = trace.snapshot()
    roots = [s for s in spans if s.name == "session.run_live"]
    # a span lost since the run opened may have been one of the run's
    if not roots or trace.dropped > roots[-1].attrs["dropped"]:
        return None
    root = roots[-1]
    inside, out = {root.id}, []
    for s in sorted(spans, key=lambda s: s.id):
        if s.parent in inside:
            inside.add(s.id)
            out.append(s)
    return root, out


def decode_blocks(ops: list, steps: int):
    """The decode steps' operations of one call's trace, one list a
    step, or None: ``steps`` blocks of equal length that end ``tail``
    operations before the trace's end, the last two alike name for name
    and the rest but for ``MISPLACED`` of their operations (the trace
    puts a rare operation out of its place), for the least ``tail`` and
    the least length that fit."""
    names = [n for n, _, _ in ops]
    if steps < 2:
        return None
    for tail in range(1, MAX_TAIL + 1):
        end = len(names) - tail
        for k in range(1, end // steps + 1):
            lo = end - steps * k
            if not all(names[j] == names[j - k]
                       for j in range(end - 1, end - k - 1, -1)):
                continue
            bad = sum(names[j] != names[j - k]
                      for j in range(lo + k, end - k))
            if bad <= MISPLACED * (steps - 1) * k:
                return [ops[lo + i * k:lo + (i + 1) * k]
                        for i in range(steps)]
    return None


def _descendants(span, children: dict) -> list:
    out, todo = [], [span.id]
    while todo:
        for s in children.get(todo.pop(), ()):
            out.append(s)
            todo.append(s.id)
    return sorted(out, key=lambda s: (s.start, s.id))


class Call:
    """One traced engine call: its ``engine.serve`` span and the spans
    inside its decode, its trace's decode blocks, and the map of their
    operations onto the host's clock (us since the call's start)."""

    def __init__(self, serve, children: dict, trace: dict):
        self.serve, self.trace = serve, trace
        self.decode = next((s for s in children.get(serve.id, ())
                            if s.name == "engine.decode"), None)
        self.inner, self.steps, self.blocks = [], [], None
        if self.decode is not None:
            self.inner = _descendants(self.decode, children)
            self.steps = [s for s in self.inner if s.name == "engine.step"]
            self.blocks = decode_blocks(trace["ops"],
                                        int(self.decode.attrs["steps"]))
        self.by_id = {s.id: s for s in self.inner}
        self._starts = [self.hs(s.start) for s in self.inner]
        self.ops = self._lay() if self.blocks else None

    def hs(self, t: float) -> float:
        """A host stamp as us since the call's start."""
        return (t - self.serve.start) * 1e6

    def _lay(self):
        """The decode operations as (host start, host end) us, in order,
        or None where the steps do not agree.  A step's first operation
        whose rates with both neighbours' lie out of ``RATE`` is out of
        its place in the trace: that step is laid from the one before,
        for a tenth of the steps at most.  One rate out of ``RATE``
        between two steps that agree with theirs is a jump of the
        trace's clock, spread over the step it falls in.  Without detail
        spans the decode is laid from its span's opening at the trace's
        own rate."""
        if len(self.steps) == len(self.blocks):
            dev = [b[0][1] for b in self.blocks]
            host = [self.hs(s.start) for s in self.steps]
        else:
            dev, host = [self.blocks[0][0][1]], [self.hs(self.decode.start)]

        def off(a, b):
            dd = dev[b] - dev[a]
            return not (dd > 0 and RATE[0] <= (host[b] - host[a]) / dd
                        <= RATE[1])
        spare, i = len(dev) // 10, 1
        while i < len(dev) - 1:
            if not (off(i - 1, i) and off(i, i + 1)):
                i += 1
            elif spare:
                del dev[i], host[i]
                spare -= 1
            else:
                return None
        if any(b <= a for a, b in zip(dev, dev[1:])):
            return None

        def lay(t):
            if len(dev) == 1:
                return host[0] + t - dev[0]
            i = min(max(bisect.bisect_right(dev, t) - 1, 0), len(dev) - 2)
            return host[i] + (t - dev[i]) * (host[i + 1] - host[i]) / \
                (dev[i + 1] - dev[i])
        return [(lay(b), lay(e)) for blk in self.blocks for _, b, e in blk]

    def innermost(self, h: float):
        """The innermost span open at ``h`` (us since the call's start)
        inside the decode span, or the decode span itself.  Spans of one
        thread nest, so walk up from the last one opened by ``h``."""
        i = bisect.bisect_right(self._starts, h) - 1
        s = self.inner[i] if i >= 0 else None
        while s is not None and not self.hs(s.start) <= h <= self.hs(s.end):
            s = self.by_id.get(s.parent)
        return s or self.decode

    def in_layer(self, s) -> bool:
        """Whether span ``s`` is a ``model.layer`` or inside one."""
        while s is not None:
            if s.name == "model.layer":
                return True
            s = self.by_id.get(s.parent)
        return False

    def gaps(self) -> list:
        """The decode span's idle as (host us where the gap ends, or None
        for the span's end; us): the span's start to the first
        operation, between operations, the last one to the span's end."""
        out, cursor = [], self.hs(self.decode.start)
        for b, e in self.ops:
            if b > cursor:
                out.append((b, b - cursor))
            cursor = max(cursor, e)
        end = self.hs(self.decode.end)
        if end > cursor:
            out.append((None, end - cursor))
        return out


def traced_calls(run: dict):
    """A ``Call`` for each complete trace of ``run`` whose decode could
    be laid out, or None (also where a trace lies in no call)."""
    got = run_spans()
    if got is None or not run["traces"]:
        return None
    from repro_torch.runtime import trace
    _, spans = got
    children: dict = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s)
    serves = [s for s in spans
              if s.name == "engine.serve" and "unix_ns" in s.attrs]
    calls = []
    for t in run["traces"]:
        if not t["ops"] or not serves:
            continue
        lo = t["ops"][0][1]
        s = min(serves, key=lambda s: abs(trace.trace_us(s.start, s) - lo))
        if abs(trace.trace_us(s.start, s) - lo) > MATCH_US:
            return None
        c = Call(s, children, t)
        if c.ops is not None:
            calls.append(c)
    return calls or None


def decode_idle(calls: list) -> tuple:
    """(launches, steps, idle us) over the calls' decode spans: the
    operations of their decode blocks, their steps, and the span time
    that the union of those operations leaves."""
    launches = steps = 0
    idle = 0.0
    for c in calls:
        launches += len(c.ops)
        steps += len(c.blocks)
        idle += sum(us for _, us in c.gaps())
    return launches, steps, idle


def idle_by_span(calls: list):
    """The decode spans' idle put down to the innermost span open where
    each gap ends (where the host issued the operation that ends it), or
    to the decode span for the gap after the last operation.  Returns a
    list of (call, span, us), or None where a call has no detail spans
    (its decode ran unprofiled)."""
    out = []
    for c in calls:
        if not c.steps:
            return None
        for h, us in c.gaps():
            out.append((c, c.decode if h is None else c.innermost(h), us))
    return out
