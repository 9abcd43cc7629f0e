"""The readers of the program's spans (``kbench/spans.py`` and the four
metrics on it) on hand-made spans and device operations, with the values
worked out by hand; and None where there is nothing sound to read."""
import sys
from types import SimpleNamespace

import pytest

from kbench import harness, spans
from kbench.tests.tiny import REPO
from repro_torch.runtime import trace

NAMES = ("decode_launches_per_step", "decode_idle_us_per_launch",
         "decode_glue_idle_share", "warmup_share")
T0 = 1000.0           # the traced call's start, host seconds
UNIX_NS = 10 ** 12    # its anchor on the trace's clock
BASE_US = UNIX_NS / 1e3


def _span(i, parent, name, a, b, **attrs):
    """A span from ``a`` to ``b`` us after the traced call's start."""
    return SimpleNamespace(id=i, parent=parent, name=name,
                           start=T0 + a / 1e6, end=T0 + b / 1e6,
                           attrs=attrs)


def _spans(detail=True, steps=2):
    s = [_span(1, 0, "session.run_live", -4e6, 6e6, dropped=0),
         _span(2, 1, "executor.window", -3e6, 2e6, window=0),
         _span(3, 2, "engine.serve", -3e6, -2.5e6, purpose="warm"),
         _span(4, 2, "engine.serve", -2.5e6, -2.25e6, purpose="calibrate"),
         _span(5, 2, "executor.chunk", 0, 2.1e4, requests=[0, 1],
               real_rows=2),
         _span(6, 5, "engine.serve", 0, 20000, purpose="serve",
               unix_ns=UNIX_NS),
         _span(7, 6, "engine.prefill", 0, 2000),
         _span(8, 6, "engine.decode", 2000, 17000, steps=steps)]
    if detail:
        s += [_span(9, 8, "engine.step", 2000, 8000, step=0),
              _span(10, 9, "model.embed", 2000, 2500),
              _span(11, 9, "model.views", 2500, 3000),
              _span(12, 9, "model.layer", 3000, 7000, index=0),
              _span(13, 12, "inner", 3050, 3150),
              _span(14, 9, "model.head", 7000, 7500),
              _span(15, 9, "engine.sample", 7500, 8000),
              _span(16, 8, "engine.step", 8000, 16000, step=1),
              _span(17, 16, "model.embed", 8000, 8500),
              _span(18, 16, "model.views", 8500, 9000),
              _span(19, 16, "model.layer", 9000, 15000, index=0),
              _span(20, 16, "model.head", 15000, 15500),
              _span(21, 16, "engine.sample", 15500, 16000)]
    # the ring holds spans in order of closing
    return sorted(s, key=lambda x: x.end)


# where each operation ran, in us of the host's clock since the call's
# start: a prefill, the first token's sample, two decode steps of the
# same six operations (each step's first starts 100 us after its span
# opened, so the readers lay every decode operation 100 us early; the
# last ends 50 us before the decode span's synchronize returned), then
# the tokens' concatenation and copy
HOST_OPS = [("prefill", 100, 1900), ("argmax", 1950, 1960),
            ("cast", 1970, 1980),
            ("emb", 2100, 2200), ("lay_a", 3200, 5000), ("lay_b", 5200, 6000),
            ("head", 7200, 7300), ("argmax", 7620, 7670), ("cast", 7700, 7720),
            ("emb", 8100, 8200), ("lay_a", 9200, 11000),
            ("lay_b", 11200, 14000), ("head", 15200, 15300),
            ("argmax", 15620, 15670), ("cast", 15700, 16950),
            ("cat", 17100, 17120), ("Memcpy DtoH", 17200, 17300)]


def _ops(rate=1.01, shift=300.0):
    """The operations on the trace's clock, which runs ``rate`` times
    the host's and ``shift`` us ahead."""
    return [(n, BASE_US + shift + rate * b, BASE_US + shift + rate * e)
            for n, b, e in HOST_OPS]


@pytest.fixture
def program(monkeypatch):
    """The program's ring replaced by hand-made spans."""
    state = {"spans": _spans()}
    monkeypatch.setattr(trace, "snapshot", lambda: list(state["spans"]))
    monkeypatch.setattr(trace, "dropped", 0)
    return state


def _read(run):
    return {n: harness.load_reader(REPO, n)(run) for n in NAMES}


def _run(ops=None):
    return {"traces": [{"ops": _ops() if ops is None else ops}],
            "wall_s": 10.0}


def test_decode_blocks_by_structure():
    blocks = spans.decode_blocks(_ops(), 2)
    assert [[n for n, _, _ in b] for b in blocks] == \
        [["emb", "lay_a", "lay_b", "head", "argmax", "cast"]] * 2
    assert spans.decode_blocks(_ops(), 3) is None
    assert spans.decode_blocks(_ops(), 1) is None


def test_values_by_hand(program):
    got = _read(_run())
    # twelve decode operations (the prefill's, the first token's and
    # the two after the loop are not), two steps
    assert got["decode_launches_per_step"] == 6.0
    # the decode span's 15000 us less the union of its operations (2870
    # + 6100) = 6030 us of idle over 12 launches
    assert got["decode_idle_us_per_launch"] == pytest.approx(502.5)
    # put down where each gap ends as laid, 100 us before the operation
    # that ends it ran: 2400 us inside the layers (1000 to the layer's
    # child "inner", open at 3100), 3630 outside
    assert got["decode_glue_idle_share"] == pytest.approx(3630 / 6030 * 100)
    # warm 0.5 s and calibrate 0.25 s over a 10 s window
    assert got["warmup_share"] == pytest.approx(7.5)


def test_idle_put_down_sums_to_the_idle(program):
    calls = spans.traced_calls(_run())
    gaps = spans.idle_by_span(calls)
    _, _, idle = spans.decode_idle(calls)
    assert sum(us for _, _, us in gaps) == pytest.approx(idle)
    assert idle == pytest.approx(6030)
    by_name = {}
    for _, s, us in gaps:
        by_name[s.name] = by_name.get(s.name, 0.0) + us
    # the first step's first operation laid at the decode's opening, the
    # last one's end 150 us before the decode span's end
    assert by_name == pytest.approx({
        "model.embed": 380, "inner": 1000,
        "model.layer": 200 + 1000 + 200, "model.head": 1200 + 1200,
        "engine.sample": 320 + 30 + 320 + 30, "engine.decode": 150})


def test_without_detail_spans_or_a_trace(program):
    program["spans"] = _spans(detail=False)
    got = _read(_run())
    # the decode is laid from its span's opening at the trace's rate: the
    # same operations, 1.01 times as long (8970 us of them)
    assert got["decode_launches_per_step"] == 6.0
    assert got["decode_idle_us_per_launch"] == pytest.approx(
        (15000 - 1.01 * 8970) / 12)
    assert got["decode_glue_idle_share"] is None
    got = _read({"traces": [], "wall_s": 10.0})
    assert [got[n] for n in NAMES[:3]] == [None] * 3
    assert got["warmup_share"] == pytest.approx(7.5)


def test_none_when_the_clocks_disagree_or_the_decode_is_not_found(program):
    # every operation a second late: in no call
    assert [_read(_run(_ops(shift=1e6)))[n] for n in NAMES[:3]] == \
        [None] * 3
    # a clock running 10 % fast: each step laid by its own span, the
    # same values
    got = _read(_run(_ops(rate=1.1)))
    assert got["decode_launches_per_step"] == 6.0
    assert got["decode_idle_us_per_launch"] == pytest.approx(502.5)
    # three steps recorded, two in the trace
    program["spans"] = _spans(steps=3)
    assert _read(_run())["decode_launches_per_step"] is None


def test_none_with_a_dropped_span_or_no_run(program, monkeypatch):
    monkeypatch.setattr(trace, "dropped", 1)
    assert all(v is None for v in _read(_run()).values())
    # spans lost before the run opened leave the run's whole
    root = next(s for s in program["spans"] if s.name == "session.run_live")
    root.attrs["dropped"] = 1
    assert all(v is not None for v in _read(_run()).values())
    monkeypatch.setattr(trace, "dropped", 2)
    assert all(v is None for v in _read(_run()).values())
    monkeypatch.setattr(trace, "dropped", 0)
    program["spans"] = [s for s in _spans() if s.name != "session.run_live"]
    assert all(v is None for v in _read(_run()).values())


def test_none_from_a_program_without_the_recorder(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    assert all(v is None for v in _read(_run()).values())


def _long_call(steps=12, k=50, displace=None, anchor_off=None, jump=None):
    """Spans and a trace of one call of ``steps`` decode steps of ``k``
    operations, each step 10 ms on the host, one operation every 196 us
    from 100 us after its step opened; ``displace`` = (step, index, us)
    moves one operation's stamps, ``anchor_off`` = (step, us) a step's
    first operation, ``jump`` = (step, us) every operation from that
    step's on."""
    s = [_span(1, 0, "session.run_live", -4e6, 6e6, dropped=0),
         _span(6, 1, "engine.serve", 0, 1000 + steps * 1e4 + 500,
               purpose="serve", unix_ns=UNIX_NS),
         _span(7, 6, "engine.prefill", 0, 900),
         _span(8, 6, "engine.decode", 1000, 1000 + steps * 1e4,
               steps=steps)]
    ops = [("prefill", 100, 800), ("argmax", 850, 860), ("cast", 870, 880)]
    for i in range(steps):
        a = 1000 + i * 1e4
        s.append(_span(100 + 2 * i, 8, "engine.step", a, a + 1e4, step=i))
        s.append(_span(101 + 2 * i, 100 + 2 * i, "model.layer", a + 50,
                       a + 1e4 - 50, index=0))
        for j in range(k):
            b = a + 100 + 196 * j
            if displace and (i, j) == displace[:2]:
                b += displace[2]
            if anchor_off and (i, j) == (anchor_off[0], 0):
                b += anchor_off[1]
            if jump and i >= jump[0]:
                b += jump[1]
            ops.append((f"op{j}", b, b + 40))
    end = 1000 + steps * 1e4
    ahead = jump[1] if jump else 0.0
    ops[-1] = (ops[-1][0], ops[-1][1], end - 50 + ahead)
    ops += [("cat", end + 100 + ahead, end + 120 + ahead),
            ("Memcpy DtoH", end + 200 + ahead, end + 300 + ahead)]
    ops = sorted(((n, BASE_US + 300 + 1.002 * b, BASE_US + 300 + 1.002 * e)
                  for n, b, e in ops), key=lambda op: op[1])
    return sorted(s, key=lambda x: x.end), ops


def test_decode_blocks_despite_an_operation_out_of_place():
    _, ops = _long_call(steps=100, displace=(50, 10, 1030.0))
    blocks = spans.decode_blocks(ops, 100)
    assert blocks is not None and [len(b) for b in blocks] == [50] * 100
    assert spans.decode_blocks(_long_call(steps=100)[1], 100) is not None


def test_an_anchor_out_of_place_is_left_out(program):
    got = {}
    for off in (0.0, 400.0):
        program["spans"], ops = _long_call(steps=30, anchor_off=(5, off))
        got[off] = _read(_run(ops))
    # one step's first operation 400 us late (a rate of 0.96 from the
    # step before): its anchor is left out, the count stands, and the
    # idle differs only near that step
    assert got[400.0]["decode_launches_per_step"] == 50.0
    assert got[400.0]["decode_idle_us_per_launch"] == pytest.approx(
        got[0.0]["decode_idle_us_per_launch"], rel=0.01)
    # outside the layers: 356 us before each step's first operation but
    # the first's (laid at the decode's opening), 150 us after the last
    glue = 29 * 356 + 150
    assert got[0.0]["decode_glue_idle_share"] == pytest.approx(
        glue / (glue + 30 * 49 * 156) * 100)


def test_a_jump_of_the_trace_clock_is_spread_over_its_step(program):
    program["spans"], ops = _long_call(steps=30)
    before = _read(_run(ops))
    # the trace's clock 3 ms ahead from step 15 on (a rate of 0.77 from
    # step 14 to 15, 1.002 on either side): every step kept, step 14's
    # operations laid closer together
    program["spans"], ops = _long_call(steps=30, jump=(15, 3000.0))
    got = _read(_run(ops))
    assert got["decode_launches_per_step"] == 50.0
    assert got["decode_idle_us_per_launch"] == pytest.approx(
        before["decode_idle_us_per_launch"], rel=0.01)
    assert got["decode_glue_idle_share"] is not None
