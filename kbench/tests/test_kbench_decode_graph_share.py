"""The reader of ``decode_graph_share`` on hand-made spans, with the
values worked out by hand; and None where the program records no spans
or its decode spans carry no ``graph`` attribute (a program without the
decode graph)."""
from types import SimpleNamespace

import pytest

from kbench import harness
from kbench.tests.tiny import REPO
from repro_torch.runtime import trace


def _span(i, parent, name, **attrs):
    return SimpleNamespace(id=i, parent=parent, name=name, start=float(i),
                           end=float(i) + 0.5, attrs=attrs)


def _spans(graph=(True, False, True, True)):
    """A run: a warm serve of 1 step, a calibration serve of 12, a trial's
    serve of 12 and a committed serve of 20, the first eager."""
    s = [_span(1, 0, "session.run_live", dropped=0),
         _span(2, 1, "executor.window", window=0)]
    for j, (steps, purpose) in enumerate(((1, "warm"), (12, "calibrate"),
                                          (12, "serve"), (20, "serve"))):
        i = 10 + 3 * j
        s += [_span(i, 2, "engine.serve", purpose=purpose, steps=steps),
              _span(i + 1, i, "engine.prefill"),
              _span(i + 2, i, "engine.decode", steps=steps,
                    **({} if graph is None else {"graph": graph[j]}))]
    # a serve outside the run (set-up's) is not counted
    s.append(_span(40, 0, "engine.decode", steps=50, graph=False))
    return s


@pytest.fixture
def program(monkeypatch):
    state = {"spans": _spans()}
    monkeypatch.setattr(trace, "snapshot", lambda: list(state["spans"]))
    monkeypatch.setattr(trace, "dropped", 0)
    return state


def _read():
    return harness.load_reader(REPO, "decode_graph_share")(
        {"traces": [], "wall_s": 10.0})


def test_share_by_hand(program):
    # 1 + 12 + 20 of 45 steps replayed
    assert _read() == pytest.approx(33 / 45 * 100)
    program["spans"] = _spans(graph=(False, True, True, True))
    assert _read() == pytest.approx(44 / 45 * 100)
    program["spans"] = _spans(graph=(False,) * 4)
    assert _read() == 0.0


def test_none_without_the_graph_attribute_or_spans(program, monkeypatch):
    program["spans"] = _spans(graph=None)
    assert _read() is None
    program["spans"] = [s for s in _spans()
                        if s.name != "session.run_live"]
    assert _read() is None
    program["spans"] = _spans()[:2]
    assert _read() is None
    program["spans"] = _spans()
    monkeypatch.setattr(trace, "dropped", 1)
    assert _read() is None
