"""The reader of ``ssm_step_kernel_share`` on hand-made spans and device
operations of one traced call, whose decode was replayed (no detail
spans), with the values worked out by hand; and None for a model without
SSM layers, without traces, or for a program without the kernel."""
import importlib.util
from types import SimpleNamespace

import pytest

from kbench import harness
from kbench.tests.tiny import REPO
from repro_torch.runtime import trace

T0 = 1000.0           # the traced call's start, host seconds
UNIX_NS = 10 ** 12    # its anchor on the trace's clock
BASE_US = UNIX_NS / 1e3
STEPS = 3
SSM = {"family": "ssm", "layers": 2}


def _span(i, parent, name, a, b, **attrs):
    return SimpleNamespace(id=i, parent=parent, name=name,
                           start=T0 + a / 1e6, end=T0 + b / 1e6,
                           attrs=attrs)


def _spans():
    s = [_span(1, 0, "session.run_live", -4e6, 6e6, dropped=0),
         _span(2, 1, "executor.window", -3e6, 2e6, window=0),
         _span(3, 2, "engine.serve", 0, 20000, purpose="serve",
               unix_ns=UNIX_NS),
         _span(4, 3, "engine.prefill", 0, 2000),
         _span(5, 3, "engine.decode", 2000, 17000, steps=STEPS,
               graph=True)]
    return sorted(s, key=lambda x: x.end)


def _layer(kernel):
    """One SSM layer's decode operations: the input norm, in_proj, the
    mixer (``kernel`` and the norm kernel, or the plain step's), out_proj
    and the residual add."""
    mixer = ([kernel, "ssm_decode_norm"] if kernel else
             ["cat", "einsum", "add", "softplus", "exp", "mul", "copy"])
    return ["rmsnorm", "nvjet_in_proj", *mixer, "nvjet_out_proj", "add"]


def _ops(layers):
    """A prefill, the first token's sample, ``STEPS`` equal decode steps
    (embed, ``layers``, head, argmax, cast, the position's add), then the
    tokens' copy; 10 us apart on the trace's clock."""
    step = ["embed", *[n for k in layers for n in _layer(k)], "head",
            "argmax", "cast", "add_pos"]
    names = ["ssd_fwd_mma", "argmax", "cast", *step * STEPS, "Memcpy DtoH"]
    t = BASE_US + 2100.0
    return [(n, t + 10 * i, t + 10 * i + 5) for i, n in enumerate(names)]


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setattr(trace, "snapshot", _spans)
    monkeypatch.setattr(trace, "dropped", 0)


def _read(layers, model=SSM, traced=True):
    run = {"traces": [{"ops": _ops(layers)}] if traced else [],
           "wall_s": 10.0, "model": model}
    return harness.load_reader(REPO, "ssm_step_kernel_share")(run)


def test_every_layer_on_the_kernel_reads_100(program):
    assert _read(["ssm_decode_step<__nv_bfloat16>"] * 2) == 100.0


def test_a_layer_on_the_plain_step_reads_a_partial_share(program):
    assert _read(["ssm_decode_step<float>", None]) == pytest.approx(50.0)
    assert _read([None, None]) == 0.0


def test_a_kernel_named_ssd_fwd_is_not_counted(program):
    assert _read(["ssd_fwd_step", "ssm_decode_step<float>"]) == \
        pytest.approx(50.0)


def test_none_without_ssm_layers_traces_or_the_kernel(program, monkeypatch):
    assert _read(["ssm_decode_step"] * 2, model={"family": "dense",
                                                 "layers": 2}) is None
    assert _read(["ssm_decode_step"] * 2, traced=False) is None
    find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None if
                        name == "repro_torch.kernels.ssm_step" else find(name))
    assert _read(["ssm_decode_step"] * 2) is None
