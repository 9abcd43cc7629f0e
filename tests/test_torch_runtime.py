"""The runtime substrate (``repro_torch.data``, ``repro_torch.runtime``)
against the JAX package: pipeline batches, checkpoints in both
directions, failure recovery, the failure injector and the straggler
detector.

Batches and injector draws are numpy-seeded in both packages, so they are
held bit for bit; a checkpoint round trip is bitwise; the port restores a
checkpoint the reference wrote (bf16 parameters and int8 moments
included) bit for bit, and its next step's loss and grad norm match the
reference's within one bf16 step (rtol 2^-8): the model is bf16 there,
and the two frameworks round bf16 at different points.  Recovery on the
CPU (one torch thread) is bit for bit equal to an uninterrupted run.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import DEFAULT_TUNABLES as J_DEFAULT
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.base import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.optim.adamw import OptConfig as JOptConfig
from repro.runtime.checkpoint import CheckpointManager as JCheckpointManager
from repro.runtime.fault import StragglerDetector as JStragglerDetector
from repro.train.step import init_train_state as j_init
from repro.train.step import make_train_step as j_make
from repro_torch.configs.base import DEFAULT_TUNABLES, ShapeSpec, reduced
from repro_torch.configs.registry import get_config
from repro_torch.convert import train_state_from_jax
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime.checkpoint import (CheckpointManager, _flatten,
                                            _paths, load_snapshot,
                                            save_snapshot)
from repro_torch.runtime.fault import (FailureInjector, SimulatedNodeFailure,
                                       StragglerDetector)
from repro_torch.runtime.loop import Trainer
from repro_torch.train.step import init_train_state, make_train_step
from torch_parity import to_torch  # noqa: F401 (one torch thread)

SMALL = dict(n_layers=2, vocab=256)
CFG = reduced(get_config("qwen2-1.5b")).replace(**SMALL)
J_CFG = j_reduced(j_get_config("qwen2-1.5b")).replace(**SMALL)
SHAPE = ShapeSpec("t", 64, 4, "train")
OC = OptConfig(lr=1e-3, warmup=2)


def _equal_trees(a, b):
    """Same key paths, and at each the same dtype and bits."""
    pa, pb = dict(_paths(a)), dict(_paths(b))
    assert sorted(pa) == sorted(pb)
    for k, x in pa.items():
        y = pb[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert x == y, k


# -- the data pipeline ----------------------------------------------------------


def test_pipeline_batches_bit_equal_to_reference_and_resumable():
    jp = JTokenPipeline(J_CFG, JShapeSpec("t", 64, 4, "train"), seed=5)
    pp = TokenPipeline(CFG, SHAPE, seed=5, device="cpu")
    try:
        for step in (0, 1, 7):
            want, got = jp._make(step), pp._make(step)
            assert sorted(want) == sorted(got) == ["mask", "targets",
                                                   "tokens"]
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert np.array_equal(got[k], want[k])
        batches = [pp.next() for _ in range(3)]
        assert batches[0]["tokens"].dtype == torch.int32
        assert np.array_equal(batches[2]["targets"].numpy(),
                              jp._make(2)["targets"])
        st = pp.state()
        nxt = pp.next()
    finally:
        jp.close()
        pp.close()
    assert st == {"seed": 5, "step": 3}
    p2 = TokenPipeline.restore(CFG, SHAPE, st, device="cpu")
    try:
        assert torch.equal(p2.next()["tokens"], nxt["tokens"])
        assert p2.host_wait_s >= 0.0
    finally:
        p2.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TokenPipeline(CFG, SHAPE)


# -- checkpoints ------------------------------------------------------------------


def _bf16_int8_state():
    cfg = CFG.replace(dtype="bfloat16")
    oc = OptConfig(moments_dtype="int8")
    state = init_train_state(torch.Generator().manual_seed(0), cfg, oc,
                             DEFAULT_TUNABLES.replace(grad_compression=True))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 256, (4, 32))
                                        .astype(np.int32)),
             "targets": torch.from_numpy(rng.integers(0, 256, (4, 32))
                                         .astype(np.int32)),
             "mask": torch.ones(4, 32)}
    step = make_train_step(cfg, oc, DEFAULT_TUNABLES.replace(
        grad_compression=True), device="cpu")
    return step(state, batch)[0]


def test_checkpoint_roundtrip_bitwise_with_reference_keys(tmp_path):
    state = _bf16_int8_state()
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(7, state, {"pipeline": {"seed": 0, "step": 7}})
    restored, meta = mgr.restore(state)
    assert meta["step"] == 7 and meta["pipeline"] == {"seed": 0, "step": 7}
    _equal_trees(restored, state)
    keys = set(np.load(tmp_path / "step_00000007" / "arrays.npz").files)
    assert {"params/layers/attn/wq", "opt/m/layers/attn/wq/0",
            "opt/m/layers/attn/wq/1", "opt/count", "ef/embed"} <= keys
    flat = _flatten(state)
    assert flat["params/embed"].dtype == np.dtype("V2")   # bf16 as numpy
    assert flat["opt/count"].dtype == np.int32            # stores them


def test_checkpoint_keep_k_gc(tmp_path):
    state = init_train_state(torch.Generator().manual_seed(0), CFG, OC,
                             DEFAULT_TUNABLES)
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    (tmp_path / "step_00000009.tmp").mkdir()        # a torn save: ignored
    assert mgr.steps() == [3, 4]
    assert CheckpointManager(tmp_path / "empty").restore(state) == (None,
                                                                    None)


def test_port_restores_a_reference_checkpoint_and_steps_like_it(tmp_path):
    cfg_j = J_CFG.replace(dtype="bfloat16")
    joc = JOptConfig(lr=1e-3, warmup=0, moments_dtype="int8")
    tun = J_DEFAULT.replace(attn_impl="xla")
    state = j_init(jax.random.PRNGKey(0), cfg_j, joc, tun)
    rng = np.random.default_rng(1)
    batches = [{"tokens": rng.integers(0, 256, (4, 32)).astype(np.int32),
                "targets": rng.integers(0, 256, (4, 32)).astype(np.int32),
                "mask": np.ones((4, 32), np.float32)} for _ in range(2)]
    jstep = jax.jit(j_make(cfg_j, joc, tun))
    state, _ = jstep(state, batches[0])
    JCheckpointManager(tmp_path).save(1, state, {"pipeline": {"seed": 0,
                                                              "step": 1}})
    _, jmetrics = jstep(state, batches[1])

    cfg = CFG.replace(dtype="bfloat16")
    oc = OptConfig(lr=1e-3, warmup=0, moments_dtype="int8")
    want = train_state_from_jax(jax.tree_util.tree_map(np.asarray, state),
                                device="cpu")
    template = init_train_state(torch.Generator().manual_seed(1), cfg, oc,
                                DEFAULT_TUNABLES)
    restored, meta = CheckpointManager(tmp_path).restore(template)
    assert meta["step"] == 1
    _equal_trees(restored, want)
    assert restored["params"]["embed"].dtype == torch.bfloat16
    assert restored["opt"]["m"]["embed"][0].dtype == torch.int8
    _, metrics = make_train_step(cfg, oc, DEFAULT_TUNABLES.replace(
        attn_impl="xla"), device="cpu")(
        restored, {k: torch.from_numpy(v) for k, v in batches[1].items()})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=2 ** -8)


def test_snapshot_roundtrip(tmp_path):
    arrays = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "b": torch.ones(2, dtype=torch.bfloat16), "n": 3}
    path = save_snapshot(tmp_path / "s.npz", arrays, {"x": np.int64(4)})
    got, meta = load_snapshot(path)
    assert meta == {"x": 4} and int(got["n"]) == 3
    assert np.array_equal(got["a"], arrays["a"].numpy())
    assert got["b"].dtype == np.dtype("V2")
    with pytest.raises(ValueError, match="reserved"):
        save_snapshot(tmp_path / "t.npz", {"__meta__": np.zeros(1)}, {})


# -- failures and stragglers --------------------------------------------------------


def test_failure_recovery_equals_uninterrupted_run_bit_for_bit(tmp_path):
    """Crash + restore + replay lands on the same trajectory as a run with
    no failure, bit for bit on the CPU."""
    r1 = Trainer(CFG, SHAPE, OC, DEFAULT_TUNABLES, ckpt_dir=tmp_path / "a",
                 ckpt_every=4, seed=3, device="cpu")
    t2 = Trainer(CFG, SHAPE, OC, DEFAULT_TUNABLES, ckpt_dir=tmp_path / "b",
                 ckpt_every=4, seed=3, device="cpu",
                 injector=FailureInjector(fail_steps=(6,)))
    rep1, rep2 = r1.run(12), t2.run(12)
    assert rep2.failures_recovered == 1 and rep2.steps_done == 12
    # steps 4 and 5 ran twice: before the failure and on replay
    assert rep2.losses[-8:] == rep1.losses[4:]
    _equal_trees(t2.state, r1.state)


def _fired(inj, n):
    out = []
    for step in range(n):
        try:
            inj.check(step)
        except SimulatedNodeFailure:
            out.append(step)
    return out


def test_failure_injector_schedule_rate_and_reset():
    inj = FailureInjector(fail_steps=(3, 7))
    assert _fired(inj, 10) == [3, 7] and _fired(inj, 10) == []
    assert inj.journal == [{"step": 3, "mode": "scheduled"},
                           {"step": 7, "mode": "scheduled"}]
    from repro.runtime.fault import FailureInjector as JFailureInjector
    from repro.runtime.fault import SimulatedNodeFailure as JFailure
    j = JFailureInjector(rate=0.05, seed=11)
    want = []
    for step in range(400):
        try:
            j.check(step)
        except JFailure:
            want.append(step)
    assert _fired(FailureInjector(rate=0.05, seed=11), 400) == want != []
    restored = FailureInjector(fail_steps=(2, 6), rate=1.0, seed=0)
    restored.reset(fired=(0, 1, 2, 3))
    assert _fired(restored, 8) == [4, 5, 6, 7]


def test_straggler_detector_matches_reference():
    rng = np.random.default_rng(0)
    times = list(0.10 + 0.001 * (np.arange(40) % 3)) + [0.50] + list(
        0.30 + 0.001 * (np.arange(41, 80) % 3)) + list(
        0.2 + 0.01 * rng.random(40))
    det = StragglerDetector(window=8, spike_factor=3.0, device="cpu")
    ref = JStragglerDetector(window=8, spike_factor=3.0)
    got = [det.observe(i, float(t)) for i, t in enumerate(times)]
    want = [ref.observe(i, float(t)) for i, t in enumerate(times)]
    assert got == want
    kinds = {e["kind"] for e in det.events}
    assert kinds == {"spike", "sustained"}
    with pytest.raises(ValueError, match="retention"):
        StragglerDetector(window=8, retention=16, device="cpu")


def test_plugin_counts_a_node_failure_as_an_executor_fault():
    from repro.core.plugin import _executor_fault_types as j_types
    from repro_torch.core.plugin import _executor_fault_types
    assert SimulatedNodeFailure in _executor_fault_types()
    assert [t.__name__ for t in _executor_fault_types()] == [
        t.__name__ for t in j_types()]
