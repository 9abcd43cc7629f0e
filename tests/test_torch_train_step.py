"""The train step (``repro_torch.train.step``) against the JAX package on
converted weights: ``reduced()`` qwen2, mamba2 and zamba2 at two layers
(zamba2 with a shared block before each, ``hybrid_period=1``), the same
numpy-seeded batch, both ``attn_impl`` routes (the reference's pallas
route in interpret mode), fp32 and int8 moments, two microbatches with a
bf16 accumulator, and error-feedback gradient compression.

Tolerances, fp32 models:
* loss, ce, grad norm: rtol 1e-5; every gradient leaf: rtol 1e-4 and
  atol 1e-6 (measured: 7e-6 relative at most; autograd and XLA sum in
  other orders);
* one step's parameters: within 2·lr of the reference everywhere (AdamW's
  first step is lr·g/|g|, plus decay) and within 1e-6 wherever the
  reference's gradient is above 1e-6 in size: below, it is float noise
  about 0 (the key bias's gradient is 0 in exact arithmetic, softmax
  being blind to a shift of every logit), and g/|g| may flip;
* int8 moments: codes at most one apart, scales rtol 1e-4 (the codes
  round m/s, and m carries the gradients' float noise);
* compression: the error-feedback buffer atol 1e-6, and one int8 step
  of its tensor at entries whose gradient, over that step, lies within
  1e-3 of a half-integer, where the float noise picks the code; the
  parameters' tight bound leaves those entries out too.
The remat policies are held to each other exactly: recompute repeats the
same operations on the same inputs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import Tunables as JTunables
from repro.configs.base import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.models import model as JM
from repro.optim.adamw import OptConfig as JOptConfig
from repro.train.step import init_train_state as j_init
from repro.train.step import make_train_step as j_make
from repro_torch.configs.base import Tunables, reduced
from repro_torch.configs.registry import get_config
from repro_torch.convert import train_state_from_jax
from repro_torch.models import model as M
from repro_torch.optim.adamw import OptConfig, tree_leaves
from repro_torch.train.step import (init_train_state, loss_and_grads,
                                    make_train_step)
from torch_parity import to_torch  # noqa: F401 (one torch thread)

LR = 1e-3
B, S = 4, 64
SMALL = {"qwen2-1.5b": dict(n_layers=2, vocab=256),
         "mamba2-1.3b": dict(n_layers=2, vocab=256),
         "zamba2-7b": dict(n_layers=2, hybrid_period=1, vocab=256)}
# (arch, attn_impl, tunables, opt config)
CASES = [(arch, impl, {}, {}) for arch in SMALL for impl in ("xla", "pallas")]
CASES += [("qwen2-1.5b", "xla", {}, {"moments_dtype": "int8"}),
          ("mamba2-1.3b", "pallas", {}, {"moments_dtype": "int8"}),
          ("qwen2-1.5b", "pallas", {"microbatches": 2,
                                    "accum_dtype": "bfloat16"}, {}),
          ("zamba2-7b", "xla", {"grad_compression": True}, {})]


def _ids(case):
    arch, impl, tun, oc = case
    return "-".join([arch.split("-")[0], impl]
                    + [f"{k}={v}" for k, v in {**tun, **oc}.items()])


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (B, S)).astype(np.int32),
            "targets": rng.integers(0, 256, (B, S)).astype(np.int32),
            "mask": (rng.random((B, S)) > 0.1).astype(np.float32)}


def _configs(arch, impl, tun, oc):
    kw = dict(attn_impl=impl, ssm_chunk=16, **tun)
    ocw = dict(lr=LR, warmup=0, **oc)
    return ((j_reduced(j_get_config(arch)).replace(**SMALL[arch]),
             JTunables(**kw), JOptConfig(**ocw)),
            (reduced(get_config(arch)).replace(**SMALL[arch]),
             Tunables(**kw), OptConfig(**ocw)))


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The reference's state, loss and grads, and one jitted train step,
    as numpy (computed once per case for the module)."""
    arch, impl, tun, oc = case
    (jcfg, jt, joc), _ = _configs(arch, impl, dict(tun), dict(oc))
    state = j_init(jax.random.PRNGKey(0), jcfg, joc, jt)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}

    def run(st, b):
        (loss, mt), g = jax.value_and_grad(
            lambda p: JM.loss_fn(p, jcfg, b, jt), has_aux=True)(st["params"])
        return loss, mt, g, j_make(jcfg, joc, jt)(st, b)
    out = jax.jit(run)(state, batch)
    return jax.tree_util.tree_map(np.asarray, (state, out))


def _freeze(case):
    arch, impl, tun, oc = case
    return arch, impl, tuple(tun.items()), tuple(oc.items())


def _port(case):
    arch, impl, tun, oc = case
    _, (cfg, pt, poc) = _configs(arch, impl, tun, oc)
    state, _ = _reference(_freeze(case))
    return cfg, pt, poc, train_state_from_jax(state, device="cpu")


def _int8_ties(grad):
    """(entries of ``grad`` whose int8 code is a near tie, the tensor's
    int8 step); the first step's error-feedback buffer is 0, so the
    compressed tensor is ``grad`` itself."""
    step = max(np.abs(grad).max() / 127.0, 1e-20)
    r = grad / step
    return np.abs(np.abs(r - np.floor(r)) - 0.5) <= 1e-3, step


def _assert_params(new, want, grad, lr, compressed=False):
    d = np.abs(new.float().numpy() - np.asarray(want, np.float32))
    assert d.max(initial=0) <= 2 * lr * 1.01, d.max()
    signal = np.abs(grad) > 1e-6
    if compressed:
        signal &= ~_int8_ties(grad)[0]
    assert d[signal].max(initial=0) <= 1e-6, d[signal].max()


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_loss_grads_and_one_step_match_reference(case):
    _, impl, tun, oc = case
    cfg, pt, poc, state = _port(case)
    _, (jloss, jmt, jgrads, (jstate, jmetrics)) = _reference(_freeze(case))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}

    loss, mt, grads = loss_and_grads(state["params"], cfg, batch, pt)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    np.testing.assert_allclose(float(mt["ce"]), jmt["ce"], rtol=1e-5)
    for g, jg in zip(tree_leaves(grads), jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-6)

    new, metrics = make_train_step(cfg, poc, pt, device="cpu")(state, batch)
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), jmetrics[k],
                                   rtol=1e-5, atol=1e-7)
    assert float(metrics["lr"]) == float(jmetrics["lr"])
    for p, jp, jg in zip(tree_leaves(new["params"]),
                         jax.tree_util.tree_leaves(jstate["params"]),
                         jax.tree_util.tree_leaves(jgrads)):
        _assert_params(p, jp, jg, LR, compressed=pt.grad_compression)
    assert new["opt"]["count"] == int(jstate["opt"]["count"]) == 1
    jm = jax.tree_util.tree_leaves(jstate["opt"]["m"])
    pm = [t for leaf in tree_leaves(new["opt"]["m"])
          for t in (leaf if isinstance(leaf, tuple) else (leaf,))]
    assert len(pm) == len(jm)
    if poc.moments_dtype == "int8":
        for (q, s), (jq, js) in zip(zip(pm[::2], pm[1::2]),
                                    zip(jm[::2], jm[1::2])):
            assert q.dtype == torch.int8
            assert np.abs(q.numpy().astype(int) - jq.astype(int)).max() <= 1
            np.testing.assert_allclose(s.numpy(), js, rtol=1e-4)
    if "ef" in jstate:
        for e, je, jg in zip(tree_leaves(new["ef"]),
                             jax.tree_util.tree_leaves(jstate["ef"]),
                             jax.tree_util.tree_leaves(jgrads)):
            ties, step = _int8_ties(jg)
            d = np.abs(e.numpy() - je)
            assert d[~ties].max(initial=0) <= 1e-6
            assert d[ties].max(initial=0) <= step * 1.001 + 1e-6


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", list(SMALL))
def test_remat_policies_give_equal_loss_and_grads(arch, impl):
    case = (arch, impl, {}, {})
    cfg, pt, _, state = _port(case)
    batch = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    ref = None
    for remat in ("none", "dots", "full"):
        loss, _, grads = loss_and_grads(state["params"], cfg, batch,
                                        pt.replace(remat=remat))
        got = [loss] + tree_leaves(grads)
        if ref is None:
            ref = got
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), remat


@pytest.mark.parametrize("arch,owner,name", [
    ("qwen2-1.5b", "transformer", "block_apply"),
    ("mamba2-1.3b", "ssm_lm", "_ssm_block")])
def test_remat_policies_recompute_each_layer_once(arch, owner, name,
                                                  monkeypatch):
    """Under "dots" and "full" the backward runs every layer body again
    (a recompute), under "none" and without grad it does not."""
    import importlib
    module = importlib.import_module(f"repro_torch.models.{owner}")
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg, pt, _, state = _port((arch, "pallas", {}, {}))
    batch = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    for remat, runs in (("none", 1), ("dots", 2), ("full", 2)):
        calls.clear()
        loss_and_grads(state["params"], cfg, batch, pt.replace(remat=remat))
        assert len(calls) == runs * cfg.n_layers, remat
    calls.clear()
    with torch.no_grad():
        M.loss_fn(state["params"], cfg, batch, pt.replace(remat="full"))
    assert len(calls) == cfg.n_layers


def test_train_step_leaves_its_input_state_as_it_was():
    case = ("mamba2-1.3b", "pallas", {}, {"moments_dtype": "int8"})
    cfg, pt, poc, state = _port(case)
    before = [t.clone() for leaf in tree_leaves(state)
              for t in (leaf if isinstance(leaf, tuple) else (leaf,))
              if isinstance(t, torch.Tensor)]
    step = make_train_step(cfg, poc, pt, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    a, _ = step(state, batch)
    b, _ = step(state, batch)
    after = [t for leaf in tree_leaves(state)
             for t in (leaf if isinstance(leaf, tuple) else (leaf,))
             if isinstance(t, torch.Tensor)]
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert state["opt"]["count"] == 0
    assert all(torch.equal(x, y) for x, y in
               zip(tree_leaves(a["params"]), tree_leaves(b["params"])))


def test_init_and_device_rule():
    cfg = reduced(get_config("qwen2-1.5b")).replace(**SMALL["qwen2-1.5b"])
    tun = Tunables(grad_compression=True)
    state = init_train_state(torch.Generator().manual_seed(0), cfg,
                             OptConfig(moments_dtype="bfloat16"), tun)
    assert set(state) == {"params", "opt", "ef"}
    leaf = state["opt"]["m"]["layers"]["attn"]["wq"]
    assert leaf.dtype == torch.bfloat16 and not leaf.any()
    assert state["ef"]["embed"].dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_train_step(cfg, OptConfig(), tun)
    step = make_train_step(cfg, OptConfig(), tun, device="meta")
    with pytest.raises(ValueError, match="state lies on cpu"):
        step(state, {})
