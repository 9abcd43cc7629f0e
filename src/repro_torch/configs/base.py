"""Config system: model configs, input-shape specs, runtime tunables.

Port of ``repro/configs/base.py`` (numpy; copied).  Every architecture has
a ``configs/<id>.py`` exposing ``CONFIG``; ``registry.get_config(name)``
resolves them and ``reduced(cfg)`` derives the smoke-test-sized variant of
the same family.  The model families the port runs so far are listed in
``repro_torch/models/model.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_expert: int = 1024          # per-expert FFN hidden size
    num_shared: int = 0           # always-on shared experts (deepseek)
    dense_ff: int = 0             # parallel dense residual FFN (arctic); 0 = none
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    first_layer_dense: bool = False  # deepseek: layer 0 is a dense FFN


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64            # P: channels per SSD head
    n_groups: int = 1
    chunk: int = 256              # SSD chunk length (a KERMIT tunable)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"         # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float = 0.0     # 0 = off (gemma2: 50.)
    final_softcap: float = 0.0    # 0 = off (gemma2: 30.)
    window: int = 0               # sliding-window size; 0 = full
    window_pattern: str = "none"  # none | alternating (gemma2: local/global)
    rope_theta: float = 10000.0
    scale_embed: bool = False     # gemma-family sqrt(d_model) embedding scale
    tie_embeddings: bool = True
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_period: int = 0        # zamba2: shared attn block every N ssm layers
    lora_rank: int = 0            # zamba2: per-invocation LoRA on shared block
    enc_layers: int = 0           # encdec: number of encoder layers
    num_patches: int = 0          # vlm: stub-frontend patch-embedding count
    frontend: str = "none"        # none | vision_stub | audio_stub
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Megatron-style vocab padding so embeddings shard over model x data."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context (state/linear-cost archs)?"""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant: same family/features, tiny dims."""
    kw = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.hybrid_period == 0 else 2 * max(cfg.hybrid_period, 1)),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        d_ff=256,
        vocab=512,
        head_dim=32,
        dtype="float32",
    )
    if cfg.hybrid_period:
        kw["n_layers"] = 2 * cfg.hybrid_period  # exercise >=2 shared-block hits
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            d_expert=128,
            dense_ff=128 if cfg.moe.dense_ff else 0,
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=32, head_dim=32, chunk=32)
    if cfg.enc_layers:
        kw["enc_layers"] = 2
        kw["n_layers"] = 2
    if cfg.num_patches:
        kw["num_patches"] = 16
    if cfg.window:
        kw["window"] = 64
    if cfg.lora_rank:
        kw["lora_rank"] = 8
    return cfg.replace(**kw)


# ---------------------------------------------------------------------------
# Input-shape specs (assigned): every arch is paired with all four
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def supports(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    """Cell-skip rules (see DESIGN.md §Cell skips)."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


# ---------------------------------------------------------------------------
# Runtime tunables — the knob vector KERMIT's Explorer searches.
# This is the TPU analogue of the Spark/Hadoop configuration settings.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Tunables:
    microbatches: int = 1             # gradient-accumulation steps
    accum_dtype: str = "float32"      # grad-accumulation buffer (bf16 halves it)
    remat: str = "dots"               # none | dots | full
    seq_parallel: bool = False        # shard residual seq over 'model'
    capacity_factor: float = 1.25     # MoE dispatch capacity
    ssm_chunk: int = 256              # SSD chunk length
    grad_compression: bool = False    # int8+EF on cross-pod reduce
    donate: bool = True
    prefetch: int = 2                 # host pipeline depth
    attn_impl: str = "auto"           # auto | xla | pallas
    attn_q_chunk: int = 1024          # chunked-attention query block
    attn_unroll: bool = False         # unroll q-chunk loop (cost probes)
    layer_unroll: bool = False        # unroll layer scans (cost probes)
    zero3: bool = True                # shard params over 'data' too (FSDP)
    # -- serving knobs (kermit/serving; ignored by the training path) -------
    serve_batch: int = 8              # decode batch size (requests per call)
    prefill_chunk: int = 0            # prefill q-chunk override; 0 = inherit
    cache_len: int = 0                # KV capacity rounding multiple; 0 = exact
    cache_dtype: str = "auto"         # KV storage dtype; auto = model dtype

    def replace(self, **kw) -> "Tunables":
        return dataclasses.replace(self, **kw)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# Default ("rule-of-thumb") configuration, i.e. the paper's J^D.
DEFAULT_TUNABLES = Tunables()


# ---------------------------------------------------------------------------
# Struct-of-arrays codec for Tunables batches.
#
# The Plan phase's batched candidate evaluation (Explorer + BatchExecutor)
# prices whole candidate grids in one vectorized dispatch; that needs the
# discrete knob vector in device-array form.  Encoding rules, derived from
# the field's default value type:
#
#   str   -> int32 index into TUNABLE_CATEGORIES[field] (the fixed vocab)
#   bool  -> int32 {0, 1}
#   int   -> int32
#   float -> float64 (exact round-trip; cost models cast at their boundary)
#
# ``arrays_to_tunables(tunables_to_arrays(ts)) == ts`` exactly — the
# round-trip property test in tests/test_plan_batched.py has teeth.
# ---------------------------------------------------------------------------

# fixed per-field vocabularies for the categorical (str) knobs
TUNABLE_CATEGORIES = {
    "remat": ("none", "dots", "full"),
    "accum_dtype": ("float32", "bfloat16"),
    "attn_impl": ("auto", "xla", "pallas"),
    "cache_dtype": ("auto", "float32", "bfloat16"),
}


def _tunable_kinds() -> dict:
    kinds = {}
    for f in dataclasses.fields(Tunables):
        default = getattr(DEFAULT_TUNABLES, f.name)
        if isinstance(default, bool):          # before int: bool is an int
            kinds[f.name] = "bool"
        elif isinstance(default, int):
            kinds[f.name] = "int"
        elif isinstance(default, float):
            kinds[f.name] = "float"
        else:
            kinds[f.name] = "cat"
            assert f.name in TUNABLE_CATEGORIES, \
                f"categorical knob {f.name} needs a TUNABLE_CATEGORIES vocab"
    return kinds


# field name -> "bool" | "int" | "float" | "cat", in dataclass field order
TUNABLE_KINDS = _tunable_kinds()


def encode_tunable_values(name: str, values: Sequence) -> np.ndarray:
    """Encode a column of candidate values for one knob (see codec rules)."""
    kind = TUNABLE_KINDS.get(name)
    if kind is None:
        raise ValueError(f"unknown Tunables knob: {name!r}")
    if kind == "cat":
        vocab = TUNABLE_CATEGORIES[name]
        try:
            return np.array([vocab.index(v) for v in values], np.int32)
        except ValueError:
            bad = [v for v in values if v not in vocab]
            raise ValueError(
                f"unknown {name} value(s) {bad}; vocab is {vocab}") from None
    if kind == "float":
        return np.asarray(values, np.float64)
    return np.asarray([int(v) for v in values], np.int32)


def tunables_to_arrays(tunables: Sequence[Tunables]) -> dict:
    """Struct-of-arrays encoding of a Tunables batch: one 1-D array per
    field, all of length ``len(tunables)``."""
    ts = list(tunables)
    return {name: encode_tunable_values(name, [getattr(t, name) for t in ts])
            for name in TUNABLE_KINDS}


def arrays_to_tunables(arrays: dict,
                       defaults: Tunables = DEFAULT_TUNABLES) -> list:
    """Decode a struct-of-arrays batch back into Tunables.  Missing fields
    take their value from ``defaults``; unknown keys are rejected."""
    unknown = sorted(set(arrays) - set(TUNABLE_KINDS))
    if unknown:
        raise ValueError(f"unknown Tunables knob(s): {unknown}")
    lengths = {len(np.atleast_1d(v)) for v in arrays.values()}
    if len(lengths) > 1:
        raise ValueError(f"ragged struct-of-arrays batch: lengths {lengths}")
    n = lengths.pop() if lengths else 0
    cols = {}
    for name, kind in TUNABLE_KINDS.items():
        if name not in arrays:
            continue
        col = np.atleast_1d(arrays[name])
        if kind == "cat":
            vocab = TUNABLE_CATEGORIES[name]
            bad = [int(v) for v in col if not 0 <= int(v) < len(vocab)]
            if bad:
                raise ValueError(
                    f"{name} index(es) {bad} out of range for vocab {vocab}")
            cols[name] = [vocab[int(v)] for v in col]
        elif kind == "bool":
            cols[name] = [bool(v) for v in col]
        elif kind == "int":
            cols[name] = [int(v) for v in col]
        else:
            cols[name] = [float(v) for v in col]
    return [defaults.replace(**{name: vals[i] for name, vals in cols.items()})
            for i in range(n)]
