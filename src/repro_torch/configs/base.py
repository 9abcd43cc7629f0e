"""Runtime tunables — the knob vector KERMIT's Explorer searches.

Port of the Tunables part of ``repro/configs/base.py`` (numpy; copied):
``Tunables``, ``DEFAULT_TUNABLES``, ``TUNABLE_CATEGORIES`` and the
struct-of-arrays codec.  Model configurations and input shapes belong to
the managed model stack, a later slice (ROADMAP queue A).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np

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
