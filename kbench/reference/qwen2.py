"""Plain Qwen2 forward in float32 (arXiv:2407.10671; the Hugging Face
``Qwen2ForCausalLM``): grouped-query attention with bias on q, k and v,
rotary embeddings (θ from the config, the half-split rotation), RMSNorm
before attention and MLP, SwiGLU, tied embeddings.

Departures from the published description, each because the benchmark
hands this the program's weight layout:
  * RMSNorm scales are stored as offsets from 1: a norm multiplies by
    ``1 + w``, where Hugging Face stores the scale itself;
  * the embedding has the vocabulary padded to a multiple of 256 rows
    (random rows past ``vocab_size``), and the logits cover all of them;
  * projections are ``x @ W`` with W (d_in, d_out), layers stacked on a
    leading axis.

Imports nothing of the program.  ``forward`` takes one sequence; each
layer's weights are cast to float32 as it runs, so a layer at a time is
held in float32.

Beside the forward, what the benchmark needs of the family: its sizes
from the configuration file (``dims``), the program's sizes to hold
them to (``program_sizes``), its weight layout and initialisation
(``leaves``, drawn by ``kbench/weights.py``) and its operations per
serve call (``call_flops``).
"""
from __future__ import annotations

import torch

FAMILY = "dense"


def dims(cfg: dict) -> dict:
    """The sizes counted with, from a Qwen2 ``config.json``'s keys; the
    vocabulary padded to 256 rows, as the program's embedding holds it."""
    vocab, d = int(cfg["vocab_size"]), int(cfg["hidden_size"])
    H = int(cfg["num_attention_heads"])
    return {"family": FAMILY, "d": d, "layers": int(cfg["num_hidden_layers"]),
            "vocab": vocab, "vocab_padded": (vocab + 255) // 256 * 256,
            "heads": H, "kv_heads": int(cfg["num_key_value_heads"]),
            "head_dim": int(cfg.get("head_dim", d // H)),
            "ff": int(cfg["intermediate_size"]),
            "theta": float(cfg["rope_theta"]),
            "eps": float(cfg["rms_norm_eps"]), "bias": True}


def program_sizes(pc) -> dict:
    """The same sizes of the program's ``ModelConfig``."""
    return {"family": pc.family, "d": pc.d_model, "layers": pc.n_layers,
            "vocab": pc.vocab, "vocab_padded": pc.vocab_padded,
            "heads": pc.n_heads, "kv_heads": pc.n_kv_heads,
            "head_dim": pc.hd, "ff": pc.d_ff, "theta": pc.rope_theta,
            "eps": pc.norm_eps, "bias": pc.qkv_bias}


def leaves(m: dict, dtype) -> dict:
    """Dotted path -> (shape, dtype, init) of every weight, in the
    program's layout."""
    d, L, Vp = m["d"], m["layers"], m["vocab_padded"]
    H, K, hd, ff = m["heads"], m["kv_heads"], m["head_dim"], m["ff"]
    return {
        "embed": ((Vp, d), dtype, ("normal", 0.02)),
        "ln_f": ((d,), dtype, ("normal", 0.05)),
        "layers.ln1": ((L, d), dtype, ("normal", 0.05)),
        "layers.ln2": ((L, d), dtype, ("normal", 0.05)),
        "layers.attn.wq": ((L, d, H * hd), dtype, ("normal", d ** -0.5)),
        "layers.attn.wk": ((L, d, K * hd), dtype, ("normal", d ** -0.5)),
        "layers.attn.wv": ((L, d, K * hd), dtype, ("normal", d ** -0.5)),
        "layers.attn.wo": ((L, H * hd, d), dtype, ("normal", (H * hd) ** -0.5)),
        "layers.attn.bq": ((L, H * hd), dtype, ("normal", 0.05)),
        "layers.attn.bk": ((L, K * hd), dtype, ("normal", 0.05)),
        "layers.attn.bv": ((L, K * hd), dtype, ("normal", 0.05)),
        "layers.mlp.wi": ((L, d, ff), dtype, ("normal", d ** -0.5)),
        "layers.mlp.wg": ((L, d, ff), dtype, ("normal", d ** -0.5)),
        "layers.mlp.wo": ((L, ff, d), dtype, ("normal", ff ** -0.5)),
    }


def layer_params(m: dict) -> int:
    """Parameters a token multiplies in one layer: q, k, v, o and the
    SwiGLU's three matrices."""
    d, H, K, hd = m["d"], m["heads"], m["kv_heads"], m["head_dim"]
    return d * H * hd + 2 * d * K * hd + H * hd * d + 3 * d * m["ff"]


def call_flops(m: dict, B: int, S: int, steps: int, chunk: int = 0) -> float:
    """Model operations of one serve call, 2 per parameter and token
    (``repro_torch/analysis/roofline.py``'s ``model_flops``) with
    attention added, 4·head_dim per visible (query, key) pair, head and
    layer: a prefill of B prompts of S tokens, every layer at every
    position and the tied head at the last (the logits it needs), then
    ``steps`` decode steps at positions S, S + 1, ..., each B tokens
    through every layer and the head."""
    body = m["layers"] * layer_params(m)
    head = m["d"] * m["vocab_padded"]
    att = 4.0 * m["head_dim"] * m["heads"] * m["layers"]
    out = 2.0 * body * B * S + 2.0 * head * B + att * B * S * (S + 1) / 2
    for i in range(steps):
        out += B * (2.0 * (body + head) + att * (S + i + 1))
    return out


def rmsnorm(x, w, eps):
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return x * (1.0 + w.float())


def rope(x, pos, theta):
    """x: (S, H, D), the half-split rotation of ``rotate_half``."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = (pos.double()[:, None] * inv[None, :]).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v):
    """Causal GQA: q (S, H, D), k and v (S, K, D) -> (S, H·D)."""
    S, H, D = q.shape
    K = k.shape[1]
    k = k.repeat_interleave(H // K, dim=1)
    v = v.repeat_interleave(H // K, dim=1)
    out = torch.empty_like(q)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    for h in range(H):
        s = (q[:, h] @ k[:, h].T) * D ** -0.5
        s = s.masked_fill(~mask, float("-inf"))
        out[:, h] = torch.softmax(s, dim=-1) @ v[:, h]
    return out.reshape(S, H * D)


def forward(w: dict, m: dict, tokens: torch.Tensor, eps: float,
            theta: float, cast=None) -> torch.Tensor:
    """Logits (S, V_padded) in float32 of one sequence of token ids.
    ``cast(name, tensor)`` maps each weight to the float32 the reference
    computes with (default: the plain cast)."""
    cast = cast or (lambda name, t: t.float())
    L, H, K, hd = m["layers"], m["heads"], m["kv_heads"], m["head_dim"]
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    emb = cast("embed", w["embed"])
    x = emb[tokens.long()]
    lw = w["layers"]
    for i in range(L):
        a, p = lw["attn"], lw["mlp"]
        h = rmsnorm(x, lw["ln1"][i], eps)
        q = h @ cast("wq", a["wq"][i]) + a["bq"][i].float()
        k = h @ cast("wk", a["wk"][i]) + a["bk"][i].float()
        v = h @ cast("wv", a["wv"][i]) + a["bv"][i].float()
        q = rope(q.reshape(S, H, hd), pos, theta)
        k = rope(k.reshape(S, K, hd), pos, theta)
        x = x + attention(q, k, v.reshape(S, K, hd)) @ cast("wo", a["wo"][i])
        h = rmsnorm(x, lw["ln2"][i], eps)
        g = torch.nn.functional.silu(h @ cast("wg", p["wg"][i]))
        x = x + (g * (h @ cast("wi", p["wi"][i]))) @ cast("wo", p["wo"][i])
    return rmsnorm(x, w["ln_f"], eps) @ emb.T


def run(w: dict, m: dict, tokens: torch.Tensor, cast=None):
    return forward(w, m, tokens, m["eps"], m["theta"], cast)
