"""Plain Mamba2 forward in float32 (arXiv:2405.21060; ``mamba_ssm``'s
``Mamba2`` mixer in ``MambaLMHeadModel``): per layer RMSNorm, the input
projection into z, x, B, C and dt, a causal depthwise convolution over
x, B and C with SiLU, dt through softplus with its bias, the SSD scan
with A = -exp(A_log) as a plain loop over chunks, the D skip, the gated
RMSNorm of y · SiLU(z) and the output projection; tied embeddings.

Departures from the published description, each because the benchmark
hands this the program's weight layout and arithmetic choices:
  * RMSNorm scales are stored as offsets from 1 (``1 + w``), and every
    norm uses the configuration's ``norm_epsilon`` as the program runs it;
  * the residual stream is carried in float32 here throughout;
  * the embedding has the vocabulary padded to a multiple of 256 rows,
    and the logits cover all of them;
  * one group (``ngroups`` 1), as the 1.3b model has.

Imports nothing of the program.  Each layer's weights are cast to
float32 as it runs.

Beside the forward, what the benchmark needs of the family: ``dims``,
``program_sizes``, ``leaves`` and ``call_flops``, as in ``qwen2.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from kbench.yardstick import ssd_bound, ssd_chunk

FAMILY = "ssm"


def dims(cfg: dict) -> dict:
    """The sizes counted with, from a Mamba2 ``config.json``'s keys (with
    ``ssm_cfg``); the vocabulary padded to 256 rows, as the program's
    embedding holds it."""
    s, vocab, d = cfg["ssm_cfg"], int(cfg["vocab_size"]), int(cfg["d_model"])
    di = int(s["expand"]) * d
    return {"family": FAMILY, "d": d, "layers": int(cfg["n_layer"]),
            "vocab": vocab, "vocab_padded": (vocab + 255) // 256 * 256,
            "d_inner": di, "ssm_head_dim": int(s["headdim"]),
            "ssm_heads": di // int(s["headdim"]), "d_state": int(s["d_state"]),
            "groups": int(s["ngroups"]), "d_conv": int(s["d_conv"]),
            "chunk": int(s["chunk_size"]),
            "eps": float(cfg["norm_epsilon"])}


def program_sizes(pc) -> dict:
    """The same sizes of the program's ``ModelConfig``."""
    s = pc.ssm
    return {"family": pc.family, "d": pc.d_model, "layers": pc.n_layers,
            "vocab": pc.vocab, "vocab_padded": pc.vocab_padded,
            "d_inner": s.expand * pc.d_model, "ssm_head_dim": s.head_dim,
            "ssm_heads": s.expand * pc.d_model // s.head_dim,
            "d_state": s.d_state, "groups": s.n_groups, "d_conv": s.d_conv,
            "chunk": s.chunk, "eps": pc.norm_eps}


def leaves(m: dict, dtype) -> dict:
    """Dotted path -> (shape, dtype, init) of every weight, in the
    program's layout; A and dt as published (A in [1, 16], dt in
    [0.001, 0.1], both log-uniform)."""
    d, L, Vp = m["d"], m["layers"], m["vocab_padded"]
    di, Hs, N, G, k = (m["d_inner"], m["ssm_heads"], m["d_state"],
                       m["groups"], m["d_conv"])
    cd, f32 = di + 2 * G * N, torch.float32
    return {
        "embed": ((Vp, d), dtype, ("normal", 0.02)),
        "ln_f": ((d,), dtype, ("normal", 0.05)),
        "layers.ln": ((L, d), dtype, ("normal", 0.05)),
        "layers.mixer.in_proj": ((L, d, 2 * di + 2 * G * N + Hs), dtype,
                                 ("normal", d ** -0.5)),
        "layers.mixer.conv_w": ((L, k, 1, cd), dtype, ("normal", 0.2)),
        "layers.mixer.conv_b": ((L, cd), dtype, ("normal", 0.05)),
        "layers.mixer.A_log": ((L, Hs), f32, ("loguniform_A", 1.0, 16.0)),
        "layers.mixer.D_skip": ((L, Hs), f32, ("one_plus", 0.1)),
        "layers.mixer.dt_bias": ((L, Hs), f32, ("dt_bias", 1e-3, 0.1)),
        "layers.mixer.norm": ((L, di), dtype, ("normal", 0.05)),
        "layers.mixer.out_proj": ((L, di, d), dtype, ("normal", di ** -0.5)),
    }


def layer_params(m: dict) -> int:
    """Parameters a token multiplies in one layer: the input and output
    projections."""
    d, di = m["d"], m["d_inner"]
    return d * (2 * di + 2 * m["groups"] * m["d_state"] + m["ssm_heads"]) \
        + di * d


def call_flops(m: dict, B: int, S: int, steps: int, chunk: int) -> float:
    """Model operations of one serve call, 2 per parameter and token with
    the SSD scan added: a prefill of B prompts of S tokens (the chunked
    scan's operations of ``ssd_bound`` at the chunk the program runs,
    the tied head at the last position), then ``steps`` decode steps of
    B tokens, each layer's state update and read 4·H·N·P a token."""
    body = m["layers"] * layer_params(m)
    head = m["d"] * m["vocab_padded"]
    scan = m["layers"] * ssd_bound(B, S, m["ssm_heads"], m["ssm_head_dim"],
                                   m["groups"], m["d_state"],
                                   ssd_chunk(S, chunk))["flops"]
    state = 4.0 * m["layers"] * m["ssm_heads"] * m["d_state"] * \
        m["ssm_head_dim"]
    return (2.0 * body * B * S + 2.0 * head * B + scan
            + steps * B * (2.0 * (body + head) + state))


def rmsnorm(x, w, eps):
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return x * (1.0 + w.float())


def ssd(x, dt, A, Bm, Cm, chunk: int):
    """The SSD scan as a loop over chunks of ``chunk`` positions (the last
    may be shorter).  x (S, H, P), dt (S, H), A (H,), Bm and Cm (S, N) ->
    y (S, H, P).  Inside a chunk: y_i = Σ_{j ≤ i} (C_i·B_j)
    exp(cum_i − cum_j) dt_j x_j; across chunks the state
    h (H, N, P) carries exp(cum)-decayed sums of B_j dt_j x_j."""
    S, H, P = x.shape
    N = Bm.shape[1]
    h = torch.zeros(H, N, P, dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        xc, dtc, Bc, Cc = x[sl], dt[sl], Bm[sl], Cm[sl]
        Q = xc.shape[0]
        cum = torch.cumsum(dtc * A, dim=0)                    # (Q, H)
        diff = cum[:, None, :] - cum[None, :, :]              # (Qi, Qj, H)
        tril = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        decay = torch.where(tril[..., None], torch.exp(
            torch.where(tril[..., None], diff, 0.0)), 0.0)
        w = (Cc @ Bc.T)[..., None] * decay * dtc[None, :, :]  # (Qi, Qj, H)
        y = torch.einsum("ijh,jhp->ihp", w, xc)
        y = y + torch.exp(cum)[..., None] * torch.einsum("in,hnp->ihp", Cc, h)
        end = torch.exp(cum[-1][None, :] - cum) * dtc         # (Q, H)
        h = h * torch.exp(cum[-1])[:, None, None] + torch.einsum(
            "jh,jn,jhp->hnp", end, Bc, xc)
        ys.append(y)
    return torch.cat(ys, dim=0)


def forward(w: dict, m: dict, tokens: torch.Tensor, eps: float,
            chunk: int, cast=None) -> torch.Tensor:
    """Logits (S, V_padded) in float32 of one sequence of token ids."""
    cast = cast or (lambda name, t: t.float())
    L, di, H, P, N, k = (m["layers"], m["d_inner"], m["ssm_heads"],
                         m["ssm_head_dim"], m["d_state"], m["d_conv"])
    S = tokens.shape[0]
    emb = cast("embed", w["embed"])
    x = emb[tokens.long()]
    lw, mx = w["layers"], w["layers"]["mixer"]
    for i in range(L):
        h = rmsnorm(x, lw["ln"][i], eps)
        zxbcdt = h @ cast("in_proj", mx["in_proj"][i])
        z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
        cw = mx["conv_w"][i][:, 0].float()                    # (k, Cd)
        pad = F.pad(xBC, (0, 0, k - 1, 0))
        conv = sum(pad[j:j + S] * cw[j] for j in range(k))
        xBC = F.silu(conv + mx["conv_b"][i].float())
        xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
        dt = F.softplus(dt + mx["dt_bias"][i].float())
        A = -torch.exp(mx["A_log"][i].float())
        xs = xs.reshape(S, H, P)
        y = ssd(xs, dt, A, Bm, Cm, chunk)
        y = y + mx["D_skip"][i].float()[:, None] * xs
        y = rmsnorm(y.reshape(S, di) * F.silu(z), mx["norm"][i], eps)
        x = x + y @ cast("out_proj", mx["out_proj"][i])
    return rmsnorm(x, w["ln_f"], eps) @ emb.T


def run(w: dict, m: dict, tokens: torch.Tensor, cast=None):
    return forward(w, m, tokens, m["eps"], m["chunk"], cast)
