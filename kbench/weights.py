"""Weights and prompt tokens made from ``--seed``, on the device, by the
benchmark: handed both to the engine and to the plain reference.

The tree has the program's layout (stacked layers, every projection
``x @ W`` with ``W`` (d_in, d_out), RMSNorm scales stored as offsets
from 1), as the family's module in ``kbench/reference/`` lists it
(``leaves``) from the configuration file's sizes; ``install`` checks
that it matches the engine's tree leaf for leaf before it replaces it.
Each leaf is one draw from a ``torch.Generator`` on the device, in the
dtype it is served in.  Inits: ("normal", std), ("one_plus", std),
("loguniform_A", lo, hi): log A for A log-uniform in [lo, hi],
("dt_bias", lo, hi): softplus⁻¹ of dt log-uniform in [lo, hi].
"""
from __future__ import annotations

import math

import torch


def _draw(gen, shape, init) -> torch.Tensor:
    kind = init[0]
    dev = gen.device
    if kind == "normal":
        return torch.randn(shape, generator=gen, device=dev).mul_(init[1])
    if kind == "one_plus":
        return torch.randn(shape, generator=gen, device=dev).mul_(
            init[1]).add_(1.0)
    u = torch.rand(shape, generator=gen, device=dev)
    lo, hi = math.log(init[1]), math.log(init[2])
    v = torch.exp(lo + u * (hi - lo))
    if kind == "loguniform_A":
        return torch.log(v)                 # A_log = log A
    return v + torch.log(-torch.expm1(-v))  # softplus⁻¹(dt)


def make_weights(leaves: dict, gen: torch.Generator) -> dict:
    """The parameter tree of a family's ``leaves(dims, dtype)`` table
    (dotted path -> (shape, dtype, init)), drawn from ``gen`` on its
    device, leaf by leaf in the table's order."""
    tree: dict = {}
    for path, (shape, dt, init) in leaves.items():
        node = tree
        *heads, leaf = path.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = _draw(gen, shape, init).to(dt)
    return tree


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def install(engine, tree: dict) -> None:
    """Replace the engine's parameters with ``tree`` after checking that
    both have the same leaves, shapes and dtypes."""
    have = {k: (tuple(v.shape), v.dtype) for k, v in
            _flat(engine.params).items()}
    mine = {k: (tuple(v.shape), v.dtype) for k, v in _flat(tree).items()}
    if have != mine:
        diff = sorted(set(have.items()) ^ set(mine.items()))
        raise RuntimeError(f"the engine's parameter tree differs from the "
                           f"benchmark's: {diff[:8]}")
    engine.params = tree


def make_tokens(vocab: int, shapes, gen: torch.Generator) -> dict:
    """(prompt_len, batch) -> (batch, prompt_len) int32 prompt tokens in
    [0, vocab), one draw per shape, in sorted order."""
    return {(P, B): torch.randint(0, vocab, (B, P), generator=gen,
                                  device=gen.device, dtype=torch.int32)
            for P, B in sorted(shapes)}
