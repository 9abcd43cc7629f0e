"""The comparison that decides ``correct``: what the timed path served,
held against the plain reference once the window has closed.

* Served tokens.  A sample, drawn from the seed, of the requests the
  window committed, the longest among them, until it holds
  ``SAMPLE_TOKENS`` served tokens or ``SAMPLE_MAX`` requests.  The
  reference runs once over each prompt followed by its served tokens, in
  float32 with TF32 off, and the number compared is the widest gap by
  which a served token's logit lies below the reference's best logit at
  its position (``logit_gap``).  Greedy decoding serves the best token,
  so the gap is rounding, unless a layer is wrong.
* DBSCAN labels.  Every discovery the window's analyses ran: the points
  the program clustered, through the plain DBSCAN, and the labels that
  differ (``dbscan_mismatches``, limit 0).

The control (``control=True``) puts the reference in the program's place
at the precision below the configuration's, float8 weights: at each
position of the same prompts and served tokens the token it ranks first,
and that token's gap (``control_gap``).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from kbench.reference import dbscan as ref_dbscan
from kbench.reference.quant import fp8_weights

SAMPLE_TOKENS = 320
SAMPLE_MAX = 16


def served_requests(calls: list) -> list:
    """The committed requests as (prompt tokens key (P, B), row, served
    tokens), one entry per distinct sequence."""
    seen, out = set(), []
    for c in calls:
        for r in range(c["real_rows"]):
            g = int(c["gen"][r])
            toks = tuple(int(t) for t in c["generated"][r, :g + 1])
            key = (c["prompt"], c["batch"], r, toks)
            if key not in seen:
                seen.add(key)
                out.append({"shape": (c["prompt"], c["batch"]), "row": r,
                            "served": np.asarray(toks, np.int64)})
    return out


def sample(requests: list, seed: int) -> list:
    """The longest request, then others in an order drawn from ``seed``,
    until ``SAMPLE_TOKENS`` served tokens or ``SAMPLE_MAX`` requests."""
    if not requests:
        return []
    longest = max(range(len(requests)),
                  key=lambda i: (len(requests[i]["served"]),
                                 requests[i]["shape"][0]))
    order = [longest] + [int(i) for i in np.random.default_rng(
        [seed, 0x5eed]).permutation(len(requests)) if i != longest]
    picked, tokens = [], 0
    for i in order:
        if tokens >= SAMPLE_TOKENS or len(picked) >= SAMPLE_MAX:
            break
        picked.append(requests[i])
        tokens += len(requests[i]["served"])
    return picked


def _gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    best = logits.max(dim=-1).values
    return best - logits.gather(-1, tokens[:, None])[:, 0]


@torch.no_grad()
def served_gaps(ref, weights: dict, m: dict, prompts: dict,
                picked: list, control: bool = False) -> dict:
    """Per request, the widest gap of its served tokens under the
    reference (and, with ``control``, of the control's first-ranked
    tokens at the same positions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"served": [], "control": []}
    for req in picked:
        P, _ = req["shape"]
        prompt = prompts[req["shape"]][req["row"]].long()
        served = torch.as_tensor(req["served"], device=prompt.device)
        seq = torch.cat([prompt, served[:-1]])
        logits = ref.run(weights, m, seq)[P - 1:]
        out["served"].append(float(_gaps(logits, served).max()))
        if control:
            low = ref.run(weights, m, seq, cast=fp8_weights)[P - 1:]
            out["control"].append(float(_gaps(logits, low.argmax(-1)).max()))
            del low
        del logits
    return out


def dbscan_mismatches(found: list) -> dict:
    """Labels that differ from the plain DBSCAN's, over every discovery."""
    bad = near = points = 0
    for x, eps, min_pts, labels in found:
        want = ref_dbscan.labels(x, eps, min_pts)
        bad += int((np.asarray(labels) != want).sum())
        near += ref_dbscan.near_threshold(x, eps)
        points += len(x)
    return {"mismatches": bad, "discoveries": len(found), "points": points,
            "near_threshold_pairs": near}


def cell_file(root: Path, workload: str) -> dict:
    """``kbench/cells/<workload>.json``: the cell's service unit in
    seconds and the limits of its compared numbers, with the readings
    they were set from ({} before they are set)."""
    path = Path(root) / "kbench" / "cells" / f"{workload}.json"
    return json.loads(path.read_text()) if path.exists() else {}
