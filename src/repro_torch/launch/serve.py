"""Serving launcher: batched prefill + greedy decode with a KV cache.

Port of ``repro/launch/serve.py``; runs on the card:

  python -m repro_torch.launch.serve --arch qwen2-1.5b --full
  python -m repro_torch.launch.serve --arch deepseek-moe-16b --full
  python -m repro_torch.launch.serve --arch paligemma-3b --device cpu

Every family serves: dense, moe, vlm (the prompt counts the image's
patches, so its default is 64 text tokens after them), ssm, hybrid and
encdec (half the prompt is frames, half tokens).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs.base import DEFAULT_TUNABLES, reduced
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.kermit.serving.engine import get_engine


def serve_batch(cfg, batch: int, prompt_len: int, gen: int, tun, seed=0,
                device=None):
    """Batched prefill + greedy decode; returns timing + generated tokens.

    Routed through the shared ``ServeEngine`` for (cfg, seed, device):
    params are initialized once per process, so repeated calls (e.g. knob
    evaluations during a KERMIT search) reuse them.  ``device=None``
    means CUDA."""
    return get_engine(cfg, seed, device=device).serve_legacy(
        batch, prompt_len, gen, tun)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen2-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="prompt positions (default: 64, after the "
                         "patches for vlm)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    prompt = args.prompt_len or 64 + (cfg.num_patches if cfg.family == "vlm"
                                      else 0)
    res = serve_batch(cfg, args.batch, prompt, args.gen,
                      DEFAULT_TUNABLES, device=args.device)
    res["generated"] = f"{len(res['generated'])} sequences"
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
