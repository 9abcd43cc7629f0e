"""Training launcher.

Port of ``repro/launch/train.py``.  Runs on the card unless ``--device cpu``
is given; without ``--full`` it trains the reduced config (the same family
at tiny widths), with ``--full`` the published widths:

  python -m repro_torch.launch.train --arch qwen2-1.5b --full --steps 30
  python -m repro_torch.launch.train --device cpu --steps 10
  python -m repro_torch.launch.train --arch mamba2-1.3b --autonomic \\
      --steps 200 --ckpt-dir ckpt --kermit-config kermit.json

The KERMIT loop is driven through ``repro_torch.kermit.KermitSession``;
``--kermit-config spec.json`` loads a full declarative ``KermitConfig``
tree, and the launcher subscribes to the typed event stream to report
per-kind counts.
"""
from __future__ import annotations

import argparse
import json
from collections import Counter

from repro_torch.configs.base import DEFAULT_TUNABLES, ShapeSpec, reduced
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kermit import (KermitConfig, KermitSession, KnowledgeConfig,
                                MonitorConfig)
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime.fault import FailureInjector
from repro_torch.runtime.loop import Trainer


def _build_session(args, device) -> KermitSession:
    if args.kermit_config:
        with open(args.kermit_config) as f:
            cfg = KermitConfig.from_dict(json.load(f))
        if args.kermit_root:            # CLI root overrides the spec's
            cfg = cfg.replace(
                knowledge=KnowledgeConfig(root=args.kermit_root,
                                          drift_eps=cfg.knowledge.drift_eps))
    else:
        # the historical CLI cadence (window 16), as the reference keeps
        cfg = KermitConfig(
            monitor=MonitorConfig(window_size=16),
            knowledge=KnowledgeConfig(root=args.kermit_root))
    return KermitSession(cfg, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="the published widths (needs the card)")
    ap.add_argument("--autonomic", action="store_true",
                    help="enable the KERMIT MAPE-K loop")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--kermit-root", default=None)
    ap.add_argument("--kermit-config", default=None,
                    help="JSON KermitConfig tree (see KermitConfig.to_dict)")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject node failures at these steps")
    ap.add_argument("--tun", nargs="*", default=[], help="tunable k=v")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    tun = DEFAULT_TUNABLES
    for kv in args.tun:
        k, v = kv.split("=", 1)
        cur = getattr(tun, k)
        v = (v.lower() in ("1", "true")) if isinstance(cur, bool) else \
            type(cur)(v)
        tun = tun.replace(**{k: v})

    session = _build_session(args, device) if args.autonomic else None
    event_counts: Counter = Counter()
    if session is not None:
        session.subscribe(None, lambda ev: event_counts.update([ev.kind]))
    injector = FailureInjector(fail_steps=tuple(args.fail_at)) \
        if args.fail_at else None
    tr = Trainer(cfg, shape, OptConfig(lr=args.lr, warmup=10), tun,
                 ckpt_dir=args.ckpt_dir, autonomic=session,
                 injector=injector, device=device)
    rep = tr.run(args.steps)
    out = {
        "arch": args.arch, "device": str(device), "steps": rep.steps_done,
        "loss_first": rep.losses[0], "loss_last": rep.losses[-1],
        "mean_step_s": sum(rep.step_times) / len(rep.step_times),
        "failures_recovered": rep.failures_recovered,
        "straggler_events": rep.straggler_events,
        "failed_trials": rep.failed_trials,
        "retunes": rep.retunes,
    }
    if session is not None:
        out["kermit"] = session.summary()
        out["kermit_events"] = dict(event_counts)
        session.close()
    print(json.dumps(out, indent=1, default=str))


if __name__ == "__main__":
    main()
