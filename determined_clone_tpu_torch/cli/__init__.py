"""Command line of the port: ``python -m determined_clone_tpu_torch.cli``.

Only ``serve`` is ported (the JAX package's ``dct serve``, with the same
flags plus ``--device``); the rest of ``dct`` is listed in ``ROADMAP.md``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import List, Optional


def cmd_serve(args: argparse.Namespace) -> int:
    """Serve a GPT over HTTP with continuous batching over a paged KV
    cache. ``--selftest`` binds an ephemeral port, drives a few
    generations through the HTTP surface, prints the engine stats as
    JSON, and exits."""
    import torch

    from determined_clone_tpu_torch.config.experiment import ServingConfig
    from determined_clone_tpu_torch.device import resolve_device
    from determined_clone_tpu_torch.models import gpt
    from determined_clone_tpu_torch.serving import InferenceEngine
    from determined_clone_tpu_torch.serving.http import (
        ServingHTTPServer,
        generate_over_http,
    )

    device = resolve_device(args.device)
    scfg = ServingConfig()
    if args.config:
        import yaml

        with open(args.config) as f:
            raw = yaml.safe_load(f) or {}
        if raw.get("serving"):
            scfg = ServingConfig.from_dict(raw["serving"])
    if args.port is not None:
        scfg = dataclasses.replace(scfg, port=args.port)
    if args.host is not None:
        scfg = dataclasses.replace(scfg, host=args.host)

    if args.model != "tiny":
        print(f"error: unknown model preset {args.model!r} (have: tiny)",
              file=sys.stderr)
        return 2
    model_cfg = gpt.GPTConfig.tiny()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = gpt.init(gen, model_cfg, device=device)
    if args.checkpoint:
        from determined_clone_tpu_torch.core._serialization import load_pytree

        params = load_pytree(args.checkpoint, like=params)
    with InferenceEngine.from_serving_config(params, model_cfg, scfg,
                                             device=device) as engine:
        # ready the whole program ladder (CUDA graphs on the card) before
        # taking traffic
        t0 = time.monotonic()
        n_programs = engine.warmup()
        print(f"warmup: {n_programs} programs ready "
              f"in {time.monotonic() - t0:.1f}s", file=sys.stderr)
        port = 0 if args.selftest else scfg.port
        with ServingHTTPServer(engine, host=scfg.host, port=port) as server:
            if args.selftest:
                for prompt in ([1, 2, 3], [5, 6, 7, 8, 9], [11]):
                    out = generate_over_http(server.url, prompt,
                                             max_new_tokens=4)
                    if len(out["tokens"]) != 4:
                        print(f"error: selftest got {out}", file=sys.stderr)
                        return 1
                print(json.dumps(
                    {"selftest": "ok", "url": server.url,
                     "device": str(device),
                     "stats": dataclasses.asdict(engine.stats())}))
                return 0
            print(f"serving {args.model} on {server.url} "
                  f"(buckets: batch {engine.buckets.batch_buckets}, "
                  f"prefill {engine.buckets.prefill_len_buckets}; "
                  f"{engine.cache.num_blocks}x{engine.cache.block_size} "
                  f"KV blocks; {device})")
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m determined_clone_tpu_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("serve",
                       help="serve a GPT over HTTP with continuous "
                            "batching and a paged KV cache")
    c.add_argument("--config", default=None,
                   help="experiment config yaml; its `serving:` block "
                        "sets buckets, KV pool, admission and speed knobs")
    c.add_argument("--checkpoint", default=None,
                   help="local checkpoint dir (save_pytree layout) to "
                        "load params from; default: random init")
    c.add_argument("--model", default="tiny",
                   help="model preset (currently: tiny)")
    c.add_argument("--seed", type=int, default=0,
                   help="init seed when no checkpoint is given")
    c.add_argument("--host", default=None)
    c.add_argument("--port", type=int, default=None)
    c.add_argument("--selftest", action="store_true",
                   help="bind an ephemeral port, run a few generations "
                        "through the HTTP surface, print stats, exit")
    c.add_argument("--device", default="cuda",
                   help="torch device (default cuda; it raises without "
                        "one unless `cpu` is named)")
    c.set_defaults(func=cmd_serve)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)
