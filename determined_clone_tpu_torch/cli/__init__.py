"""Command line of the port: ``python -m determined_clone_tpu_torch.cli``.

Ported: ``serve``, ``fleet up|status|rollout|scale`` and ``kv stats``
(the JAX package's ``dct`` commands of those names, with the same flags
plus ``--device`` where a model runs). The master-backed forms
(``fleet up --with-master``, ``fleet status``/``scale`` without
``--url``) wait with the control-plane hooks; the rest of ``dct`` is
listed in ``ROADMAP.md``.
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


_NO_MASTER = ("the master-backed fleet (MasterLink) is not ported yet "
              "(ROADMAP.md, the control-plane hooks); run the fleet "
              "standalone and address its front door with --url")


def _tiny_params(args: argparse.Namespace, device):
    """(GPTConfig.tiny(), params): a seeded init, or a checkpoint."""
    import torch

    from determined_clone_tpu_torch.models import gpt

    model_cfg = gpt.GPTConfig.tiny()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = gpt.init(gen, model_cfg, device=device)
    if args.checkpoint:
        from determined_clone_tpu_torch.core._serialization import load_pytree

        params = load_pytree(args.checkpoint, like=params)
    return model_cfg, params


def _get_json(url: str, timeout: float = 10.0):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _post_json(url: str, body, timeout: float):
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(body).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def cmd_fleet_up(args: argparse.Namespace) -> int:
    """Run a serving fleet: N engine replicas behind the least-loaded
    router with an HTTP front door, standalone. ``--selftest`` drives
    traffic through the HTTP surface, prints fleet stats as JSON, and
    exits."""
    from determined_clone_tpu_torch.device import resolve_device
    from determined_clone_tpu_torch.serving import ServingFleet
    from determined_clone_tpu_torch.serving.http import (
        FleetHTTPServer,
        generate_over_http,
    )

    if args.with_master:
        print(f"error: --with-master: {_NO_MASTER}", file=sys.stderr)
        return 2
    if args.model != "tiny":
        print(f"error: unknown model preset {args.model!r} (have: tiny)",
              file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    model_cfg, params = _tiny_params(args, device)
    with ServingFleet(params, model_cfg, name=args.name,
                      iteration_floor_s=args.iteration_floor,
                      device=device) as fleet:
        fleet.scale_up(args.replicas)
        port = 0 if args.selftest else (args.port or 8085)
        with FleetHTTPServer(fleet, host=args.host or "127.0.0.1",
                             port=port) as server:
            if args.selftest:
                outs = [generate_over_http(server.url, [1, 2, 3],
                                           max_new_tokens=4)
                        for _ in range(2 * args.replicas)]
                if any(len(o["tokens"]) != 4 for o in outs):
                    print(f"error: selftest got {outs}", file=sys.stderr)
                    return 1
                print(json.dumps({
                    "selftest": "ok", "url": server.url,
                    "replicas": fleet.replica_ids(),
                    "with_master": False, "device": str(device),
                    "stats": dataclasses.asdict(fleet.stats())}))
                return 0
            print(f"fleet {fleet.name!r}: {args.replicas} replicas on "
                  f"{server.url} (standalone; {device})")
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                return 0


def cmd_fleet_status(args: argparse.Namespace) -> int:
    """Fleet health from a fleet front door (GET /v1/fleet)."""
    if not args.url:
        print(f"error: fleet status needs --url: {_NO_MASTER}",
              file=sys.stderr)
        return 2
    view = _get_json(f"{args.url.rstrip('/')}/v1/fleet")
    if args.json:
        print(json.dumps(view, indent=2))
        return 0
    st = view["stats"]
    print(f"fleet {view['name']!r}: {st['healthy']}/{st['replicas']} "
          f"healthy, queue depth {st['queue_depth']}, "
          f"{st['free_blocks']} free KV blocks, "
          f"{st['completed']} completed, "
          f"{st['tokens_generated']} tokens")
    health = view.get("health") or {}
    by_id = {r["id"]: r for r in health.get("replicas", [])}
    for rep in view["replicas"]:
        mark = (" [excluded]" if rep["id"] in view.get("excluded", [])
                else "")
        line = f"  {rep['id']}: {rep['state']}{mark}"
        h = by_id.get(rep["id"])
        if h:
            line += (f" (breaker {h['breaker']}, "
                     f"beat {h['beat_age_s']:.1f}s ago")
            if h.get("fatal"):
                line += f", FATAL: {h['fatal']}"
            line += ")"
        print(line)
    if health.get("quarantined_requests"):
        print(f"  {health['quarantined_requests']} request(s) "
              f"quarantined as poison pills")
    last = health.get("last_incident")
    if last:
        repl = ", ".join(last.get("replacement") or []) or "none"
        print(f"  last incident: replica {last.get('replica')} "
              f"{last.get('reason')} — {last.get('failed_requests')} "
              f"request(s) failed over, "
              f"{last.get('leaked_blocks')} block(s) leaked, "
              f"recovered in {last.get('recovery_s', 0):.2f}s "
              f"(replacement: {repl})")
    return 0


def cmd_fleet_rollout(args: argparse.Namespace) -> int:
    """Blue-green checkpoint rollout through a fleet front door: the new
    version is proven on a drained canary before the rest of the fleet
    swaps, and no in-flight request ever spans a parameter change."""
    report = _post_json(f"{args.url.rstrip('/')}/v1/rollout",
                        {"checkpoint": args.checkpoint}, args.timeout)
    if args.json:
        print(json.dumps(report, indent=2))
        return 0
    order = report.get("order", [])
    print(f"rollout complete in {report.get('duration_s', 0.0):.2f}s: "
          f"canary {order[0] if order else '?'}, "
          f"{len(order)} replicas swapped")
    for rid in order:
        print(f"  {rid}: drained in {report['drain_s'].get(rid, 0.0):.3f}s")
    return 0


def cmd_fleet_scale(args: argparse.Namespace) -> int:
    """Resize a fleet through its front door (in-process drain)."""
    if not args.url:
        print(f"error: fleet scale needs --url: {_NO_MASTER}",
              file=sys.stderr)
        return 2
    view = _post_json(f"{args.url.rstrip('/')}/v1/scale",
                      {"replicas": args.replicas}, args.timeout)
    print(f"fleet now has {len(view['replicas'])} replicas: "
          f"{view['replicas']}")
    return 0


def cmd_kv_stats(args: argparse.Namespace) -> int:
    """KV memory-hierarchy readout: from a live fleet front door (--url →
    the ``kv_tier`` block of GET /v1/fleet — host tier counters plus
    nested CAS stats) or straight off a shared_fs storage root's
    ``cas/kv/`` namespace (--host-path)."""
    if args.url:
        kv = _get_json(f"{args.url.rstrip('/')}/v1/fleet").get("kv_tier")
        if kv is None:
            print("fleet has no KV memory hierarchy (kv_store off)",
                  file=sys.stderr)
            return 2
        print(json.dumps(kv, indent=2, sort_keys=True))
        return 0
    if not args.host_path:
        print("kv stats needs --url or --host-path", file=sys.stderr)
        return 2
    from determined_clone_tpu_torch.storage import SharedFSStorageManager
    from determined_clone_tpu_torch.storage.cas import KVBlobStore

    stats = KVBlobStore(SharedFSStorageManager(args.host_path)).stats()
    print(json.dumps(stats, indent=2, sort_keys=True))
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

    p_fleet = sub.add_parser("fleet",
                             help="serving fleet: replicas behind a "
                                  "least-loaded router with blue-green "
                                  "rollout")
    fleet_sub = p_fleet.add_subparsers(dest="fleet_cmd", required=True)
    c = fleet_sub.add_parser("up", help="run a fleet of engine replicas "
                                        "with an HTTP front door")
    c.add_argument("--replicas", type=int, default=2)
    c.add_argument("--name", default="fleet")
    c.add_argument("--model", default="tiny",
                   help="model preset (currently: tiny)")
    c.add_argument("--seed", type=int, default=0,
                   help="init seed when no checkpoint is given")
    c.add_argument("--checkpoint", default=None,
                   help="local checkpoint dir (save_pytree layout)")
    c.add_argument("--iteration-floor", type=float, default=0.0,
                   help="simulated device-step floor in seconds")
    c.add_argument("--with-master", action="store_true",
                   help="not ported: refused with an error")
    c.add_argument("--host", default=None)
    c.add_argument("--port", type=int, default=None)
    c.add_argument("--selftest", action="store_true",
                   help="drive traffic through the HTTP surface, print "
                        "fleet stats as JSON, exit")
    c.add_argument("--device", default="cuda",
                   help="torch device (default cuda; it raises without "
                        "one unless `cpu` is named)")
    c.set_defaults(func=cmd_fleet_up)

    c = fleet_sub.add_parser("status", help="fleet health from the front "
                                            "door")
    c.add_argument("--url", default=None, help="fleet front-door URL")
    c.add_argument("--json", action="store_true")
    c.set_defaults(func=cmd_fleet_status)

    c = fleet_sub.add_parser("rollout",
                             help="blue-green checkpoint rollout: canary "
                                  "first, drained swaps, zero failed "
                                  "requests")
    c.add_argument("--url", required=True, help="fleet front-door URL")
    c.add_argument("--checkpoint", required=True,
                   help="checkpoint dir to roll out")
    c.add_argument("--timeout", type=float, default=300.0)
    c.add_argument("--json", action="store_true")
    c.set_defaults(func=cmd_fleet_rollout)

    c = fleet_sub.add_parser("scale", help="drain-protected fleet resize")
    c.add_argument("--replicas", type=int, required=True)
    c.add_argument("--url", default=None, help="fleet front-door URL")
    c.add_argument("--name", default="fleet")
    c.add_argument("--timeout", type=float, default=300.0)
    c.set_defaults(func=cmd_fleet_scale)

    p_kv = sub.add_parser("kv", help="fleet-wide KV memory hierarchy "
                                     "(host tier + cas/kv/ spill)")
    skv = p_kv.add_subparsers(dest="subcommand", required=True)
    c = skv.add_parser("stats", help="tier entries, bytes, hit split, CAS "
                                     "spill accounting")
    c.add_argument("--url", default=None,
                   help="fleet front-door URL (live host-tier + CAS "
                        "counters)")
    c.add_argument("--host-path", default=None,
                   help="shared_fs storage root holding cas/kv/")
    c.set_defaults(func=cmd_kv_stats)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)
