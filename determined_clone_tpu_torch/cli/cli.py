"""Command line of the port: ``python -m determined_clone_tpu_torch.cli``
— the port's copy of ``determined_clone_tpu/cli/cli.py`` (the ``dct``
command tree), printing as it prints.

Every subcommand is a thin wrapper over the port's ``MasterSession`` and
SDK (``sdk.py``), printing tables or JSON: the master's (``master``,
``experiment``, ``trial``, ``checkpoint``, ``task`` and the NTSC types
``notebook``/``shell``/``cmd``/``tensorboard``, ``agent``, ``job``,
``user``, ``workspace``, ``project``, ``model``, ``template``,
``webhook``, ``group``, ``rbac``), the observability readouts over the
port's telemetry (``metrics``, ``goodput``, ``slo``, ``query``,
``alerts``, ``top``, ``mesh``, ``trace``, ``debug flight``), ``lint``
(the repo's ``tools/dctlint``) and ``deploy local`` (the C++ master and
the port's agents). The commands that run a model, ``serve`` and
``fleet up`` (standalone or ``--with-master``, the replicas as the
master's serving gang allocations), take ``--device`` and run on the
card unless ``cpu`` is named; their errors propagate. Three commands
refuse, exit 2 and name their ``ROADMAP.md`` item: ``checkpoint stats``
(the content-addressed checkpoint store), ``exec-cache stats`` (XLA
executables) and ``deploy gcp|gke`` (TPU VMs).

Master address: -m/--master host:port, or DCT_MASTER env, default
127.0.0.1:8080. Login tokens persist per master in ~/.dct/auth.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

from determined_clone_tpu_torch.api.client import MasterError, MasterSession


# ---------------------------------------------------------------------------
# session + auth store
# ---------------------------------------------------------------------------

def auth_store_path() -> str:
    return os.path.join(os.path.expanduser("~"), ".dct", "auth.json")


def load_auth_store() -> Dict[str, str]:
    try:
        with open(auth_store_path()) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def save_auth_store(store: Dict[str, str]) -> None:
    path = auth_store_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(store, f)
    os.chmod(path, 0o600)


def make_session(args: argparse.Namespace) -> MasterSession:
    master = args.master or os.environ.get("DCT_MASTER", "127.0.0.1:8080")
    host, _, port = master.partition(":")
    session = MasterSession(host or "127.0.0.1", int(port or "8080"))
    token = load_auth_store().get(master)
    if token:
        session.token = token
    return session


def fetch_cluster_view(args: argparse.Namespace, path: str, *,
                       fold_fallback: bool = True):
    """Shared master-fetch plumbing for the observability subcommands
    (metrics, goodput, slo, query, alerts, top): ``GET path`` on the
    configured master. With ``fold_fallback`` a 404 — a master (e.g.
    the C++ one) that exposes ``/metrics`` but not this JSON route —
    fetches the exposition text instead and folds it through a fresh
    aggregator so the caller can re-derive its view. Returns
    ``(session, payload, agg)``; exactly one of payload/agg is
    non-None.
    """
    session = make_session(args)
    try:
        return session, session.get(path), None
    except MasterError as e:
        if e.status != 404 or not fold_fallback:
            raise
        from determined_clone_tpu_torch.telemetry.aggregate import (
            ClusterMetricsAggregator,
        )
        import urllib.request

        url = f"http://{session.host}:{session.port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as resp:
            text = resp.read().decode("utf-8")
        agg = ClusterMetricsAggregator()
        agg.ingest_prometheus_text("master", text)
        return session, None, agg


# ---------------------------------------------------------------------------
# output helpers
# ---------------------------------------------------------------------------

def print_table(rows: List[Dict[str, Any]], columns: Sequence[str]) -> None:
    if not rows:
        print("(none)")
        return
    widths = {c: len(c) for c in columns}
    rendered = []
    for row in rows:
        r = {c: str(row.get(c, "")) for c in columns}
        for c in columns:
            widths[c] = max(widths[c], len(r[c]))
        rendered.append(r)
    header = " | ".join(c.ljust(widths[c]) for c in columns)
    print(header)
    print("-+-".join("-" * widths[c] for c in columns))
    for r in rendered:
        print(" | ".join(r[c].ljust(widths[c]) for c in columns))


def print_json(obj: Any) -> None:
    print(json.dumps(obj, indent=2, sort_keys=True))


def load_config_file(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict):
        raise SystemExit(f"config {path} must be a YAML mapping")
    return cfg


# ---------------------------------------------------------------------------
# command implementations
# ---------------------------------------------------------------------------

def cmd_master_config(args) -> int:
    print_json(make_session(args).get("/api/v1/master/config"))
    return 0


def cmd_master_info(args) -> int:
    print_json(make_session(args).master_info())
    return 0


def cmd_experiment_create(args) -> int:
    session = make_session(args)
    config = load_config_file(args.config)
    if args.config_override:
        for override in args.config_override:
            key, _, value = override.partition("=")
            node = config
            parts = key.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            try:
                node[parts[-1]] = json.loads(value)
            except json.JSONDecodeError:
                node[parts[-1]] = value
    body: Dict[str, Any] = {"config": config}
    if args.model_dir:
        from determined_clone_tpu_torch.sdk import read_context_dir

        body["context"] = read_context_dir(args.model_dir)
    exp = session.post("/api/v1/experiments", body)["experiment"]
    print(f"Created experiment {exp['id']}", flush=True)
    if args.follow:
        from determined_clone_tpu_torch.sdk import ExperimentRef

        state = ExperimentRef(session, exp["id"]).wait(timeout=args.timeout)
        print(f"Experiment {exp['id']} finished: {state}")
        return 0 if state == "COMPLETED" else 1
    return 0


def cmd_experiment_list(args) -> int:
    exps = make_session(args).list_experiments()
    if not args.show_archived:
        exps = [e for e in exps if not e.get("archived")]
    print_table(exps, ["id", "name", "state", "archived", "owner",
                       "workspace", "project"])
    return 0


def cmd_experiment_describe(args) -> int:
    print_json(make_session(args).get_experiment(args.experiment_id))
    return 0


def cmd_experiment_pause(args) -> int:
    exp = make_session(args).pause_experiment(args.experiment_id)
    print(f"Experiment {exp['id']} is {exp['state']}")
    return 0


def cmd_experiment_activate(args) -> int:
    exp = make_session(args).activate_experiment(args.experiment_id)
    print(f"Experiment {exp['id']} is {exp['state']}")
    return 0


def cmd_experiment_archive(args) -> int:
    exp = make_session(args).archive_experiment(
        args.experiment_id, archive=not args.unarchive)
    print(f"Experiment {exp['id']} archived={exp['archived']}")
    return 0


def cmd_experiment_delete(args) -> int:
    make_session(args).delete_experiment(args.experiment_id)
    print(f"Deleted experiment {args.experiment_id}")
    return 0


def cmd_experiment_kill(args) -> int:
    make_session(args).kill_experiment(args.experiment_id)
    print(f"Killed experiment {args.experiment_id}")
    return 0


def cmd_trial_kill(args) -> int:
    trial = make_session(args).kill_trial(args.trial_id)
    print(f"Trial {trial['id']} is {trial['state']}")
    return 0


def cmd_trial_describe(args) -> int:
    print_json(make_session(args).get_trial(args.trial_id))
    return 0


def cmd_trial_metrics(args) -> int:
    print_json(make_session(args).trial_metrics(args.trial_id, args.limit))
    return 0


def cmd_trial_logs(args) -> int:
    session = make_session(args)
    legs = session.trial_log_allocations(args.trial_id)
    if not getattr(args, "follow", False):
        for alloc_id in legs:
            for rec in session.task_logs(alloc_id):
                print(rec.get("log", ""))
        return 0
    # follow: drain earlier legs from their cursors, then live-tail the
    # newest; a restart creates a new leg, so on end-of-stream re-list and
    # keep going until the trial is terminal with no new leg. Per-leg
    # cursors stop a re-entered leg (e.g. followed live, then superseded
    # by a restart) from reprinting what was already shown.
    import time as _time

    cursors: Dict[str, int] = {}

    def emit(alloc_id: str, follow_seconds: int) -> None:
        n = cursors.get(alloc_id, 0)
        try:
            for rec in session.follow_task_logs(
                    alloc_id, offset=n, follow_seconds=follow_seconds):
                print(rec.get("log", ""), flush=True)
                n += 1
        except MasterError as err:
            # a QUEUED trial's leg (or a restart's fresh leg) may be
            # listed before its allocation registers: wait, don't crash
            if err.status != 404:
                raise
            _time.sleep(1.0)
        cursors[alloc_id] = n

    while True:
        for alloc_id in legs[:-1]:
            emit(alloc_id, 0)   # dead leg: just drain past the cursor
        if legs:
            emit(legs[-1], 30)  # live leg: block for new lines
        state = session.get_trial(args.trial_id).get("state", "")
        new_legs = session.trial_log_allocations(args.trial_id)
        if new_legs == legs and state in ("COMPLETED", "ERRORED",
                                          "CANCELED"):
            return 0
        if new_legs == legs:
            # e.g. PAUSED with a drained terminal leg: don't spin
            _time.sleep(1.0)
        legs = new_legs


def cmd_checkpoint_list(args) -> int:
    records = make_session(args).get(
        f"/api/v1/experiments/{args.experiment_id}/checkpoints")["checkpoints"]
    print_table(records, ["uuid", "trial_id", "reported_at"])
    return 0


def cmd_checkpoint_describe(args) -> int:
    print_json(make_session(args).get(f"/api/v1/checkpoints/{args.uuid}"))
    return 0


def cmd_checkpoint_download(args) -> int:
    from determined_clone_tpu_torch.sdk import CheckpointRef

    session = make_session(args)
    path = CheckpointRef(session, args.uuid).download(args.output_dir)
    print(f"Downloaded checkpoint {args.uuid} to {path}")
    return 0


def _refuse(what: str, item: str) -> int:
    print(f"error: {what} is not ported yet (ROADMAP.md, Queue 1, "
          f"{item})", file=sys.stderr)
    return 2


def cmd_checkpoint_stats(args) -> int:
    """Dedup ratio + chunk-cache hit rate of a content-addressed store:
    refused, the checkpoint half of the CAS store being unported."""
    return _refuse("checkpoint stats (the content-addressed checkpoint "
                   "store)", "item 4.3: the checkpoint half of "
                   "storage/cas.py")


def cmd_exec_cache_stats(args) -> int:
    """The persistent XLA executable cache's readout: refused, there
    being no XLA executable in the port (its warm start is CUDA-graph
    capture)."""
    return _refuse("exec-cache stats (the XLA executable cache)",
                   "item 6: XLA executables")


def _get_json(url: str, timeout: float = 10.0):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


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


def cmd_task_list(args) -> int:
    tasks = make_session(args).list_tasks(args.type)
    print_table(tasks, ["id", "task_type", "name", "state", "proxy_address"])
    return 0


def cmd_task_kill(args) -> int:
    make_session(args).kill_task(args.task_id)
    print(f"Killed task {args.task_id}")
    return 0


def cmd_task_logs(args) -> int:
    session = make_session(args)
    if getattr(args, "follow", False):
        for rec in session.follow_task_logs(args.task_id):
            print(rec.get("log", ""), flush=True)
        return 0
    for rec in session.task_logs(args.task_id):
        print(rec.get("log", ""))
    return 0


def _start_ntsc(args, task_type: str, **extra: Any) -> int:
    # typed roots (LaunchNotebook/LaunchShell/... RPCs) rather than the
    # generic CreateTask — the type is pinned server-side
    session = make_session(args)
    kwargs: Dict[str, Any] = dict(extra)
    if getattr(args, "name", None):
        kwargs["name"] = args.name
    if getattr(args, "idle_timeout", None):
        kwargs["idle_timeout"] = args.idle_timeout
    task = session.post(f"/api/v1/{task_type}s", kwargs)[task_type]
    print(f"Started {task_type} {task['id']}")
    return 0


def _list_ntsc(args, task_type: str) -> int:
    tasks = make_session(args).get(f"/api/v1/{task_type}s")[task_type + "s"]
    print_table(tasks, ["id", "name", "state", "owner", "proxy_address"])
    return 0


def cmd_notebook_start(args) -> int:
    return _start_ntsc(args, "notebook")


def cmd_shell_start(args) -> int:
    return _start_ntsc(args, "shell")


def cmd_shell_exec(args) -> int:
    session = make_session(args)
    out = session.proxy(args.task_id, "/exec", "POST", {"cmd": args.cmd})
    if out.get("stdout"):
        sys.stdout.write(out["stdout"])
    if out.get("stderr"):
        sys.stderr.write(out["stderr"])
    return int(out.get("code", 1))


def cmd_command_run(args) -> int:
    return _start_ntsc(args, "command", cmd=args.cmd)


def cmd_tensorboard_start(args) -> int:
    ids = [int(x) for x in args.experiment_ids.split(",") if x]
    return _start_ntsc(args, "tensorboard", experiment_ids=ids)


def cmd_master_logs(args) -> int:
    out = make_session(args).get(
        f"/api/v1/master/logs?limit={args.limit}&offset={args.offset}")
    for rec in out["logs"]:
        print(f"[{rec['level']}] {rec['log']}")
    return 0


def cmd_trial_summary(args) -> int:
    rows = make_session(args).trial_metric_summary(args.trial_id)
    print_table(rows, ["group", "name", "count", "min", "max", "mean",
                       "last", "last_step"])
    return 0


def cmd_experiment_move(args) -> int:
    out = make_session(args).post(
        f"/api/v1/experiments/{args.experiment_id}/move",
        {"project_id": args.project_id})
    e = out["experiment"]
    print(f"Moved experiment {e['id']} to {e['workspace']}/{e['project']}")
    return 0


def cmd_experiment_label(args) -> int:
    labels = [x for x in args.labels.split(",") if x]
    out = make_session(args).request(
        "PATCH", f"/api/v1/experiments/{args.experiment_id}",
        {"labels": labels})
    print(f"Labels: {out['experiment']['labels']}")
    return 0


def cmd_experiment_progress(args) -> int:
    out = make_session(args).get(
        f"/api/v1/experiments/{args.experiment_id}/progress")
    print(f"{out['progress'] * 100:.1f}% "
          f"({out['units_done']:.0f}/{out['units_target']:.0f} units, "
          f"{out['state']})")
    return 0


def cmd_project_move(args) -> int:
    out = make_session(args).post(
        f"/api/v1/projects/{args.project_id}/move",
        {"workspace_id": args.workspace_id})
    print(f"Moved project {out['project']['id']} to workspace "
          f"{out['project']['workspace_id']}")
    return 0


def cmd_user_settings(args) -> int:
    session = make_session(args)
    if args.key is not None and args.value is not None:
        try:
            value = json.loads(args.value)
        except json.JSONDecodeError:
            value = args.value
        out = session.post("/api/v1/users/settings",
                           {"key": args.key, "value": value})
        print_json(out["settings"])
        return 0
    settings = session.get("/api/v1/users/settings")["settings"]
    if args.key is not None:
        # read one key; missing is a visible error, not a silent full dump
        if args.key not in settings:
            print(f"no setting {args.key!r}", file=sys.stderr)
            return 1
        print_json(settings[args.key])
        return 0
    print_json(settings)
    return 0


def cmd_agent_list(args) -> int:
    agents = make_session(args).list_agents()
    print_table(agents, ["id", "resource_pool", "slots", "topology",
                         "enabled", "address"])
    return 0


def cmd_job_list(args) -> int:
    queue = make_session(args).job_queue()
    print_table(queue, ["id", "task_type", "state", "slots", "priority",
                        "resource_pool"])
    return 0


def cmd_job_move(args) -> int:
    job = make_session(args).move_job(
        args.allocation_id, ahead_of=args.ahead_of, behind=args.behind)
    print(f"Moved {job['id']} (queued_at {job['queued_at']})")
    return 0


def cmd_job_set_priority(args) -> int:
    job = make_session(args).set_job_priority(args.allocation_id,
                                              args.priority)
    print(f"Set {job['id']} priority to {job['priority']}")
    return 0


def cmd_trace_export(args) -> int:
    """Convert shipped telemetry spans (a trial's, a whole experiment's,
    or a local span-record JSONL) into a Perfetto-loadable Chrome
    trace-event JSON file. ``--experiment`` stitches every component lane
    (runner + trials) sharing the experiment's trace_id into one file."""
    from determined_clone_tpu_torch.telemetry.chrome_trace import (
        spans_from_profiler_samples,
        stitch_chrome_trace,
        to_chrome_trace,
        validate_chrome_trace,
    )

    stitched = args.experiment is not None
    if args.from_file:
        with open(args.from_file) as f:
            samples = [json.loads(line) for line in f if line.strip()]
    elif stitched:
        samples = make_session(args).get(
            f"/api/v1/experiments/{args.experiment}/trace")["samples"]
    else:
        if args.trial_id is None:
            print("error: give a trial id, --experiment, or --from-file",
                  file=sys.stderr)
            return 2
        samples = make_session(args).trial_profiler_samples(
            args.trial_id, limit=args.limit)
    spans = spans_from_profiler_samples(samples)
    if not spans:
        print("no span samples found — the trial must run with "
              "observability: {enabled: true, ship_spans: true}",
              file=sys.stderr)
        return 1
    if stitched or any(s.get("process") for s in spans):
        trace = stitch_chrome_trace(spans)
    else:
        trace = to_chrome_trace(spans)
    problems = validate_chrome_trace(trace)
    if problems:  # can only come from malformed shipped records
        print("warning: trace has structural problems:\n  " +
              "\n  ".join(problems), file=sys.stderr)
    with open(args.output, "w") as f:
        json.dump(trace, f)
    lanes = trace.get("otherData", {}).get("processes")
    lane_note = f" across lanes {lanes}" if lanes else ""
    print(f"wrote {len(spans)} spans to {args.output}{lane_note} "
          f"(load at ui.perfetto.dev or chrome://tracing)")
    return 0


def cmd_trace_request(args) -> int:
    """Pull one request's stitched multi-process trace (front door →
    router → replica legs) out of a fleet's request archive
    (docs/observability.md "Request tracing & SLOs"). The archive's live
    ring survives kill -9, so partial legs of a request a replica died
    on are still retrievable."""
    from determined_clone_tpu_torch.telemetry.chrome_trace import (
        validate_chrome_trace,
    )
    from determined_clone_tpu_torch.telemetry.flight import (
        request_archive_summary,
        request_chrome_trace,
    )

    directory = args.archive_dir or os.environ.get(
        "DCT_REQUEST_ARCHIVE_DIR")
    if not directory:
        print("error: give --archive-dir (or set DCT_REQUEST_ARCHIVE_DIR)",
              file=sys.stderr)
        return 2
    try:
        trace = request_chrome_trace(directory, args.request_id)
    except KeyError:
        print(f"no spans for request {args.request_id!r} under "
              f"{directory}", file=sys.stderr)
        summary = request_archive_summary(directory)
        known = sorted(summary.get("live_request_ids") or [])
        if known:
            preview = ", ".join(known[:10])
            more = f" (+{len(known) - 10} more)" if len(known) > 10 else ""
            print(f"archived requests: {preview}{more}", file=sys.stderr)
        return 1
    problems = validate_chrome_trace(trace)
    if problems:  # only malformed records on disk can cause this
        print("warning: trace has structural problems:\n  " +
              "\n  ".join(problems), file=sys.stderr)
    with open(args.output, "w") as f:
        json.dump(trace, f)
    other = trace.get("otherData", {})
    trace_ids = other.get("trace_ids") or []
    tid_note = f" trace_id {trace_ids[0]}" if trace_ids else ""
    print(f"wrote {len(trace.get('traceEvents', []))} trace events for "
          f"request {args.request_id}{tid_note} to {args.output} "
          f"(load at ui.perfetto.dev or chrome://tracing)")
    return 0


def cmd_slo(args) -> int:
    """Multi-window burn-rate SLO readout (docs/observability.md
    "Request tracing & SLOs"): availability and latency objectives over
    the serving fleet, fast (5m/1h) and slow (6h/3d) windows. Reads the
    master's ``GET /api/v1/cluster/slo`` or, with ``--url``, a fleet
    front door's ``GET /v1/slo``."""
    from determined_clone_tpu_torch.telemetry.slo import format_slo

    if args.url:
        import urllib.request

        with urllib.request.urlopen(f"{args.url.rstrip('/')}/v1/slo",
                                    timeout=10) as resp:
            payload = json.loads(resp.read().decode("utf-8"))
    else:
        _, payload, _ = fetch_cluster_view(args, "/api/v1/cluster/slo",
                                           fold_fallback=False)
    evaluation = payload.get("slo")
    if evaluation is None:
        print("no SLO engine attached (serving fleets attach one when "
              "tracing is enabled)", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(evaluation, indent=2, default=str))
    else:
        print(format_slo(evaluation))
    return 0


def _timeseries_path(name: Optional[str], *, labels: Optional[str] = None,
                     window: float = 300.0, reduce: str = "raw",
                     q: float = 0.95) -> str:
    """Build the ``/api/v1/timeseries`` request path for one query."""
    from urllib.parse import urlencode

    if not name:
        return "/api/v1/timeseries"
    params = {"name": name, "window": f"{window:g}", "reduce": reduce,
              "q": f"{q:g}"}
    if labels:
        params["labels"] = labels
    return "/api/v1/timeseries?" + urlencode(params)


def _format_series_labels(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def cmd_query(args) -> int:
    """Windowed reductions over the master's embedded TSDB
    (docs/observability.md "Time series, queries & alert rules").
    Without a series name, lists what the TSDB holds; with one, runs
    ``GET /api/v1/timeseries`` and prints per-series reductions
    (``--reduce rate`` over a counter gives per-second throughput the
    aggregator's latest-wins gauges cannot)."""
    path = _timeseries_path(args.name, labels=args.labels,
                            window=args.window, reduce=args.reduce,
                            q=args.q)
    _, payload, _ = fetch_cluster_view(args, path, fold_fallback=False)
    if args.json:
        print(json.dumps(payload, indent=2, default=str))
        return 0
    if not args.name:
        stats = payload.get("stats") or {}
        budget = stats.get("memory_budget_bytes") or 0
        print(f"{stats.get('series', 0)} series, "
              f"{stats.get('samples', 0)} samples, "
              f"{stats.get('bytes_estimate', 0) / 1024.0:.0f} KiB of "
              f"{budget / 1024.0:.0f} KiB budget "
              f"({stats.get('scrapes_total', 0)} scrapes)")
        for name in payload.get("series") or []:
            print(f"  {name}")
        return 0
    series = payload.get("series") or []
    if not series:
        print(f"no series named {args.name!r} in the window",
              file=sys.stderr)
        return 1
    for s in series:
        label_s = _format_series_labels(s.get("labels") or {})
        head = (f"{args.name}{label_s} [{s.get('kind', 'gauge')}] "
                f"{args.reduce} over {args.window:g}s")
        if args.reduce == "raw":
            print(f"{head}: {s.get('n', 0)} samples")
            for t, v in s.get("samples") or []:
                print(f"  {t:.3f} {v:g}")
        else:
            v = s.get("value")
            v_s = f"{v:g}" if v is not None else "n/a (need ≥2 samples)"
            print(f"{head}: {v_s}")
    return 0


def cmd_alerts(args) -> int:
    """Alert-rule readout (docs/observability.md "Time series, queries
    & alert rules"): every configured rule with its state machine
    position (inactive/pending/firing/resolved), measured value, and
    hold-down. Reads the master's ``GET /api/v1/alerts``."""
    from determined_clone_tpu_torch.telemetry.rules import format_alerts

    _, payload, _ = fetch_cluster_view(args, "/api/v1/alerts",
                                       fold_fallback=False)
    if args.json:
        print(json.dumps(payload, indent=2, default=str))
    else:
        print(format_alerts(payload))
    return 0


_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def _sparkline(values: List[float], width: int = 32) -> str:
    vals = [v for v in values if v == v][-width:]
    if not vals:
        return "(no data)"
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK_BLOCKS[0] * len(vals)
    top = len(_SPARK_BLOCKS) - 1
    return "".join(_SPARK_BLOCKS[int((v - lo) / span * top)]
                   for v in vals)


def _top_frame(args, session) -> str:
    """One rendering of the ``dct top`` dashboard, built entirely from
    the master's query API so it shows exactly what the TSDB stored."""
    def query(name: str, reduce: str = "last",
              labels: Optional[str] = None) -> List[Dict[str, Any]]:
        path = _timeseries_path(name, labels=labels, window=args.window,
                                reduce=reduce)
        try:
            return session.get(path).get("series") or []
        except MasterError:
            return []

    def one(name: str, reduce: str = "last",
            labels: Optional[str] = None) -> Optional[float]:
        for s in query(name, reduce, labels):
            if s.get("value") is not None:
                return float(s["value"])
        return None

    def fmt(v: Optional[float], spec: str = "g") -> str:
        return format(v, spec) if v is not None else "n/a"

    def fmt_s(v: Optional[float]) -> str:
        return f"{v:.3f}s" if v is not None else "n/a"

    lines = [f"dct top — window {args.window:g}s"]
    replicas = one("dct_fleet_replicas")
    tps_now = one("dct_fleet_tokens_per_sec")
    lines.append(f"fleet: {fmt(replicas, '.0f')} replicas, "
                 f"{fmt(tps_now, '.1f')} tokens/s, "
                 f"queue {fmt(one('dct_fleet_queue_depth'), '.0f')}, "
                 f"p99 {fmt_s(one('dct_fleet_max_replica_p99_seconds'))}")
    tps_series = query("dct_fleet_tokens_per_sec", reduce="raw")
    tps_points = [v for s in tps_series
                  for _, v in s.get("samples") or []]
    lines.append(f"tokens/s  {_sparkline(tps_points)}")
    goodput = one("dct_goodput_cluster_fraction")
    hit = one("dct_exec_cache_hit_rate")
    lines.append(f"goodput {fmt(goodput, '.1%')}   "
                 f"exec-cache hit {fmt(hit, '.1%')}")
    queues = {(s.get("labels") or {}).get("component"): s.get("value")
              for s in query("serving_queue_depth")
              if (s.get("labels") or {}).get("component")}
    p99s = {(s.get("labels") or {}).get("component"): s.get("value")
            for s in query("serving_request_total_seconds",
                           labels="quantile=0.99")
            if (s.get("labels") or {}).get("component")}
    if queues or p99s:
        lines.append("replicas:")
        for comp in sorted(set(queues) | set(p99s)):
            lines.append(f"  {comp:<24} queue {fmt(queues.get(comp), '.0f'):>5}"
                         f"   p99 {fmt_s(p99s.get(comp))}")
    try:
        alerts = session.get("/api/v1/alerts")
    except MasterError:
        alerts = None
    if alerts is not None:
        firing = alerts.get("firing") or []
        if firing:
            lines.append(f"ALERTS FIRING: {', '.join(firing)}")
        else:
            lines.append(f"alerts: {len(alerts.get('rules') or [])} rules, "
                         "none firing")
    return "\n".join(lines) + "\n"


def cmd_top(args) -> int:
    """Live terminal dashboard over the master's time-series query API
    (docs/observability.md "Time series, queries & alert rules"):
    fleet throughput sparkline, per-replica queue/p99, goodput, exec
    cache hit rate, firing alerts. ``--once`` prints a single frame
    (tests and scripts); otherwise redraws every ``--interval``
    seconds until interrupted."""
    import time as _time

    session, _, _ = fetch_cluster_view(args, "/api/v1/timeseries",
                                       fold_fallback=False)
    if args.once:
        sys.stdout.write(_top_frame(args, session))
        return 0
    try:
        while True:
            frame = _top_frame(args, session)
            sys.stdout.write("\x1b[2J\x1b[H" + frame)
            sys.stdout.flush()
            _time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        print()
        return 0


def cmd_debug_flight(args) -> int:
    """Post-mortem dump of a flight-recorder ring (docs/observability.md):
    merge the surviving segments — including the ones a kill -9 left
    behind — into a validated Chrome trace plus a one-screen summary of
    what the process was doing when it died."""
    from determined_clone_tpu_torch.telemetry.chrome_trace import (
        validate_chrome_trace,
    )
    from determined_clone_tpu_torch.telemetry.flight import (
        flight_summary,
        flight_to_chrome_trace,
    )

    summary = flight_summary(args.directory)
    if not summary["segments"]:
        print(f"no flight segments found under {args.directory}",
              file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(summary, indent=2, default=str))
    else:
        print(f"flight ring: {summary['segments']} segments, "
              f"{summary['spans']} spans, "
              f"{summary['metric_snapshots']} metric snapshots")
        if summary["processes"]:
            print(f"processes: {', '.join(summary['processes'])}")
        if summary["last_batches_trained"] is not None:
            print(f"last recorded batches_trained: "
                  f"{summary['last_batches_trained']}")
        for name, n in sorted(summary["span_names"].items(),
                              key=lambda kv: -kv[1]):
            print(f"  {name}: {n}")
    trace = flight_to_chrome_trace(args.directory)
    problems = validate_chrome_trace(trace)
    if problems:  # only malformed records on disk can cause this
        print("warning: trace has structural problems:\n  " +
              "\n  ".join(problems), file=sys.stderr)
    with open(args.output, "w") as f:
        json.dump(trace, f)
    print(f"wrote {len(trace.get('traceEvents', []))} trace events to "
          f"{args.output} (load at ui.perfetto.dev or chrome://tracing)")
    return 0


def cmd_metrics(args) -> int:
    """Cluster-wide metrics view (`GET /metrics` + the master's summary
    endpoint): top trials by throughput, cluster quantiles, restart/
    fallback/retry counters — docs/observability.md."""
    from determined_clone_tpu_torch.telemetry.aggregate import format_summary

    if args.raw:
        master = args.master or os.environ.get("DCT_MASTER",
                                               "127.0.0.1:8080")
        url = f"http://{master}/metrics"
        import urllib.request

        with urllib.request.urlopen(url, timeout=10) as resp:
            sys.stdout.write(resp.read().decode("utf-8"))
        return 0
    session, summary, agg = fetch_cluster_view(args,
                                               "/api/v1/cluster/metrics")
    if agg is not None:
        # C++ masters have /metrics but no JSON summary route: the
        # folded exposition puts the scheduler's dct_master_sched_*
        # families in the same summary view
        print(format_summary(agg.summary()))
        try:
            sched = session.get("/api/v1/cluster/scheduler")
        except MasterError:
            return 0
        c = sched.get("counters") or {}
        print(f"scheduler: {int(c.get('submitted', 0))} submitted / "
              f"{int(c.get('scheduled', 0))} scheduled / "
              f"{int(c.get('running', 0))} running / "
              f"{int(c.get('completed', 0))} completed; "
              f"queue depth {int((sched.get('gauges') or {}).get('queue_depth', 0))}")
        return 0
    print(format_summary(summary))
    return 0


def cmd_goodput(args) -> int:
    """Goodput readout (docs/observability.md): what fraction of each
    trial's wall-clock trained the model, and where the badput went.
    Reads the master's rollup (``GET /api/v1/cluster/goodput``), falling
    back to the exposition text for masters without the JSON route; or
    merges an on-disk journal directory offline (``--dir``), restart legs
    folded into trial-lifetime accounts."""
    from determined_clone_tpu_torch.telemetry.goodput import (
        format_goodput,
        merge_goodput,
    )

    if args.dir:
        accounts = merge_goodput(args.dir)
        if args.experiment is not None:
            print("note: --experiment is ignored with --dir (journals are "
                  "keyed by trial id only)", file=sys.stderr)
        if not accounts:
            print(f"no goodput journals found under {args.dir}",
                  file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(accounts, indent=2, default=str))
        else:
            print(format_goodput(accounts))
        return 0

    # masters without the JSON route still expose the goodput_* gauge
    # families in /metrics: the folded text re-derives the rollup
    _, roll, agg = fetch_cluster_view(args, "/api/v1/cluster/goodput")
    if agg is not None:
        roll = agg.goodput_rollup()
    by_trial = roll.get("by_trial") or {}
    if args.experiment is not None:
        by_trial = {tid: acct for tid, acct in by_trial.items()
                    if acct.get("experiment_id") == args.experiment}
        roll = dict(roll, by_trial=by_trial)
    if args.json:
        print(json.dumps(roll, indent=2, default=str))
        return 0
    if not by_trial:
        print("no trials reporting goodput", file=sys.stderr)
        return 1
    cf = roll.get("cluster_fraction")
    cf_s = f"{cf:.1%}" if cf is not None else "n/a"
    print(f"cluster goodput (time-weighted): {cf_s} over "
          f"{roll.get('wall_total_s', 0.0):.1f}s wall")
    for tid in sorted(by_trial, key=lambda t: int(t) if str(t).isdigit()
                      else 0):
        acct = by_trial[tid]
        frac = acct.get("goodput_fraction")
        frac_s = f"{frac:.1%}" if frac is not None else "n/a"
        print(f"trial {tid}: goodput {frac_s} over "
              f"{acct.get('wall_s', 0.0):.2f}s wall")
        cats = acct.get("categories") or {}
        wall = max(float(acct.get("wall_s") or 0.0), 1e-9)
        for cat, secs in sorted(cats.items(), key=lambda kv: -kv[1]):
            if secs > 0:
                print(f"  {cat:<18} {secs:>9.3f}s  {secs / wall:6.1%}")
    return 0


def cmd_mesh(args) -> int:
    """Mesh observability readout (docs/parallelism.md): collective
    op/byte counts per (kind, axis), straggler events, and the worst
    comm-vs-compute fraction from the cluster metrics plane; or a
    MULTICHIP scaling artifact rendered from a file (``--file``) or
    measured fresh on a simulated mesh (``--run N``)."""
    from determined_clone_tpu_torch.telemetry.mesh import (
        format_multichip,
        validate_multichip,
    )

    if args.run is not None:
        # the bench spawns its own ranks: run it in a subprocess
        import subprocess
        proc = subprocess.run(
            [sys.executable, "-m",
             "determined_clone_tpu_torch.parallel.scaling_bench",
             "--devices", str(args.run), "--device", args.device,
             "--json"],
            capture_output=True, text=True, timeout=600)
        artifact = None
        for line in proc.stdout.splitlines():
            line = line.strip()
            if line.startswith("{"):
                try:
                    artifact = json.loads(line)
                except ValueError:
                    continue
        if proc.returncode != 0 or not isinstance(artifact, dict):
            print(f"scaling bench failed (rc={proc.returncode}): "
                  f"{proc.stderr.strip()[-400:]}", file=sys.stderr)
            return 1
    elif args.file:
        with open(args.file) as f:
            obj = json.load(f)
        artifact = obj
        if isinstance(obj, dict) and "tail" in obj and "meshes" not in obj:
            # a MULTICHIP_rN.json round wrapper: the artifact is the last
            # JSON line of the round's stdout tail
            artifact = None
            for line in str(obj["tail"]).splitlines():
                line = line.strip()
                if line.startswith("{"):
                    try:
                        artifact = json.loads(line)
                    except ValueError:
                        continue
            if artifact is None:
                print(f"{args.file}: no artifact line in wrapper tail",
                      file=sys.stderr)
                return 1
    else:
        # cluster plane: fold the master's /metrics exposition through the
        # aggregator and print the mesh rollup
        from determined_clone_tpu_torch.telemetry.aggregate import (
            ClusterMetricsAggregator,
        )
        import urllib.request

        session = make_session(args)
        url = f"http://{session.host}:{session.port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as resp:
            text = resp.read().decode("utf-8")
        agg = ClusterMetricsAggregator()
        agg.ingest_prometheus_text("master", text)
        roll = agg.mesh_rollup()
        if roll is None:
            print("no mesh metrics reported (no sharded program has "
                  "exported collective accounting yet)", file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(roll, indent=2, default=str))
            return 0
        for kind, axes in sorted((roll.get("collective_ops") or {}).items()):
            for ax, cnt in sorted(axes.items()):
                b = (roll.get("collective_bytes") or {}).get(
                    kind, {}).get(ax)
                b_s = f", {b:.0f} B/exec" if isinstance(b, (int, float)) \
                    else ""
                print(f"collective {kind}[{ax}]: {cnt:.0f} ops{b_s}")
        for dev, cnt in sorted((roll.get("straggler_events") or {}).items()):
            print(f"straggler events {dev}: {cnt:.0f}")
        worst = roll.get("worst_comm_fraction")
        if isinstance(worst, dict):
            print(f"worst comm/compute fraction: "
                  f"{worst.get('fraction'):.1%} ({worst.get('program')})")
        return 0

    problems = validate_multichip(artifact)
    if args.json:
        print(json.dumps(artifact, indent=2, default=str))
    else:
        print(format_multichip(artifact))
    if problems:
        print("schema problems: " + "; ".join(problems[:5]),
              file=sys.stderr)
        return 1
    return 0


def cmd_serve(args: argparse.Namespace) -> int:
    """Serve a GPT over HTTP with continuous batching over a paged KV
    cache. ``--selftest`` binds an ephemeral port, drives a few
    generations through the HTTP surface, prints the engine stats as
    JSON, and exits."""
    from determined_clone_tpu_torch.config.experiment import ServingConfig
    from determined_clone_tpu_torch.device import resolve_device
    from determined_clone_tpu_torch.serving import InferenceEngine
    from determined_clone_tpu_torch.serving.http import (
        ServingHTTPServer,
        generate_over_http,
    )

    device = resolve_device(args.device)
    scfg = ServingConfig()
    if args.config:
        raw = load_config_file(args.config)
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
    model_cfg, params = _tiny_params(args, device)
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


def cmd_fleet_up(args) -> int:
    """Run a serving fleet: N engine replicas behind the least-loaded
    router with an HTTP front door (docs/serving.md). With --with-master
    the replicas are gang allocations of the master's `serving` type
    (they occupy scheduler slots and show up in dct_master_sched_*);
    standalone otherwise. `--selftest` drives traffic through the HTTP
    surface, prints fleet stats as JSON, and exits."""
    import dataclasses as _dc
    import time

    from determined_clone_tpu_torch.device import resolve_device
    from determined_clone_tpu_torch.serving import MasterLink, ServingFleet
    from determined_clone_tpu_torch.serving.http import (
        FleetHTTPServer,
        generate_over_http,
    )

    if args.model != "tiny":
        print(f"error: unknown model preset {args.model!r} (have: tiny)",
              file=sys.stderr)
        return 2
    session = make_session(args) if args.with_master else None
    if session is not None and session.host not in ("127.0.0.1",
                                                    "localhost"):
        print("error: --with-master needs a local master "
              "(the fleet link speaks the loopback agent "
              "protocol)", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    model_cfg, params = _tiny_params(args, device)
    fleet = ServingFleet(params, model_cfg, name=args.name,
                         iteration_floor_s=args.iteration_floor,
                         device=device)
    link = None
    try:
        if session is not None:
            link = MasterLink(fleet, session.port, replicas=args.replicas,
                              resource_pool=args.resource_pool)
            link.wait_replicas(args.replicas, timeout=120)
        else:
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
                    "with_master": bool(link), "device": str(device),
                    "stats": _dc.asdict(fleet.stats())}))
                return 0
            print(f"fleet {fleet.name!r}: {args.replicas} replicas on "
                  f"{server.url}"
                  + (" (master-managed" if link else " (standalone")
                  + f"; {device})")
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                return 0
    finally:
        if link is not None:
            link.close(kill_fleet=True)
        fleet.close()


def cmd_fleet_status(args) -> int:
    """Fleet health: from a fleet front door (--url → GET /v1/fleet) or
    from the master's serving-fleet records (GET /api/v1/serving/fleets)."""
    import urllib.request

    if args.url:
        with urllib.request.urlopen(f"{args.url.rstrip('/')}/v1/fleet",
                                    timeout=10) as resp:
            view = json.loads(resp.read().decode("utf-8"))
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
    session = make_session(args)
    fleets = session.get("/api/v1/serving/fleets").get("fleets", [])
    if args.json:
        print(json.dumps(fleets, indent=2))
        return 0
    if not fleets:
        print("no serving fleets")
        return 0
    for f in fleets:
        print(f"fleet {f['name']!r}: {f['running']} running / "
              f"{f['queued']} queued / {f['desired']} desired "
              f"(pool {f['resource_pool']}, "
              f"{f['slots_per_replica']} slots/replica)")
        for rep in f.get("replicas", []):
            print(f"  {rep['id']}: {rep['state']}")
    return 0


def cmd_fleet_rollout(args) -> int:
    """Blue-green checkpoint rollout through a fleet front door: the new
    version is proven on a drained canary before the rest of the fleet
    swaps, and no in-flight request ever spans a parameter change."""
    import urllib.request

    body = json.dumps({"checkpoint": args.checkpoint}).encode("utf-8")
    req = urllib.request.Request(
        f"{args.url.rstrip('/')}/v1/rollout", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=args.timeout) as resp:
        report = json.loads(resp.read().decode("utf-8"))
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


def cmd_fleet_scale(args) -> int:
    """Resize a fleet: through the front door (--url, in-process drain)
    or through the master (drain-protected kill commands)."""
    import urllib.request

    if args.url:
        body = json.dumps({"replicas": args.replicas}).encode("utf-8")
        req = urllib.request.Request(
            f"{args.url.rstrip('/')}/v1/scale", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=args.timeout) as resp:
            view = json.loads(resp.read().decode("utf-8"))
        print(f"fleet now has {len(view['replicas'])} replicas: "
              f"{view['replicas']}")
        return 0
    session = make_session(args)
    session.post(f"/api/v1/serving/fleets/{args.name}/scale",
                 {"replicas": args.replicas})
    print(f"fleet {args.name!r} scaling to {args.replicas} replicas "
          f"(drain-protected)")
    return 0


def cmd_lint(args) -> int:
    """Run the dctlint static-analysis suite (docs/static_analysis.md).
    The linter lives in the repo's tools/ package (it is developer
    tooling, not shipped library code), so resolve it relative to the
    source checkout when it isn't already importable."""
    try:
        from tools.dctlint.__main__ import main as dctlint_main
    except ImportError:
        import determined_clone_tpu_torch

        repo_root = os.path.dirname(os.path.dirname(
            os.path.abspath(determined_clone_tpu_torch.__file__)))
        if not os.path.isdir(os.path.join(repo_root, "tools", "dctlint")):
            print("error: tools/dctlint not found — `dct lint` runs from "
                  "a source checkout", file=sys.stderr)
            return 2
        sys.path.insert(0, repo_root)
        from tools.dctlint.__main__ import main as dctlint_main

    argv: List[str] = list(args.paths)
    if args.select:
        argv += ["--select", args.select]
    if args.no_baseline:
        argv.append("--no-baseline")
    if args.write_baseline:
        argv.append("--write-baseline")
    if args.list_checkers:
        argv.append("--list-checkers")
    if args.json:
        argv += ["--format", "json"]
    return dctlint_main(argv)


def cmd_deploy_gcp_up(args) -> int:
    return _refuse("deploy gcp (it provisions TPU VMs)", "item 6: TPU VMs")


def cmd_deploy_gcp_down(args) -> int:
    return _refuse("deploy gcp (it provisions TPU VMs)", "item 6: TPU VMs")


def cmd_deploy_gke_up(args) -> int:
    return _refuse("deploy gke (it provisions TPU VMs)", "item 6: TPU VMs")


def cmd_deploy_gke_down(args) -> int:
    return _refuse("deploy gke (it provisions TPU VMs)", "item 6: TPU VMs")


def cmd_user_login(args) -> int:
    session = make_session(args)
    import getpass

    password = args.password
    if password is None:
        password = getpass.getpass(f"Password for {args.username}: ")
    session.login(args.username, password)
    master = args.master or os.environ.get("DCT_MASTER", "127.0.0.1:8080")
    store = load_auth_store()
    store[master] = session.token
    save_auth_store(store)
    print(f"Logged in as {args.username}")
    return 0


def cmd_user_logout(args) -> int:
    session = make_session(args)
    try:
        session.logout()
    except MasterError:
        pass
    master = args.master or os.environ.get("DCT_MASTER", "127.0.0.1:8080")
    store = load_auth_store()
    store.pop(master, None)
    save_auth_store(store)
    print("Logged out")
    return 0


def cmd_user_whoami(args) -> int:
    print_json(make_session(args).whoami())
    return 0


def cmd_user_create(args) -> int:
    user = make_session(args).create_user(
        args.username, args.password or "", admin=args.admin)
    print(f"Created user {user['username']} (id {user['id']})")
    return 0


def cmd_user_list(args) -> int:
    print_table(make_session(args).list_users(),
                ["id", "username", "admin", "active"])
    return 0


def cmd_workspace_create(args) -> int:
    ws = make_session(args).create_workspace(args.name)
    print(f"Created workspace {ws['name']} (id {ws['id']})")
    return 0


def cmd_workspace_list(args) -> int:
    print_table(make_session(args).list_workspaces(),
                ["id", "name", "owner", "archived"])
    return 0


def cmd_workspace_describe(args) -> int:
    print_json(make_session(args).get_workspace(args.workspace_id))
    return 0


def cmd_project_create(args) -> int:
    proj = make_session(args).create_project(
        args.workspace_id, args.name, args.description or "")
    print(f"Created project {proj['name']} (id {proj['id']})")
    return 0


def cmd_model_create(args) -> int:
    model = make_session(args).create_model(
        args.name, description=args.description or "")
    print(f"Created model {model['name']} (id {model['id']})")
    return 0


def cmd_model_list(args) -> int:
    print_table(make_session(args).list_models(),
                ["id", "name", "workspace", "archived"])
    return 0


def cmd_model_describe(args) -> int:
    print_json(make_session(args).get_model(args.name))
    return 0


def cmd_model_register_version(args) -> int:
    v = make_session(args).register_model_version(
        args.name, args.checkpoint_uuid)
    print(f"Registered {args.name} version {v['version']}")
    return 0


def cmd_template_set(args) -> int:
    make_session(args).set_template(args.name, load_config_file(args.config))
    print(f"Set template {args.name}")
    return 0


def cmd_template_list(args) -> int:
    print_table(make_session(args).list_templates(), ["name"])
    return 0


def cmd_template_describe(args) -> int:
    print_json(make_session(args).get_template(args.name))
    return 0


def cmd_template_delete(args) -> int:
    make_session(args).delete_template(args.name)
    print(f"Deleted template {args.name}")
    return 0


def cmd_webhook_create(args) -> int:
    hook = make_session(args).create_webhook(
        args.url, triggers=args.trigger or [], webhook_type=args.type)
    print(f"Created webhook {hook['id']}")
    return 0


def cmd_webhook_list(args) -> int:
    print_table(make_session(args).get("/api/v1/webhooks")["webhooks"],
                ["id", "url", "webhook_type", "triggers"])
    return 0


def cmd_webhook_delete(args) -> int:
    make_session(args).request("DELETE", f"/api/v1/webhooks/{args.webhook_id}")
    print(f"Deleted webhook {args.webhook_id}")
    return 0


def cmd_group_create(args) -> int:
    g = make_session(args).create_group(args.name, user_ids=args.user or [])
    print(f"Created group {g['name']} (id {g['id']})")
    return 0


def cmd_group_list(args) -> int:
    print_table(make_session(args).list_groups(), ["id", "name", "user_ids"])
    return 0


def cmd_group_members(args) -> int:
    g = make_session(args).update_group_members(
        args.group_id, add=args.add or [], remove=args.remove or [])
    print(f"Group {g['name']} members: {g['user_ids']}")
    return 0


def cmd_group_delete(args) -> int:
    make_session(args).delete_group(args.group_id)
    print(f"Deleted group {args.group_id}")
    return 0


def cmd_rbac_list_roles(args) -> int:
    print_table(make_session(args).list_roles(), ["name", "rank"])
    return 0


def cmd_rbac_assign(args) -> int:
    a = make_session(args).assign_role(
        args.role, user_id=args.user_id or 0, group_id=args.group_id or 0,
        workspace_id=args.workspace_id or 0)
    print(f"Assigned {a['role']} (assignment {a['id']})")
    return 0


def cmd_rbac_list_assignments(args) -> int:
    print_table(make_session(args).list_role_assignments(),
                ["id", "role", "user_id", "group_id", "workspace_id"])
    return 0


def cmd_rbac_unassign(args) -> int:
    make_session(args).remove_role_assignment(args.assignment_id)
    print(f"Removed assignment {args.assignment_id}")
    return 0


def cmd_rbac_me(args) -> int:
    print_json(make_session(args).my_permissions(args.workspace_id or 0))
    return 0


def cmd_deploy_up(args: argparse.Namespace) -> int:
    from determined_clone_tpu_torch.deploy import cluster_up

    state = cluster_up(
        n_agents=args.agents, slots_per_agent=args.slots_per_agent,
        port=args.port, topology=args.topology or "",
        scheduler=args.scheduler, auth_required=args.auth_required,
        device=args.device)
    slots = (f"{args.slots_per_agent} slot(s)"
             if args.slots_per_agent is not None else "detected slots")
    print(f"Local cluster up: master 127.0.0.1:{state['port']} "
          f"({args.agents} agent(s) x {slots})")
    print(f"  export DCT_MASTER=127.0.0.1:{state['port']}")
    return 0


def cmd_deploy_down(args) -> int:
    from determined_clone_tpu_torch.deploy import cluster_down

    out = cluster_down()
    print(f"Stopped {out['stopped']} process(es)")
    return 0


def cmd_deploy_status(args) -> int:
    from determined_clone_tpu_torch.deploy import cluster_status

    print_json(cluster_status())
    return 0


# ---------------------------------------------------------------------------
# parser tree
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m determined_clone_tpu_torch.cli",
        description="determined-clone-tpu CLI (the PyTorch/H100 port)")
    parser.add_argument("-m", "--master", default=None,
                        help="master address host:port (env DCT_MASTER)")
    sub = parser.add_subparsers(dest="command", required=True)

    # master
    p_master = sub.add_parser("master", help="master info")
    sm = p_master.add_subparsers(dest="subcommand", required=True)
    sm.add_parser("info").set_defaults(func=cmd_master_info)
    sm.add_parser("config").set_defaults(func=cmd_master_config)
    c = sm.add_parser("logs")
    c.add_argument("--limit", type=int, default=200)
    c.add_argument("--offset", type=int, default=0)
    c.set_defaults(func=cmd_master_logs)

    # experiment
    p_exp = sub.add_parser("experiment", aliases=["e"], help="experiments")
    se = p_exp.add_subparsers(dest="subcommand", required=True)
    c = se.add_parser("create")
    c.add_argument("config", help="experiment config YAML")
    c.add_argument("model_dir", nargs="?", default=None,
                   help="model definition directory to upload")
    c.add_argument("--config-override", action="append", default=[],
                   metavar="KEY=VALUE", help="dotted-path config override")
    c.add_argument("-f", "--follow", action="store_true",
                   help="wait for completion")
    c.add_argument("--timeout", type=float, default=3600)
    c.set_defaults(func=cmd_experiment_create)
    c = se.add_parser("list")
    c.add_argument("--show-archived", action="store_true",
                   help="include archived experiments")
    c.set_defaults(func=cmd_experiment_list)
    c = se.add_parser("describe")
    c.add_argument("experiment_id", type=int)
    c.set_defaults(func=cmd_experiment_describe)
    c = se.add_parser("kill")
    c.add_argument("experiment_id", type=int)
    c.set_defaults(func=cmd_experiment_kill)
    for action, fn in (("pause", cmd_experiment_pause),
                       ("activate", cmd_experiment_activate),
                       ("delete", cmd_experiment_delete)):
        c = se.add_parser(action)
        c.add_argument("experiment_id", type=int)
        c.set_defaults(func=fn)
    c = se.add_parser("move")
    c.add_argument("experiment_id", type=int)
    c.add_argument("project_id", type=int)
    c.set_defaults(func=cmd_experiment_move)
    c = se.add_parser("label")
    c.add_argument("experiment_id", type=int)
    c.add_argument("labels", help="comma-separated; empty string clears")
    c.set_defaults(func=cmd_experiment_label)
    c = se.add_parser("progress")
    c.add_argument("experiment_id", type=int)
    c.set_defaults(func=cmd_experiment_progress)
    c = se.add_parser("archive")
    c.add_argument("experiment_id", type=int)
    c.add_argument("--unarchive", action="store_true")
    c.set_defaults(func=cmd_experiment_archive)

    # trial
    p_trial = sub.add_parser("trial", aliases=["t"], help="trials")
    st = p_trial.add_subparsers(dest="subcommand", required=True)
    c = st.add_parser("describe")
    c.add_argument("trial_id", type=int)
    c.set_defaults(func=cmd_trial_describe)
    c = st.add_parser("kill")
    c.add_argument("trial_id", type=int)
    c.set_defaults(func=cmd_trial_kill)
    c = st.add_parser("summary")
    c.add_argument("trial_id", type=int)
    c.set_defaults(func=cmd_trial_summary)
    c = st.add_parser("metrics")
    c.add_argument("trial_id", type=int)
    c.add_argument("--limit", type=int, default=1000)
    c.set_defaults(func=cmd_trial_metrics)
    c = st.add_parser("logs")
    c.add_argument("trial_id", type=int)
    c.add_argument("-f", "--follow", action="store_true",
                   help="live-tail: long-poll for new lines until the "
                        "trial is terminal")
    c.set_defaults(func=cmd_trial_logs)

    # checkpoint
    p_ckpt = sub.add_parser("checkpoint", aliases=["c"], help="checkpoints")
    sc = p_ckpt.add_subparsers(dest="subcommand", required=True)
    c = sc.add_parser("list")
    c.add_argument("experiment_id", type=int)
    c.set_defaults(func=cmd_checkpoint_list)
    c = sc.add_parser("describe")
    c.add_argument("uuid")
    c.set_defaults(func=cmd_checkpoint_describe)
    c = sc.add_parser("download")
    c.add_argument("uuid")
    c.add_argument("-o", "--output-dir", default=".")
    c.set_defaults(func=cmd_checkpoint_download)
    c = sc.add_parser("stats",
                      help="content-addressed store dedup ratio + "
                           "chunk-cache hit rate: not ported (ROADMAP.md, "
                           "Queue 1, item 4.3)")
    c.add_argument("--config", default=None,
                   help="experiment config yaml with a checkpoint_storage "
                        "cas block")
    c.add_argument("--host-path", default=None,
                   help="shared_fs storage root (shortcut for a config)")
    c.add_argument("--cache-path", default=None,
                   help="local chunk-cache dir (with --host-path)")
    c.set_defaults(func=cmd_checkpoint_stats)

    # exec-cache (persistent compiled-executable cache on the CAS store)
    p_exec = sub.add_parser(
        "exec-cache",
        help="persistent AOT executable cache on the CAS blob store: "
             "not ported (ROADMAP.md, Queue 1, item 6)")
    se = p_exec.add_subparsers(dest="subcommand", required=True)
    c = se.add_parser("stats",
                      help="entries, bytes, per-program breakdown, "
                           "session hit rate")
    c.add_argument("--config", default=None,
                   help="experiment config yaml with a checkpoint_storage "
                        "cas block")
    c.add_argument("--host-path", default=None,
                   help="shared_fs storage root (shortcut for a config)")
    c.add_argument("--dir", default=None,
                   help="bare exec-cache root (the DCT_EXEC_CACHE_DIR "
                        "convention)")
    c.set_defaults(func=cmd_exec_cache_stats)

    # kv (fleet-wide KV memory hierarchy — docs/serving.md)
    p_kv = sub.add_parser(
        "kv", help="fleet-wide KV memory hierarchy (host tier + "
                   "cas/kv/ spill)")
    skv = p_kv.add_subparsers(dest="subcommand", required=True)
    c = skv.add_parser("stats",
                       help="tier entries, bytes, hit split, CAS spill "
                            "accounting")
    c.add_argument("--url", default=None,
                   help="fleet front-door URL (live host-tier + CAS "
                        "counters)")
    c.add_argument("--host-path", default=None,
                   help="shared_fs storage root holding cas/kv/")
    c.set_defaults(func=cmd_kv_stats)

    # task (generic) + NTSC types
    p_task = sub.add_parser("task", help="NTSC tasks")
    stk = p_task.add_subparsers(dest="subcommand", required=True)
    c = stk.add_parser("list")
    c.add_argument("--type", default=None)
    c.set_defaults(func=cmd_task_list)
    c = stk.add_parser("kill")
    c.add_argument("task_id")
    c.set_defaults(func=cmd_task_kill)
    c = stk.add_parser("logs")
    c.add_argument("task_id")
    c.add_argument("-f", "--follow", action="store_true",
                   help="live-tail until the task is terminal")
    c.set_defaults(func=cmd_task_logs)

    p_nb = sub.add_parser("notebook", help="notebook tasks")
    sn = p_nb.add_subparsers(dest="subcommand", required=True)
    sn.add_parser("list").set_defaults(
        func=lambda a: _list_ntsc(a, "notebook"))
    c = sn.add_parser("start")
    c.add_argument("--name", default=None)
    c.add_argument("--idle-timeout", type=float, default=None)
    c.set_defaults(func=cmd_notebook_start)

    p_sh = sub.add_parser("shell", help="shell tasks")
    ss = p_sh.add_subparsers(dest="subcommand", required=True)
    ss.add_parser("list").set_defaults(
        func=lambda a: _list_ntsc(a, "shell"))
    c = ss.add_parser("start")
    c.add_argument("--name", default=None)
    c.add_argument("--idle-timeout", type=float, default=None)
    c.set_defaults(func=cmd_shell_start)
    c = ss.add_parser("exec")
    c.add_argument("task_id")
    c.add_argument("cmd", nargs="+")
    c.set_defaults(func=cmd_shell_exec)

    p_cmd = sub.add_parser("cmd", help="command tasks")
    scm = p_cmd.add_subparsers(dest="subcommand", required=True)
    scm.add_parser("list").set_defaults(
        func=lambda a: _list_ntsc(a, "command"))
    c = scm.add_parser("run")
    c.add_argument("--name", default=None)
    c.add_argument("cmd", nargs="+")
    c.set_defaults(func=cmd_command_run)

    p_tb = sub.add_parser("tensorboard", help="tensorboard tasks")
    stb = p_tb.add_subparsers(dest="subcommand", required=True)
    stb.add_parser("list").set_defaults(
        func=lambda a: _list_ntsc(a, "tensorboard"))
    c = stb.add_parser("start")
    c.add_argument("experiment_ids", help="comma-separated experiment ids")
    c.add_argument("--name", default=None)
    c.set_defaults(func=cmd_tensorboard_start)

    # agent / job
    p_agent = sub.add_parser("agent", aliases=["a"], help="agents")
    sa = p_agent.add_subparsers(dest="subcommand", required=True)
    sa.add_parser("list").set_defaults(func=cmd_agent_list)

    p_job = sub.add_parser("job", aliases=["j"], help="job queue")
    sj = p_job.add_subparsers(dest="subcommand", required=True)
    sj.add_parser("list").set_defaults(func=cmd_job_list)
    c = sj.add_parser("move")
    c.add_argument("allocation_id")
    g = c.add_mutually_exclusive_group(required=True)
    g.add_argument("--ahead-of", default="")
    g.add_argument("--behind", default="")
    c.set_defaults(func=cmd_job_move)
    c = sj.add_parser("set-priority")
    c.add_argument("allocation_id")
    c.add_argument("priority", type=int)
    c.set_defaults(func=cmd_job_set_priority)

    # user
    p_user = sub.add_parser("user", aliases=["u"], help="users")
    su = p_user.add_subparsers(dest="subcommand", required=True)
    c = su.add_parser("login")
    c.add_argument("username")
    c.add_argument("--password", default=None)
    c.set_defaults(func=cmd_user_login)
    su.add_parser("logout").set_defaults(func=cmd_user_logout)
    su.add_parser("whoami").set_defaults(func=cmd_user_whoami)
    c = su.add_parser("create")
    c.add_argument("username")
    c.add_argument("--password", default=None)
    c.add_argument("--admin", action="store_true")
    c.set_defaults(func=cmd_user_create)
    su.add_parser("list").set_defaults(func=cmd_user_list)
    c = su.add_parser("settings")
    c.add_argument("key", nargs="?", default=None)
    c.add_argument("value", nargs="?", default=None,
                   help="JSON value (bare strings accepted)")
    c.set_defaults(func=cmd_user_settings)

    # workspace / project
    p_ws = sub.add_parser("workspace", aliases=["w"], help="workspaces")
    sw = p_ws.add_subparsers(dest="subcommand", required=True)
    c = sw.add_parser("create")
    c.add_argument("name")
    c.set_defaults(func=cmd_workspace_create)
    sw.add_parser("list").set_defaults(func=cmd_workspace_list)
    c = sw.add_parser("describe")
    c.add_argument("workspace_id", type=int)
    c.set_defaults(func=cmd_workspace_describe)

    p_proj = sub.add_parser("project", aliases=["p"], help="projects")
    sp = p_proj.add_subparsers(dest="subcommand", required=True)
    c = sp.add_parser("move")
    c.add_argument("project_id", type=int)
    c.add_argument("workspace_id", type=int)
    c.set_defaults(func=cmd_project_move)
    c = sp.add_parser("create")
    c.add_argument("workspace_id", type=int)
    c.add_argument("name")
    c.add_argument("--description", default=None)
    c.set_defaults(func=cmd_project_create)

    # model registry
    p_model = sub.add_parser("model", help="model registry")
    smo = p_model.add_subparsers(dest="subcommand", required=True)
    c = smo.add_parser("create")
    c.add_argument("name")
    c.add_argument("--description", default=None)
    c.set_defaults(func=cmd_model_create)
    smo.add_parser("list").set_defaults(func=cmd_model_list)
    c = smo.add_parser("describe")
    c.add_argument("name")
    c.set_defaults(func=cmd_model_describe)
    c = smo.add_parser("register-version")
    c.add_argument("name")
    c.add_argument("checkpoint_uuid")
    c.set_defaults(func=cmd_model_register_version)

    # template
    p_tpl = sub.add_parser("template", help="config templates")
    stp = p_tpl.add_subparsers(dest="subcommand", required=True)
    c = stp.add_parser("set")
    c.add_argument("name")
    c.add_argument("config")
    c.set_defaults(func=cmd_template_set)
    stp.add_parser("list").set_defaults(func=cmd_template_list)
    c = stp.add_parser("describe")
    c.add_argument("name")
    c.set_defaults(func=cmd_template_describe)
    c = stp.add_parser("delete")
    c.add_argument("name")
    c.set_defaults(func=cmd_template_delete)

    # webhook
    p_wh = sub.add_parser("webhook", help="webhooks")
    swh = p_wh.add_subparsers(dest="subcommand", required=True)
    c = swh.add_parser("create")
    c.add_argument("url")
    c.add_argument("--trigger", action="append", default=None,
                   help="experiment state that fires the hook (repeatable)")
    c.add_argument("--type", default="default",
                   choices=["default", "slack"])
    c.set_defaults(func=cmd_webhook_create)
    swh.add_parser("list").set_defaults(func=cmd_webhook_list)
    c = swh.add_parser("delete")
    c.add_argument("webhook_id", type=int)
    c.set_defaults(func=cmd_webhook_delete)

    # group (≈ det user-group)
    p_grp = sub.add_parser("group", help="user groups")
    sg = p_grp.add_subparsers(dest="subcommand", required=True)
    c = sg.add_parser("create")
    c.add_argument("name")
    c.add_argument("--user", action="append", type=int, default=None,
                   help="user id to add (repeatable)")
    c.set_defaults(func=cmd_group_create)
    sg.add_parser("list").set_defaults(func=cmd_group_list)
    c = sg.add_parser("members")
    c.add_argument("group_id", type=int)
    c.add_argument("--add", action="append", type=int, default=None)
    c.add_argument("--remove", action="append", type=int, default=None)
    c.set_defaults(func=cmd_group_members)
    c = sg.add_parser("delete")
    c.add_argument("group_id", type=int)
    c.set_defaults(func=cmd_group_delete)

    # rbac (≈ det rbac)
    p_rbac = sub.add_parser("rbac", help="roles and assignments")
    sr = p_rbac.add_subparsers(dest="subcommand", required=True)
    sr.add_parser("list-roles").set_defaults(func=cmd_rbac_list_roles)
    c = sr.add_parser("assign")
    c.add_argument("role")
    c.add_argument("--user-id", type=int, default=None)
    c.add_argument("--group-id", type=int, default=None)
    c.add_argument("--workspace-id", type=int, default=None)
    c.set_defaults(func=cmd_rbac_assign)
    sr.add_parser("list-assignments").set_defaults(
        func=cmd_rbac_list_assignments)
    c = sr.add_parser("unassign")
    c.add_argument("assignment_id", type=int)
    c.set_defaults(func=cmd_rbac_unassign)
    c = sr.add_parser("me")
    c.add_argument("--workspace-id", type=int, default=None)
    c.set_defaults(func=cmd_rbac_me)

    # trace (telemetry timeline export — docs/observability.md)
    p_trace = sub.add_parser("trace", help="telemetry trace export")
    str_ = p_trace.add_subparsers(dest="subcommand", required=True)
    c = str_.add_parser("export",
                        help="build a Chrome trace-event JSON from a "
                             "trial's shipped spans")
    c.add_argument("trial_id", type=int, nargs="?", default=None)
    c.add_argument("--experiment", type=int, default=None,
                   help="stitch every lane of this experiment (runner + "
                        "trials) into one multi-process trace")
    c.add_argument("--from-file", default=None,
                   help="read span records from a local JSONL instead of "
                        "the master")
    c.add_argument("-o", "--output", default="trace.json")
    c.add_argument("--limit", type=int, default=100000,
                   help="max profiler samples to pull from the master")
    c.set_defaults(func=cmd_trace_export)
    c = str_.add_parser("request",
                        help="pull one request's stitched trace (front "
                             "door → router → replica) from a fleet's "
                             "request archive")
    c.add_argument("request_id", help="the request_id to look up")
    c.add_argument("--archive-dir", default=None,
                   help="the fleet's request archive directory "
                        "(DCT_REQUEST_ARCHIVE_DIR)")
    c.add_argument("-o", "--output", default="request-trace.json")
    c.set_defaults(func=cmd_trace_request)

    # debug (post-mortem tooling — docs/observability.md)
    p_dbg = sub.add_parser("debug", help="post-mortem debugging tools")
    sdbg = p_dbg.add_subparsers(dest="subcommand", required=True)
    c = sdbg.add_parser("flight",
                        help="dump a flight-recorder ring (crash black "
                             "box) into a Chrome trace + summary")
    c.add_argument("directory",
                   help="the flight dir (observability.flight_dir / "
                        "DCT_FLIGHT_DIR) of the dead process")
    c.add_argument("-o", "--output", default="flight-trace.json")
    c.add_argument("--json", action="store_true",
                   help="print the summary as JSON")
    c.set_defaults(func=cmd_debug_flight)

    # metrics (cluster-wide observability plane — docs/observability.md)
    c = sub.add_parser("metrics",
                       help="cluster metrics: top trials by throughput, "
                            "quantiles, restart/retry counters")
    c.add_argument("--raw", action="store_true",
                   help="print the raw Prometheus exposition text")
    c.set_defaults(func=cmd_metrics)

    # goodput (wall-clock attribution ledger — docs/observability.md)
    c = sub.add_parser("goodput",
                       help="goodput/badput accounting: fraction of each "
                            "trial's wall-clock that trained the model")
    c.add_argument("--experiment", type=int, default=None,
                   help="only trials of this experiment")
    c.add_argument("--dir", default=None,
                   help="merge an on-disk goodput journal directory "
                        "(observability.goodput_dir / DCT_GOODPUT_DIR) "
                        "instead of asking the master")
    c.add_argument("--json", action="store_true",
                   help="print the accounts as JSON")
    c.set_defaults(func=cmd_goodput)

    # slo (multi-window burn-rate objectives — docs/observability.md)
    c = sub.add_parser("slo",
                       help="serving SLO readout: availability + latency "
                            "burn rates over fast/slow windows")
    c.add_argument("--url", default=None,
                   help="ask a fleet front door (http://host:port) "
                        "instead of the master")
    c.add_argument("--json", action="store_true",
                   help="print the evaluation as JSON")
    c.set_defaults(func=cmd_slo)

    # query (windowed reductions over the master TSDB —
    # docs/observability.md "Time series, queries & alert rules")
    c = sub.add_parser("query",
                       help="query the master's time-series store: "
                            "rate/avg/max/quantile over a window")
    c.add_argument("name", nargs="?", default=None,
                   help="series name (omit to list stored series)")
    c.add_argument("--labels", default=None, metavar="K=V[,K=V...]",
                   help="label subset the series must match")
    c.add_argument("--window", type=float, default=300.0, metavar="S",
                   help="lookback window in seconds (default 300)")
    c.add_argument("--reduce", default="raw",
                   choices=["raw", "rate", "increase", "avg", "max",
                            "min", "last", "quantile"],
                   help="reduction over the window (default raw)")
    c.add_argument("--q", type=float, default=0.95,
                   help="quantile for --reduce quantile (default 0.95)")
    c.add_argument("--json", action="store_true",
                   help="print the query result as JSON")
    c.set_defaults(func=cmd_query)

    # alerts (declarative rule engine readout — docs/observability.md)
    c = sub.add_parser("alerts",
                       help="alert rules: firing/pending/resolved state "
                            "per configured rule")
    c.add_argument("--json", action="store_true",
                   help="print the rule states as JSON")
    c.set_defaults(func=cmd_alerts)

    # top (live dashboard over the query API — docs/observability.md)
    c = sub.add_parser("top",
                       help="live cluster dashboard: throughput "
                            "sparkline, per-replica queue/p99, goodput, "
                            "firing alerts")
    c.add_argument("--once", action="store_true",
                   help="print one frame and exit (for scripts/tests)")
    c.add_argument("--interval", type=float, default=2.0, metavar="S",
                   help="redraw period in seconds (default 2)")
    c.add_argument("--window", type=float, default=300.0, metavar="S",
                   help="query lookback window in seconds (default 300)")
    c.set_defaults(func=cmd_top)

    # mesh (collective accounting + straggler + scaling readout —
    # docs/parallelism.md)
    c = sub.add_parser("mesh",
                       help="mesh observability: collective op/byte "
                            "counts, straggler events, multichip scaling "
                            "artifacts")
    c.add_argument("--file", default=None,
                   help="render a MULTICHIP artifact (raw or a round "
                        "MULTICHIP_rN.json wrapper) instead of asking "
                        "the master")
    c.add_argument("--run", type=int, default=None, metavar="N",
                   help="measure fresh on an N-device simulated mesh "
                        "(runs parallel/scaling_bench in a subprocess)")
    c.add_argument("--json", action="store_true",
                   help="print the artifact/rollup as JSON")
    c.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="with --run: the ranks' device (default cuda)")
    c.set_defaults(func=cmd_mesh)

    # serve (online inference: continuous batching + paged KV cache —
    # docs/serving.md)
    c = sub.add_parser("serve",
                       help="serve a GPT checkpoint over HTTP with "
                            "continuous batching and a paged KV cache")
    c.add_argument("--config", default=None,
                   help="experiment config yaml; its `serving:` block "
                        "sets buckets, KV pool, and admission knobs")
    c.add_argument("--checkpoint", default=None,
                   help="local checkpoint dir (core save_pytree layout) "
                        "to load params from; default: random init")
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
    c.set_defaults(func=cmd_serve, raw_errors=True)

    # fleet (replica gangs + router + blue-green rollout — docs/serving.md)
    p_fleet = sub.add_parser("fleet",
                             help="serving fleet: replica gangs behind a "
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
                   help="local checkpoint dir (core save_pytree layout)")
    c.add_argument("--iteration-floor", type=float, default=0.0,
                   help="simulated device-step floor in seconds (single-"
                        "host capacity modeling; see docs/serving.md)")
    c.add_argument("--with-master", action="store_true",
                   help="register the replicas as `serving` gang "
                        "allocations with the master (needs a local one)")
    c.add_argument("--resource-pool", default="default",
                   help="with --with-master: the pool the fleet's agent "
                        "and its allocations join (give the fleet its "
                        "own so replicas never land on a trial agent)")
    c.add_argument("--host", default=None)
    c.add_argument("--port", type=int, default=None)
    c.add_argument("--selftest", action="store_true",
                   help="drive traffic through the HTTP surface, print "
                        "fleet stats as JSON, exit")
    c.add_argument("--device", default="cuda",
                   help="torch device (default cuda; it raises without "
                        "one unless `cpu` is named)")
    c.set_defaults(func=cmd_fleet_up, raw_errors=True)

    c = fleet_sub.add_parser("status", help="fleet health from the front "
                                            "door or the master")
    c.add_argument("--url", default=None,
                   help="fleet front-door URL (default: ask the master)")
    c.add_argument("--json", action="store_true")
    c.set_defaults(func=cmd_fleet_status)

    c = fleet_sub.add_parser("rollout",
                             help="blue-green checkpoint rollout: canary "
                                  "first, drained swaps, zero failed "
                                  "requests")
    c.add_argument("--url", required=True,
                   help="fleet front-door URL")
    c.add_argument("--checkpoint", required=True,
                   help="checkpoint dir to roll out")
    c.add_argument("--timeout", type=float, default=300.0)
    c.add_argument("--json", action="store_true")
    c.set_defaults(func=cmd_fleet_rollout)

    c = fleet_sub.add_parser("scale", help="drain-protected fleet resize")
    c.add_argument("--replicas", type=int, required=True)
    c.add_argument("--url", default=None,
                   help="fleet front-door URL (default: ask the master; "
                        "--name selects the fleet)")
    c.add_argument("--name", default="fleet")
    c.add_argument("--timeout", type=float, default=300.0)
    c.set_defaults(func=cmd_fleet_scale)

    # lint (dctlint static analysis — docs/static_analysis.md)
    c = sub.add_parser("lint",
                       help="run the dctlint static-analysis suite over "
                            "the source tree")
    c.add_argument("paths", nargs="*", default=[],
                   help="files/directories (default: the tier-1 set: "
                        "determined_clone_tpu tools bench.py)")
    c.add_argument("--select", default=None,
                   help="comma-separated rule ids (e.g. JAX001,TIME001)")
    c.add_argument("--no-baseline", action="store_true")
    c.add_argument("--write-baseline", action="store_true")
    c.add_argument("--list-checkers", action="store_true")
    c.add_argument("--json", action="store_true")
    c.set_defaults(func=cmd_lint)

    # deploy
    p_dep = sub.add_parser("deploy", help="cluster deployment")
    sd = p_dep.add_subparsers(dest="subcommand", required=True)
    p_local = sd.add_parser("local", help="local process cluster: the C++ "
                                          "master and the port's agents")
    sdl = p_local.add_subparsers(dest="action", required=True)
    c = sdl.add_parser("cluster-up")
    c.add_argument("--agents", type=int, default=1)
    c.add_argument("--slots-per-agent", type=int, default=None,
                   help="slots per agent (default: each agent detects "
                        "its CUDA devices)")
    c.add_argument("--port", type=int, default=None)
    c.add_argument("--topology", default=None)
    c.add_argument("--scheduler", default="fifo",
                   choices=["fifo", "priority", "fair_share", "round_robin"])
    c.add_argument("--auth-required", action="store_true")
    c.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cpu: the agents run tasks on the CPU")
    c.set_defaults(func=cmd_deploy_up)
    sdl.add_parser("cluster-down").set_defaults(func=cmd_deploy_down)
    sdl.add_parser("status").set_defaults(func=cmd_deploy_status)
    p_gcp = sd.add_parser("gcp", help="GCP TPU-VM cluster: not ported "
                                      "(ROADMAP.md, Queue 1, item 6)")
    sdg = p_gcp.add_subparsers(dest="action", required=True)
    for action, fn in (("up", cmd_deploy_gcp_up),
                       ("down", cmd_deploy_gcp_down)):
        c = sdg.add_parser(action)
        c.add_argument("--project", required=True)
        c.add_argument("--zone", required=True)
        c.add_argument("--cluster-name", default="dct")
        c.add_argument("--agents", type=int, default=1)
        if action == "up":
            c.add_argument("--accelerator-type", default="v5litepod-8")
            c.add_argument("--auth-required", action="store_true")
        c.add_argument("--live", action="store_true",
                       help="actually run gcloud (default: print the plan)")
        c.set_defaults(func=fn)
    p_gke = sd.add_parser("gke", help="GKE + kubernetes RM on TPUs: not "
                                      "ported (ROADMAP.md, Queue 1, item 6)")
    sdk = p_gke.add_subparsers(dest="action", required=True)
    for action, fn in (("up", cmd_deploy_gke_up),
                       ("down", cmd_deploy_gke_down)):
        c = sdk.add_parser(action)
        c.add_argument("--project", required=True)
        c.add_argument("--zone", required=True)
        c.add_argument("--cluster", default="dct")
        c.add_argument("--namespace", default="dct")
        if action == "up":
            c.add_argument("--image", default="determined-clone-tpu:latest")
            c.add_argument("--accelerator-type", default="v5litepod-8")
            c.add_argument("--tpu-topology", default="2x4")
            c.add_argument("--manifests-out", default=None,
                           help="write the k8s manifests to this file")
        c.add_argument("--live", action="store_true")
        c.set_defaults(func=fn)

    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if getattr(args, "raw_errors", False):
        return args.func(args)
    try:
        return args.func(args)
    except (MasterError, RuntimeError, FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
