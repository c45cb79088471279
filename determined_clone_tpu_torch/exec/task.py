"""Generic NTSC task server — notebooks, shells, tensorboards; the port's
copy of ``determined_clone_tpu/exec/task.py``. It imports no torch: a task
is a zero-slot process, and its start-up is the user's wait.

≈ the reference's non-trial task containers (master/internal/command/
command.go builds the spec; the container runs jupyter/sshd/tensorboard and
the harness registers a proxy address, prep_container.py:231). Here one
runner covers the built-in types with a small HTTP app served behind the
master's reverse proxy (/proxy/<task_id>/...):

- ``shell``:       POST /exec {"cmd": [...]} → {stdout, stderr, code}
                   (the det-shell remote-exec capability without sshd;
                   shell-mode only — other modes 403 it)
- ``notebook``:    execs jupyter if installed (DCT_NOTEBOOK_REAL=1), else
                   serves a landing page

Every request must carry the allocation token (x-alloc-token, injected by
the master's reverse proxy) when DCT_ALLOC_TOKEN is set.
- ``tensorboard``: GET /data → metric history for the requested
                   experiments, fetched live from the master (the reference
                   TB task fetches tfevents from checkpoint storage;
                   tfevents fetching is wired in tensorboard.manager.fetch_events)

Usage (by the port's agent, which maps the argv built master-side in
routes.cc "tasks", ``python -m determined_clone_tpu.exec.task``, to this
module):
    python -m determined_clone_tpu_torch.exec.task <mode> [--experiment-ids 1,2]
"""
from __future__ import annotations

import atexit
import json
import os
import signal
import socket
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List


def _master() -> "MasterSession":
    from determined_clone_tpu_torch.api.client import MasterSession

    return MasterSession(
        host=os.environ.get("DCT_MASTER_HOST", "127.0.0.1"),
        port=int(os.environ.get("DCT_MASTER_PORT", "8080")),
    )


def local_address() -> str:
    """The local interface address the master can reach us on: the one this
    host uses to talk to the master (loopback when the master is local)."""
    master_host = os.environ.get("DCT_MASTER_HOST", "127.0.0.1")
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect((master_host,
                       int(os.environ.get("DCT_MASTER_PORT", "8080"))))
            return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"


def register_proxy(addr: str, port: int) -> None:
    """Tell the master where to reverse-proxy this task's HTTP traffic."""
    alloc_id = os.environ["DCT_ALLOCATION_ID"]
    _master().request(
        "POST", f"/api/v1/allocations/{alloc_id}/proxy",
        {"address": f"{addr}:{port}"}, retryable=True,
    )


def _per_experiment(experiment_ids: List[int], fn) -> Dict[str, Any]:
    """Shared scaffolding: fetch each experiment's detail from the master,
    map trials through ``fn(session, detail, trial) -> value``."""
    session = _master()
    out: Dict[str, Any] = {}
    for eid in experiment_ids:
        try:
            detail = session.request("GET", f"/api/v1/experiments/{eid}")
        except Exception as exc:  # experiment may be gone
            out[str(eid)] = {"error": str(exc)}
            continue
        trials = {}
        for trial in detail.get("trials", []):
            try:
                trials[str(trial["id"])] = fn(session, detail, trial)
            except Exception as exc:  # noqa: BLE001 - per-trial isolation
                trials[str(trial["id"])] = {"error": str(exc)}
        out[str(eid)] = {"trials": trials}
    return out


def fetch_tb_data(experiment_ids: List[int]) -> Dict[str, Any]:
    """Metric history per trial for each experiment, from the master."""
    def metrics_of(session, detail, trial):
        return session.request(
            "GET", f"/api/v1/trials/{trial['id']}/metrics?limit=10000"
        ).get("metrics", [])

    return _per_experiment(experiment_ids, metrics_of)


# per-(experiment, trial) incremental-fetch state for the TB task: cached
# event files + their last-seen storage sizes, so polling /scalars doesn't
# re-download full (append-only) files every few seconds. One lock
# serializes overlapping polls — ThreadingHTTPServer runs a thread per
# request and shutil.copy2 downloads are not atomic reads for a peer.
_TB_CACHE_DIR: Dict[Any, str] = {}
_TB_CACHE_SIZES: Dict[Any, Dict[str, int]] = {}
_TB_CACHE_LOCK = threading.Lock()


def _tb_cache_cleanup() -> None:
    import shutil

    for d in _TB_CACHE_DIR.values():
        shutil.rmtree(d, ignore_errors=True)


atexit.register(_tb_cache_cleanup)


def fetch_tb_scalars(experiment_ids: List[int]) -> Dict[str, Any]:
    """Download each trial's tfevents from the experiment's checkpoint
    storage and parse the scalar series (the `det tensorboard` data path)."""
    import tempfile

    from determined_clone_tpu_torch.tensorboard import (
        read_tfevents,
        sync_trial_events,
    )

    def scalars_of(session, detail, trial):
        exp = detail["experiment"]
        storage_raw = exp["config"].get("checkpoint_storage")
        if not storage_raw:
            return {"error": "experiment has no checkpoint storage"}
        key = (exp["id"], trial["id"])
        with _TB_CACHE_LOCK:
            if key not in _TB_CACHE_DIR:
                _TB_CACHE_DIR[key] = tempfile.mkdtemp(prefix="dct-tb-")
            files, sizes = sync_trial_events(
                storage_raw, exp["id"], trial["id"], _TB_CACHE_DIR[key],
                prev_sizes=_TB_CACHE_SIZES.get(key))
            _TB_CACHE_SIZES[key] = sizes
            series: Dict[str, list] = {}
            for path in files:
                try:
                    for event in read_tfevents(path):
                        for tag, value in event["scalars"].items():
                            series.setdefault(tag, []).append(
                                [event.get("step", 0), value])
                except (ValueError, OSError):
                    continue
        return {"scalars": series,
                "files": [os.path.basename(f) for f in files]}

    return _per_experiment(experiment_ids, scalars_of)


class TaskHandler(BaseHTTPRequestHandler):
    mode = "shell"
    experiment_ids: List[int] = []

    def _send(self, status: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args: Any) -> None:
        print("[task]", fmt % args, flush=True)

    def _authorized(self) -> bool:
        """Require the allocation token on every request: the only legitimate
        caller is the master's reverse proxy, which injects x-alloc-token.
        Interface binding is NOT the access boundary — on multi-host networks
        the port is reachable by any peer."""
        expected = os.environ.get("DCT_ALLOC_TOKEN", "")
        if not expected:
            return True  # tokenless dev mode (run outside an agent)
        import hmac

        got = self.headers.get("X-Alloc-Token", "")
        if not got:
            auth = self.headers.get("Authorization", "")
            if auth.startswith("Bearer "):
                got = auth[len("Bearer "):]
        return hmac.compare_digest(got, expected)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        if not self._authorized():
            self._send(401, {"error": "allocation token required"})
            return
        if self.path.rstrip("/") in ("", "/"):
            endpoints = ["/data (GET, tensorboard)"]
            if self.mode == "shell":
                endpoints.insert(0, "/exec (POST)")
            self._send(200, {
                "task": os.environ.get("DCT_ALLOCATION_ID", ""),
                "mode": self.mode,
                "endpoints": endpoints,
            })
            return
        if self.path.startswith("/data") and self.mode == "tensorboard":
            self._send(200, {"experiments": fetch_tb_data(self.experiment_ids)})
            return
        if self.path.startswith("/scalars") and self.mode == "tensorboard":
            # tfevents fetched from checkpoint storage via the per-backend
            # fetcher path (≈ the reference tensorboard/fetchers/), parsed locally
            self._send(200, {"experiments":
                             fetch_tb_scalars(self.experiment_ids)})
            return
        self._send(404, {"error": f"no route {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        if not self._authorized():
            self._send(401, {"error": "allocation token required"})
            return
        length = int(self.headers.get("Content-Length", "0"))
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            self._send(400, {"error": "invalid json"})
            return
        if self.path.startswith("/exec"):
            if self.mode != "shell":
                # remote argv execution is the det-shell capability only;
                # notebooks/tensorboards/commands must not expose it
                self._send(403, {"error": "/exec is shell-mode only"})
                return
            cmd = body.get("cmd")
            if not isinstance(cmd, list) or not cmd:
                self._send(400, {"error": "cmd must be a non-empty argv list"})
                return
            try:
                proc = subprocess.run(
                    [str(c) for c in cmd], capture_output=True, text=True,
                    timeout=float(body.get("timeout", 60)),
                )
                self._send(200, {
                    "stdout": proc.stdout, "stderr": proc.stderr,
                    "code": proc.returncode,
                })
            except subprocess.TimeoutExpired:
                self._send(200, {"stdout": "", "stderr": "timeout", "code": -1})
            return
        self._send(404, {"error": f"no route {self.path}"})


def main(argv: List[str]) -> int:
    mode = argv[0] if argv else "shell"
    experiment_ids: List[int] = []
    if "--experiment-ids" in argv:
        raw = argv[argv.index("--experiment-ids") + 1]
        experiment_ids = [int(x) for x in raw.split(",") if x]

    addr = local_address()

    if mode == "notebook" and os.environ.get("DCT_NOTEBOOK_REAL") == "1":
        # hand off to a real jupyter server: pick a port, register the proxy
        # address BEFORE exec replaces this process, then bind jupyter to it
        with socket.socket() as s:
            s.bind((addr, 0))
            port = s.getsockname()[1]
        register_proxy(addr, port)
        os.execvp("jupyter", ["jupyter", "lab", "--no-browser",
                              f"--ip={addr}", f"--port={port}"])

    handler = type("Handler", (TaskHandler,), {
        "mode": mode, "experiment_ids": experiment_ids,
    })
    # bind only the interface registered with the master — /exec must not be
    # reachable except through the master's authenticated proxy path
    server = ThreadingHTTPServer((addr, 0), handler)
    port = server.server_address[1]
    print(f"[task] {mode} server on {addr}:{port}", flush=True)

    register_proxy(addr, port)

    # graceful preemption: the agent SIGTERMs on preempt/kill
    def stop(signum: int, frame: Any) -> None:
        threading.Thread(target=server.shutdown, daemon=True,
                         name="task-shutdown").start()

    signal.signal(signal.SIGTERM, stop)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
