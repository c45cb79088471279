"""The port's node daemon: a Python port of the C++ agent
(``determined_clone_tpu/agent/src/agent.cc``) that runs tasks on CUDA
slots.

It speaks the C++ agent's REST protocol to the same C++ master: register
and heartbeat (``/api/v1/agents/register``, ``/agents/{id}/heartbeat``;
exits ride every heartbeat until acknowledged), the ``start``, ``preempt``
(SIGTERM beside the master's flag) and ``kill`` commands, the context
download with the allocation token, the ``DCT_*`` task environment,
``task_event`` reports and log shipping on exit. What differs:

- **Slots are CUDA devices.** ``DCT_AGENT_SLOTS`` / ``DCT_AGENT_TOPOLOGY``
  override everything (the C++ agent's test trick); otherwise the slots
  are ``torch.cuda.device_count()`` and the topology ``<gen>-<count>``
  with the generation named from the device (``h100-1``). Without CUDA
  the agent raises, unless it was started with ``--device cpu`` (tests)
  or the override.
- **Each task gets its own cards.** ``CUDA_VISIBLE_DEVICES`` is set from
  a free list of the agent's card indices (the agent's own
  ``CUDA_VISIBLE_DEVICES`` when it has one), so two trials on one host
  never share a card; a zero-slot task sees none. A TPU host runs one
  process on every chip, so the C++ agent keeps no such list.
- **Tasks run the port.** A trial runs ``python -m
  determined_clone_tpu_torch.exec.trial <entrypoint>``; the master's argv
  ``python -m determined_clone_tpu.<mod> ...`` (GC, the NTSC task
  server ``exec.task``, the fleet's ``serving.fleet``) runs
  ``determined_clone_tpu_torch.<mod>`` under this interpreter. Where the
  port has no such entry point yet, the task exits at once with code 127
  and its shipped log names the missing module and its ``ROADMAP.md``
  item; it never falls back to the JAX module.
- **Runtimes.** ``process`` (the task dies with the agent:
  ``PR_SET_PDEATHSIG``) and ``container`` (a detached supervisor,
  ``supervisor.py``, records the exit code; a restarted agent re-adopts
  surviving tasks from its state file, matching ``DCT_ALLOCATION_ID`` in
  ``/proc/<pid>/environ``). The ``docker`` runtime is not ported.

Started as ``python -m determined_clone_tpu_torch.agent`` with the C++
agent's flags (``--master-host``, ``--master-port``, ``--id``,
``--resource-pool``, ``--slots``, ``--topology``, ``--work-dir``,
``--runtime``, ``--config``) and ``--device cpu`` for tests.
"""
from __future__ import annotations

import argparse
import base64
import dataclasses
import importlib.util
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

SUPERVISOR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "supervisor.py")
RUNTIMES = ("process", "container")
# JAX modules the port has no entry point for, by their ROADMAP.md item
# (any other missing module names Queue 1 as a whole)
NOT_PORTED = {
    f"determined_clone_tpu_torch.{mod}": (
        "ROADMAP.md, Queue 1, item 6: XLA executables (storage/"
        "exec_cache.py and serving/warmstart.py)")
    for mod in ("storage.exec_cache", "serving.warmstart")
}
EXIT_NOT_PORTED = 127


@dataclasses.dataclass
class AgentConfig:
    master_host: str = "127.0.0.1"
    master_port: int = 8080
    id: str = ""
    resource_pool: str = "default"
    slots: int = -1            # -1 = detect
    topology: str = ""
    heartbeat_sec: float = 1.0
    work_dir: str = "."
    runtime: str = "process"
    device: str = "cuda"


@dataclasses.dataclass
class RunningTask:
    pid: int                   # direct child (process) or supervisor
    allocation_id: str
    log_path: str
    cards: List[str]
    task_pid: int = 0          # the task itself (container runtime)
    proc: Optional[subprocess.Popen] = None
    preempt_sent: bool = False
    kill_sent: bool = False
    adopted: bool = False      # reattached: not our child
    dead_polls: int = 0
    alloc_token: str = ""


# -- slots --------------------------------------------------------------------

def gpu_generation(name: str, capability: Tuple[int, int] = (0, 0)) -> str:
    """The generation word of a CUDA device name ("NVIDIA H100 80GB HBM3"
    → "h100"), else ``sm<major><minor>``."""
    for token in name.replace("-", " ").split():
        if re.fullmatch(r"[A-Za-z]{1,3}\d{1,4}[A-Za-z]?", token) and \
                token.upper() not in ("PCIE", "SXM", "SXM5", "NVL"):
            return token.lower()
    return f"sm{capability[0]}{capability[1]}"


def detect_slots(device: str = "cuda") -> Tuple[int, str]:
    """(slots, topology): the ``DCT_AGENT_SLOTS`` / ``DCT_AGENT_TOPOLOGY``
    override, else the CUDA devices; with ``device="cpu"`` and no
    override, 0 slots. Raises when CUDA is absent and neither is given."""
    env = os.environ.get("DCT_AGENT_SLOTS")
    if env is not None:
        return int(env), os.environ.get("DCT_AGENT_TOPOLOGY", "")
    if device == "cpu":
        return 0, ""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the agent detects its slots from the "
            "CUDA devices (start it with --device cpu to run tasks on the "
            "CPU, or set DCT_AGENT_SLOTS)")
    count = torch.cuda.device_count()
    gen = gpu_generation(torch.cuda.get_device_name(0),
                         torch.cuda.get_device_capability(0))
    return count, f"{gen}-{count}"


def parse_config_file(path: str) -> Dict[str, str]:
    """The C++ binaries' config-file format (``master/src/config_file.h``):
    ``key: value`` lines, one indented section level or dotted keys, ``#``
    comments outside quotes, matching quotes stripped."""
    out: Dict[str, str] = {}
    section = ""
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line, quote = raw.rstrip("\n"), ""
            for i, c in enumerate(line):
                if quote:
                    quote = "" if c == quote else quote
                elif c in "\"'":
                    quote = c
                elif c == "#":
                    line = line[:i]
                    break
            if not line.strip():
                continue
            indented = line[0] in " \t"
            if ":" not in line:
                raise ValueError(f"{path}:{lineno}: expected 'key: value'")
            key, _, value = line.partition(":")
            key, value = key.strip(), value.strip(" \t\r")
            quoted = (len(value) >= 2 and value[0] in "\"'"
                      and value[-1] == value[0])
            if quoted:
                value = value[1:-1]
            if not value and not quoted and not indented:
                section = key
                continue
            if not indented:
                section = ""
            out[f"{section}.{key}" if indented and section else key] = value
    return out


# -- /proc identity ------------------------------------------------------------

def pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
        return True
    except PermissionError:
        return True
    except OSError:
        return False


def proc_matches_task(pid: int, allocation_id: str) -> bool:
    """Pid-reuse-proof identity: the exec'd task carries
    ``DCT_ALLOCATION_ID`` in ``/proc/<pid>/environ`` (readable only for
    processes of the agent's own user)."""
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            entries = f.read().split(b"\0")
    except OSError:
        return False
    return f"DCT_ALLOCATION_ID={allocation_id}".encode() in entries


def _die_with_parent() -> None:
    """In the task's process before exec: SIGKILL when the agent dies."""
    import ctypes

    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    if os.getppid() == 1:  # the agent died before the prctl
        os._exit(83)


# -- the agent ----------------------------------------------------------------

class Agent:
    def __init__(self, config: AgentConfig) -> None:
        if config.runtime not in RUNTIMES:
            raise ValueError(
                f"unknown runtime {config.runtime!r} (the port's agent runs "
                f"{'|'.join(RUNTIMES)}; docker is ROADMAP.md, Queue 1, item "
                f"3.4)")
        self.config = config
        self.tasks: Dict[str, RunningTask] = {}
        self.pending_exits: List[Dict[str, Any]] = []
        self.cards: List[str] = []
        self.free_cards: List[str] = []

    # -- setup ----------------------------------------------------------------

    def setup(self) -> None:
        c = self.config
        if not c.id:
            c.id = f"{socket.gethostname()}-{os.getpid()}"
        if c.device == "cuda" and "DCT_AGENT_SLOTS" not in os.environ:
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CUDA is not available: start the agent with --device "
                    "cpu to run tasks on the CPU")
        if c.slots < 0:
            c.slots, topology = detect_slots(c.device)
            c.topology = c.topology or topology
        c.work_dir = os.path.abspath(c.work_dir)
        os.makedirs(c.work_dir, exist_ok=True)
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        self.cards = ([d.strip() for d in visible.split(",") if d.strip()]
                      if visible else [])
        if len(self.cards) < c.slots:
            self.cards = [str(i) for i in range(c.slots)]
        self.cards = self.cards[:c.slots]
        self.free_cards = list(self.cards)
        print(f"[agent] id={c.id} slots={c.slots} topology={c.topology} "
              f"runtime={c.runtime} device={c.device} cards="
              f"{','.join(self.cards)}", file=sys.stderr, flush=True)

    def run(self) -> int:
        self.setup()
        # reattach (container runtime): adopt surviving tasks BEFORE the
        # first heartbeat so the master never sees them absent
        if self.config.runtime != "process":
            self.reattach_tasks()
        backoff = 0.5
        while not self.register():
            print(f"[agent] master unreachable; retrying in {backoff:.1f}s",
                  file=sys.stderr, flush=True)
            time.sleep(backoff)
            backoff = min(backoff * 2, 15.0)
        while True:
            self.reap_tasks()
            if not self.heartbeat():
                # lost master: back off, re-register (reservations survive
                # on the master until its agent timeout)
                time.sleep(1.0)
                self.register()
                continue
            time.sleep(self.config.heartbeat_sec)

    # -- HTTP -----------------------------------------------------------------

    def _http(self, method: str, path: str, body: Optional[Any] = None,
              token: str = "", timeout: float = 10.0
              ) -> Optional[Tuple[int, bytes]]:
        url = (f"http://{self.config.master_host}:{self.config.master_port}"
               f"{path}")
        headers = {"Content-Type": "application/json"}
        if token:
            headers["Authorization"] = f"Bearer {token}"
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
        except (urllib.error.URLError, OSError):
            return None

    def register(self) -> bool:
        c = self.config
        resp = self._http("POST", "/api/v1/agents/register", {
            "id": c.id, "slots": c.slots, "topology": c.topology,
            "resource_pool": c.resource_pool,
            "address": socket.gethostname()})
        return resp is not None and resp[0] == 200

    def heartbeat(self) -> bool:
        n_exits = len(self.pending_exits)
        resp = self._http(
            "POST", f"/api/v1/agents/{self.config.id}/heartbeat",
            {"running": list(self.tasks),
             # at-least-once exit reporting: exits ride every heartbeat
             # until one succeeds (the master side is idempotent)
             "exited": self.pending_exits[:n_exits]})
        if resp is None or resp[0] != 200:
            return False
        del self.pending_exits[:n_exits]
        commands = json.loads(resp[1] or b"{}").get("commands", [])
        # kills first: the master frees the slots of an allocation it ends
        # and may hand them to a start in this same reply
        for cmd in sorted(commands, key=lambda c: c.get("type") == "start"):
            kind = cmd.get("type")
            if kind == "start":
                self.start_task(cmd)
            elif kind == "preempt":
                self.preempt_task(cmd.get("allocation_id", ""))
            elif kind == "kill":
                self.kill_task(cmd.get("allocation_id", ""))
        return True

    def send_event(self, allocation_id: str, event: str, exit_code: int,
                   error: str) -> None:
        self._http("POST", f"/api/v1/agents/{self.config.id}/task_event",
                   {"allocation_id": allocation_id, "event": event,
                    "exit_code": exit_code, "error": error})

    def ship_logs(self, task: RunningTask) -> None:
        try:
            with open(task.log_path, errors="replace") as f:
                lines = [line.rstrip("\n") for _, line in zip(range(5000), f)]
        except OSError:
            return
        # under --auth-required the allocation token authorises the post
        self._http("POST", f"/api/v1/allocations/{task.allocation_id}/logs",
                   {"logs": lines}, token=task.alloc_token)

    # -- starting tasks -------------------------------------------------------

    def prepare_context(self, cmd: Dict[str, Any], alloc_id: str) -> str:
        """Write the experiment's model-def directory into the task's run
        dir; returns that dir, or "" for the agent's work dir."""
        trial = cmd.get("trial")
        if not trial:
            return ""
        resp = self._http(
            "GET", f"/api/v1/experiments/{int(trial['experiment_id'])}"
                   f"/context", token=cmd.get("alloc_token", ""),
            timeout=30.0)
        if resp is None or resp[0] != 200:
            return ""
        try:
            files = json.loads(resp[1]).get("context") or []
        except ValueError:
            return ""
        if not files:
            return ""
        run_dir = os.path.join(self.config.work_dir, f"run-{alloc_id}")
        os.makedirs(run_dir, exist_ok=True)
        for f in files:
            rel = f.get("path", "")
            if not rel or rel.startswith("/") or ".." in rel:
                continue  # the master validates too
            full = os.path.join(run_dir, rel)
            os.makedirs(os.path.dirname(full), exist_ok=True)
            with open(full, "wb") as out:
                out.write(base64.b64decode(f.get("content_b64", "")))
        return run_dir

    def task_env(self, cmd: Dict[str, Any], alloc_id: str,
                 cards: List[str]) -> Dict[str, str]:
        """The ``DCT_*`` environment of the C++ agent's ``task_env``, over
        the agent's own, plus the task's ``CUDA_VISIBLE_DEVICES`` (and
        ``DCT_DEVICE=cpu`` under ``--device cpu``)."""
        c = self.config
        env = dict(os.environ)
        env.update({
            "DCT_MASTER_HOST": c.master_host,
            "DCT_MASTER_PORT": str(c.master_port),
            "DCT_ALLOCATION_ID": alloc_id,
            "DCT_ALLOC_TOKEN": str(cmd.get("alloc_token", "")),
            "DCT_AGENT_ID": c.id,
            "DCT_SLOTS": str(int(cmd.get("slots", 0))),
            "DCT_RANK": str(int(cmd.get("rank", 0))),
            "DCT_WORLD_SIZE": str(int(cmd.get("world_size", 0))),
            "DCT_N_SLICES": str(int(cmd.get("n_slices", 1) or 1)),
            "DCT_TASK_TYPE": str(cmd.get("task_type", "")),
        })
        trial = cmd.get("trial")
        if trial:
            env.update({
                "DCT_TRIAL_ID": str(int(trial["id"])),
                "DCT_EXPERIMENT_ID": str(int(trial["experiment_id"])),
                "DCT_HPARAMS": json.dumps(trial.get("hparams")),
                "DCT_TARGET_UNITS": str(int(trial.get("target_units", 0))),
                "DCT_LATEST_CHECKPOINT": str(
                    trial.get("latest_checkpoint") or ""),
                "DCT_EXPERIMENT_CONFIG": json.dumps(cmd.get("config")),
            })
        spec_env = (cmd.get("spec") or {}).get("env")
        if isinstance(spec_env, dict):
            env.update({k: str(v) for k, v in spec_env.items()})
        env["CUDA_VISIBLE_DEVICES"] = ",".join(cards)
        if c.device == "cpu":
            env["DCT_DEVICE"] = "cpu"
        return env

    @staticmethod
    def task_argv(cmd: Dict[str, Any]) -> List[str]:
        """The task's argv: the master's ``spec.argv`` with the JAX
        package's modules mapped to the port's, or the trial harness."""
        spec = cmd.get("spec") or {}
        argv = [str(a) for a in spec.get("argv") or []]
        if argv:
            return map_argv(argv)
        entrypoint = spec.get("entrypoint") or ""
        if entrypoint:
            return [sys.executable, "-m",
                    "determined_clone_tpu_torch.exec.trial", entrypoint]
        return []

    def _take_cards(self, n: int) -> List[str]:
        if n > len(self.free_cards):
            raise RuntimeError(
                f"{n} slots asked, {len(self.free_cards)} cards free")
        taken, self.free_cards = self.free_cards[:n], self.free_cards[n:]
        return taken

    def _release_cards(self, cards: List[str]) -> None:
        self.free_cards = [c for c in self.cards
                           if c in self.free_cards or c in cards]

    def start_task(self, cmd: Dict[str, Any]) -> None:
        alloc_id = cmd.get("allocation_id", "")
        if not alloc_id or alloc_id in self.tasks:
            return  # duplicate start
        c = self.config
        log_path = os.path.join(c.work_dir, f"task-{alloc_id}.log")
        if int(cmd.get("slots", 0)) > len(self.free_cards):
            self._reap_killed()
        try:
            cards = self._take_cards(int(cmd.get("slots", 0)))
        except RuntimeError as e:
            with open(log_path, "a") as log:
                log.write(f"[agent] cannot start {alloc_id}: {e}\n")
            self.send_event(alloc_id, "running", 0, "")
            self._finish(alloc_id, RunningTask(0, alloc_id, log_path, [],
                                               alloc_token=cmd.get(
                                                   "alloc_token", "")), 80)
            return
        run_dir = self.prepare_context(cmd, alloc_id)
        env = self.task_env(cmd, alloc_id, cards)
        argv = self.task_argv(cmd)
        cwd = run_dir or c.work_dir
        if not argv:
            argv = [sys.executable, "-c",
                    f"import sys; sys.exit('no argv/entrypoint for "
                    f"{alloc_id}')"]
        task = RunningTask(0, alloc_id, log_path, cards,
                           alloc_token=str(cmd.get("alloc_token", "")))
        if c.runtime == "container":
            exit_file = self.exit_file(alloc_id)
            try:
                os.unlink(exit_file)
            except FileNotFoundError:
                pass
            proc = subprocess.Popen(
                [sys.executable, SUPERVISOR, exit_file, log_path, cwd, "--",
                 *argv], env=env, cwd=cwd, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, start_new_session=True)
            task.task_pid = int(proc.stdout.readline() or 0)
            proc.stdout.close()
        else:
            with open(log_path, "ab") as log:
                proc = subprocess.Popen(
                    argv, env=env, cwd=cwd, stdout=log,
                    stderr=subprocess.STDOUT, preexec_fn=_die_with_parent)
        task.pid, task.proc = proc.pid, proc
        self.tasks[alloc_id] = task
        self.persist_state()
        self.send_event(alloc_id, "running", 0, "")
        print(f"[agent] started {alloc_id} pid={proc.pid} "
              f"task={task.task_pid or proc.pid} cards={','.join(cards)} "
              f"argv={' '.join(argv[:4])}", file=sys.stderr, flush=True)

    def preempt_task(self, alloc_id: str) -> None:
        """Cooperative: the harness polls the master's flag; the SIGTERM
        beside it reaches the task (not the supervisor, which must live to
        record the exit code)."""
        task = self.tasks.get(alloc_id)
        if task is None or task.preempt_sent:
            return
        target = task.task_pid or task.pid
        if target > 0:
            try:
                os.kill(target, signal.SIGTERM)
            except OSError:
                pass
        task.preempt_sent = True

    def kill_task(self, alloc_id: str) -> None:
        task = self.tasks.get(alloc_id)
        if task is None:
            return
        target = task.task_pid or task.pid
        if target > 0:
            try:
                os.kill(target, signal.SIGKILL)
            except OSError:
                pass
        task.kill_sent = True

    def _reap_killed(self, timeout: float = 10.0) -> None:
        """Wait for the tasks this agent has killed and give their cards
        back: their slots are already free on the master."""
        for task in self.tasks.values():
            if task.kill_sent and task.proc is not None:
                try:
                    task.proc.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    pass
        self.reap_tasks()

    # -- running tasks --------------------------------------------------------

    def exit_file(self, alloc_id: str) -> str:
        return os.path.join(self.config.work_dir, f"task-{alloc_id}.exit")

    def state_file(self) -> str:
        return os.path.join(self.config.work_dir, "agent-state.json")

    def _read_exit_file(self, alloc_id: str) -> Optional[int]:
        try:
            with open(self.exit_file(alloc_id)) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def _finish(self, alloc_id: str, task: RunningTask,
                exit_code: int) -> None:
        self.ship_logs(task)
        error = "task failed" if exit_code else ""
        # fast path now; the heartbeat carries it again until acked
        self.send_event(alloc_id, "exited", exit_code, error)
        self.pending_exits.append({"allocation_id": alloc_id,
                                   "exit_code": exit_code, "error": error})
        self._release_cards(task.cards)
        print(f"[agent] task {alloc_id} exited {exit_code}", file=sys.stderr,
              flush=True)

    def reap_tasks(self) -> None:
        changed = False
        for alloc_id, task in list(self.tasks.items()):
            if task.adopted:
                # not our child: poll the TASK's liveness with the identity
                # check (a bare kill(pid, 0) would follow a reused pid)
                if (pid_alive(task.task_pid)
                        and proc_matches_task(task.task_pid, alloc_id)):
                    task.dead_polls = 0
                    continue
                code = self._read_exit_file(alloc_id)
                if code is None:
                    # the supervisor writes the exit file just before it
                    # exits: a grace window before assuming a crash
                    task.dead_polls += 1
                    if task.dead_polls < 20:
                        continue
                    code = 1
            else:
                rc = task.proc.poll()
                if rc is None:
                    continue
                # process: the child's status; container: the supervisor
                # exits with the task's code
                code = rc if rc >= 0 else 128 - rc
            del self.tasks[alloc_id]
            self._finish(alloc_id, task, code)
            changed = True
        if changed:
            self.persist_state()

    def persist_state(self) -> None:
        """The container runtime's state file (owner-only: it holds the
        allocation tokens), written through a rename."""
        if self.config.runtime == "process":
            return  # fate-shared: nothing survives the agent
        state = {"tasks": [
            {"allocation_id": aid, "supervisor_pid": t.pid,
             "task_pid": t.task_pid, "log_path": t.log_path,
             "alloc_token": t.alloc_token, "cards": t.cards}
            for aid, t in self.tasks.items()]}
        tmp = self.state_file() + ".tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self.state_file())

    def reattach_tasks(self) -> None:
        """Re-adopt tasks from the state file whose processes still run;
        report exits for those that finished while the agent was down
        (≈ containers/manager.go:76)."""
        try:
            with open(self.state_file()) as f:
                state = json.load(f)
        except (OSError, ValueError):
            return
        for t in state.get("tasks", []):
            alloc_id = t["allocation_id"]
            cards = [c for c in t.get("cards", []) if c in self.free_cards]
            task = RunningTask(int(t.get("supervisor_pid", 0)), alloc_id,
                               t.get("log_path", ""), cards,
                               task_pid=int(t.get("task_pid", 0)),
                               adopted=True,
                               alloc_token=t.get("alloc_token", ""))
            if (pid_alive(task.task_pid)
                    and proc_matches_task(task.task_pid, alloc_id)):
                self.free_cards = [c for c in self.free_cards
                                   if c not in cards]
                self.tasks[alloc_id] = task
                print(f"[agent] reattached {alloc_id} task={task.task_pid}",
                      file=sys.stderr, flush=True)
                continue
            # finished (or lost) while the agent was down: the supervisor's
            # exit file has the code; without it the outcome is unknown
            code = self._read_exit_file(alloc_id)
            error = ("task lost across agent restart" if code is None
                     else ("task failed" if code else ""))
            self.ship_logs(task)
            self.pending_exits.append({"allocation_id": alloc_id,
                                       "exit_code": 1 if code is None
                                       else code, "error": error})
            print(f"[agent] task {alloc_id} finished while the agent was "
                  f"down: exit {code}", file=sys.stderr, flush=True)
        self.persist_state()


def map_argv(argv: List[str]) -> List[str]:
    """``python -m determined_clone_tpu.<mod> ...`` → this interpreter
    running ``determined_clone_tpu_torch.<mod>``; a module the port lacks
    becomes a command that names it and its ``ROADMAP.md`` item and exits
    127. Any other argv runs as given."""
    if (len(argv) >= 3 and os.path.basename(argv[0]).startswith("python")
            and argv[1] == "-m"
            and argv[2].startswith("determined_clone_tpu.")):
        module = "determined_clone_tpu_torch." + argv[2].split(".", 1)[1]
        missing = NOT_PORTED.get(module)
        if missing is None and importlib.util.find_spec(module) is None:
            missing = "ROADMAP.md, Queue 1"
        if missing is not None:
            msg = (f"[agent] {argv[2]} has no port: {module} is not ported "
                   f"yet ({missing}); the JAX module is not run")
            return [sys.executable, "-c",
                    f"import sys; print({msg!r}, flush=True); "
                    f"sys.exit({EXIT_NOT_PORTED})"]
        return [sys.executable, "-m", module, *argv[3:]]
    return argv


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m determined_clone_tpu_torch.agent",
        description="The port's agent: runs the master's tasks on CUDA "
                    "slots.")
    p.add_argument("--config", default=None,
                   help="agent config file (the C++ agent's format)")
    p.add_argument("--master-host", default=None)
    p.add_argument("--master-port", type=int, default=None)
    p.add_argument("--id", default=None)
    p.add_argument("--resource-pool", default=None)
    p.add_argument("--slots", type=int, default=None)
    p.add_argument("--topology", default=None)
    p.add_argument("--work-dir", default=None)
    p.add_argument("--runtime", default=None,
                   help="process | container (docker: not ported)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cpu runs tasks on the CPU (tests); the default "
                        "needs CUDA")
    return p


_FILE_KEYS = {"master_host": str, "master_port": int, "id": str,
              "resource_pool": str, "slots": int, "topology": str,
              "work_dir": str, "runtime": str}


def config_from_args(args: argparse.Namespace) -> AgentConfig:
    """File values first, flags over them (the C++ agent's order)."""
    config = AgentConfig(device=args.device)
    if args.config:
        for key, value in parse_config_file(args.config).items():
            if key == "docker_image":
                continue  # the docker runtime is not ported
            if key not in _FILE_KEYS:
                raise ValueError(f"unknown config key {key!r} in "
                                 f"{args.config}")
            setattr(config, key, _FILE_KEYS[key](value))
    for key in _FILE_KEYS:
        value = getattr(args, key)
        if value is not None:
            setattr(config, key, value)
    return config


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        agent = Agent(config_from_args(args))
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return agent.run()
