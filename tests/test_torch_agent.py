"""The port's agent (``python -m determined_clone_tpu_torch.agent``), the
Python port of ``determined_clone_tpu/agent/src/agent.cc``.

Against the C++ agent on one master: the ``DCT_*`` task environment of a
command task, key for key. In this process against a master that is not
there (the agent's reports are then dropped): start, preempt (SIGTERM)
and kill, the card list (two 1-slot tasks on a 2-slot agent see disjoint
``CUDA_VISIBLE_DEVICES``; a zero-slot task sees none), the argv mapping
and the refusal that names a module the port lacks, slot detection and
its refusal without CUDA. With the ``container`` runtime against a live
master: a task survives the agent's SIGKILL and is re-adopted from the
state file by a restarted agent (the counterparts of
``tests/test_agent_reattach.py``).
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from determined_clone_tpu_torch.agent import agent as agent_mod
from determined_clone_tpu_torch.agent import (
    Agent,
    AgentConfig,
    detect_slots,
    gpu_generation,
    map_argv,
)
from determined_clone_tpu_torch.api.client import MasterSession
from determined_clone_tpu_torch.exec.launch import free_port
from tests.test_torch_master_client import build_binaries, start_master

REPO = Path(__file__).resolve().parent.parent
AGENT_BIN = REPO / "determined_clone_tpu" / "master" / "build" / "dct-agent"


def wait_for(predicate, timeout=60, interval=0.1, desc="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = predicate()
        if result:
            return result
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {desc}")


# -- in this process, no master --------------------------------------------

@pytest.fixture()
def lone_agent(tmp_path):
    """A 2-slot CPU agent whose master does not exist: its reports fail
    fast and are dropped, its tasks run."""
    agent = Agent(AgentConfig(master_port=free_port(), id="lone", slots=2,
                              device="cpu", work_dir=str(tmp_path / "work")))
    agent.setup()
    yield agent
    for task in list(agent.tasks.values()):
        agent.kill_task(task.allocation_id)
    wait_for(lambda: (agent.reap_tasks(), not agent.tasks)[1], 20,
             desc="tasks reaped")


def command(alloc_id, argv, slots=0, env=None):
    return {"type": "start", "allocation_id": alloc_id, "slots": slots,
            "rank": 0, "world_size": 1, "task_type": "command",
            "alloc_token": f"tok-{alloc_id}",
            "spec": {"argv": argv, "env": env or {}}}


def reap_exit(agent, alloc_id, timeout=30):
    wait_for(lambda: (agent.reap_tasks(), alloc_id not in agent.tasks)[1],
             timeout, desc=f"{alloc_id} to exit")
    return [e["exit_code"] for e in agent.pending_exits
            if e["allocation_id"] == alloc_id][-1]


def test_preempt_is_one_sigterm_and_kill_is_sigkill(lone_agent, tmp_path):
    marker = tmp_path / "term"
    trap = ("import signal, sys, time\n"
            "def stop(*a):\n"
            f"    open({str(marker)!r}, 'a').write('term\\n')\n"
            "    sys.exit(0)\n"
            "signal.signal(signal.SIGTERM, stop)\n"
            f"open({str(tmp_path / 'up')!r}, 'w').close()\n"
            "time.sleep(60)\n")
    lone_agent.start_task(command("a1", [sys.executable, "-c", trap]))
    wait_for(lambda: (tmp_path / "up").exists(), desc="task up")
    lone_agent.preempt_task("a1")
    lone_agent.preempt_task("a1")  # sent once
    assert reap_exit(lone_agent, "a1") == 0
    assert marker.read_text() == "term\n"

    lone_agent.start_task(command("a2", [sys.executable, "-c",
                                         "import time; time.sleep(60)"]))
    lone_agent.kill_task("a2")
    assert reap_exit(lone_agent, "a2") == 128 + signal.SIGKILL
    lone_agent.start_task(command("a3", [sys.executable, "-c",
                                         "import sys; sys.exit(3)"]))
    assert reap_exit(lone_agent, "a3") == 3
    lone_agent.start_task(command("a3", ["true"]))  # a duplicate start
    assert "a3" in lone_agent.tasks  # it ran again: a3 had exited


def test_disjoint_cuda_visible_devices(lone_agent, tmp_path):
    """Two 1-slot tasks on the 2-slot agent see different cards; a third
    finds none free and fails at once; a zero-slot task sees no card;
    reaped tasks give their cards back."""
    dump = ("import json, os, sys, time\n"
            "json.dump({k: v for k, v in os.environ.items()\n"
            "           if k.startswith(('DCT_', 'CUDA_'))},\n"
            "          open(sys.argv[1], 'w'))\n"
            "time.sleep(float(sys.argv[2]))\n")
    for i in range(2):
        lone_agent.start_task(command(
            f"t{i}", [sys.executable, "-c", dump, str(tmp_path / f"t{i}"),
                      "3"], slots=1))
    lone_agent.start_task(command(
        "t2", [sys.executable, "-c", dump, str(tmp_path / "t2"), "0"],
        slots=1))
    lone_agent.start_task(command(
        "z", [sys.executable, "-c", dump, str(tmp_path / "z"), "0"]))
    assert [reap_exit(lone_agent, a) for a in ("t2", "z", "t0", "t1")] == [
        80, 0, 0, 0]
    envs = {a: json.loads((tmp_path / a).read_text())
            for a in ("t0", "t1", "z")}
    assert {envs["t0"]["CUDA_VISIBLE_DEVICES"],
            envs["t1"]["CUDA_VISIBLE_DEVICES"]} == {"0", "1"}
    assert envs["z"]["CUDA_VISIBLE_DEVICES"] == ""
    assert all(e["DCT_DEVICE"] == "cpu" for e in envs.values())
    assert not (tmp_path / "t2").exists()
    assert "cannot start t2: 1 slots asked, 0 cards free" in (
        Path(lone_agent.config.work_dir) / "task-t2.log").read_text()
    assert lone_agent.free_cards == ["0", "1"]


def test_start_after_kill_in_one_reply_gets_the_cards(lone_agent,
                                                     monkeypatch):
    """The master frees the slots of an allocation it ends and may hand
    them to a start in the same heartbeat reply that kills the old task:
    the kill goes first and the start gets the killed task's cards."""
    lone_agent.start_task(command(
        "old", [sys.executable, "-c", "import time; time.sleep(60)"],
        slots=2))
    assert lone_agent.free_cards == []
    reply = json.dumps({"commands": [
        command("new", [sys.executable, "-c", "pass"], slots=2),
        {"type": "kill", "allocation_id": "old"}]}).encode()
    monkeypatch.setattr(
        lone_agent, "_http", lambda method, path, *a, **k: (
            (200, reply) if path.endswith("/heartbeat") else None))
    assert lone_agent.heartbeat()
    assert lone_agent.tasks["new"].cards == ["0", "1"]
    assert reap_exit(lone_agent, "new") == 0
    assert [e["exit_code"] for e in lone_agent.pending_exits
            if e["allocation_id"] == "old"] == [128 + signal.SIGKILL]


def test_cards_follow_the_agents_own_visible_devices(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,6")
    agent = Agent(AgentConfig(master_port=free_port(), slots=2,
                              device="cpu", work_dir=str(tmp_path)))
    agent.setup()
    assert agent.free_cards == ["4", "6"]
    assert agent._take_cards(1) == ["4"] and agent.free_cards == ["6"]
    agent._release_cards(["4"])
    assert agent.free_cards == ["4", "6"]


@pytest.mark.parametrize("argv,want", [
    (["python", "-m", "determined_clone_tpu.exec.gc_checkpoints"],
     [sys.executable, "-m", "determined_clone_tpu_torch.exec.gc_checkpoints"]),
    (["python3", "-m", "determined_clone_tpu.exec.trial", "m:C"],
     [sys.executable, "-m", "determined_clone_tpu_torch.exec.trial", "m:C"]),
    (["python", "-c", "print(1)"], ["python", "-c", "print(1)"]),
    (["echo", "determined_clone_tpu.exec.task"],
     ["echo", "determined_clone_tpu.exec.task"]),
    (["python", "-m", "determined_clone_tpu.exec.task", "tensorboard",
      "--experiment-ids", "1,2"],
     [sys.executable, "-m", "determined_clone_tpu_torch.exec.task",
      "tensorboard", "--experiment-ids", "1,2"]),
    (["python", "-m", "determined_clone_tpu.serving.fleet", "--fleet", "f"],
     [sys.executable, "-m", "determined_clone_tpu_torch.serving.fleet",
      "--fleet", "f"]),
])
def test_argv_mapping(argv, want):
    assert map_argv(argv) == want


@pytest.mark.parametrize("argv,module,item", [
    (["python", "-m", "determined_clone_tpu.storage.exec_cache"],
     "determined_clone_tpu_torch.storage.exec_cache", "item 6"),
    (["python3", "-m", "determined_clone_tpu.serving.warmstart", "--dir",
      "d"], "determined_clone_tpu_torch.serving.warmstart", "item 6"),
    (["python", "-m", "determined_clone_tpu.no_such_module"],
     "determined_clone_tpu_torch.no_such_module", "ROADMAP.md, Queue 1"),
])
def test_refusal_names_the_missing_module(lone_agent, argv, module, item):
    """A task whose module the port lacks exits 127 at once, its log naming
    the module and its ROADMAP item; nothing of the JAX package runs."""
    lone_agent.start_task(command("nt", argv))
    assert reap_exit(lone_agent, "nt") == agent_mod.EXIT_NOT_PORTED
    log = (Path(lone_agent.config.work_dir) / "task-nt.log").read_text()
    assert module in log and item in log and "not run" in log


def test_trial_argv_runs_the_port_harness():
    cmd = {"spec": {"entrypoint": "model_def:Trial"}}
    assert Agent.task_argv(cmd) == [
        sys.executable, "-m", "determined_clone_tpu_torch.exec.trial",
        "model_def:Trial"]
    assert Agent.task_argv({"spec": {}}) == []


@pytest.mark.parametrize("name,cap,want", [
    ("NVIDIA H100 80GB HBM3", (9, 0), "h100"),
    ("NVIDIA H100 PCIe", (9, 0), "h100"),
    ("NVIDIA A100-SXM4-80GB", (8, 0), "a100"),
    ("Tesla V100-SXM2-16GB", (7, 0), "v100"),
    ("NVIDIA GeForce RTX 4090", (8, 9), "sm89"),
])
def test_gpu_generation(name, cap, want):
    assert gpu_generation(name, cap) == want


def test_slot_detection_and_its_refusals(monkeypatch, tmp_path):
    monkeypatch.delenv("DCT_AGENT_SLOTS", raising=False)
    monkeypatch.delenv("DCT_AGENT_TOPOLOGY", raising=False)
    assert detect_slots("cpu") == (0, "")
    monkeypatch.setenv("DCT_AGENT_SLOTS", "3")
    monkeypatch.setenv("DCT_AGENT_TOPOLOGY", "h100-3")
    assert detect_slots("cuda") == (3, "h100-3")
    monkeypatch.delenv("DCT_AGENT_SLOTS")
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the refusals need a host without it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        detect_slots("cuda")
    with pytest.raises(RuntimeError, match="--device cpu"):
        Agent(AgentConfig(work_dir=str(tmp_path))).setup()
    env = {k: v for k, v in os.environ.items()
           if k not in ("DCT_AGENT_SLOTS", "DCT_AGENT_TOPOLOGY")}
    run = subprocess.run(
        [sys.executable, "-m", "determined_clone_tpu_torch.agent",
         "--master-port", str(free_port()), "--work-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=60)
    assert run.returncode != 0 and "--device cpu" in run.stderr
    run = subprocess.run(
        [sys.executable, "-m", "determined_clone_tpu_torch.agent",
         "--runtime", "docker"], capture_output=True, text=True, env=env,
        cwd=str(REPO), timeout=60)
    assert run.returncode == 2 and "docker" in run.stderr


def test_config_file_then_flags(tmp_path):
    """The C++ agent's config format and order: file values, then flags
    over them; an unknown key is refused."""
    cfg = tmp_path / "agent.yaml"
    cfg.write_text("# agent config\nmaster_host: 10.0.0.1\nmaster_port: 9000"
                   "\nid: 'from-file'\nslots: 4\nwork_dir: \"/data/#x\"\n"
                   "docker_image: img\n")
    args = agent_mod.build_parser().parse_args(
        ["--config", str(cfg), "--master-port", "9100", "--device", "cpu"])
    c = agent_mod.config_from_args(args)
    assert (c.master_host, c.master_port, c.id, c.slots, c.work_dir,
            c.device) == ("10.0.0.1", 9100, "from-file", 4, "/data/#x",
                          "cpu")
    (tmp_path / "bad.yaml").write_text("colour: blue\n")
    with pytest.raises(ValueError, match="unknown config key"):
        agent_mod.config_from_args(agent_mod.build_parser().parse_args(
            ["--config", str(tmp_path / "bad.yaml")]))
    (tmp_path / "sec.yaml").write_text("kube:\n  namespace: x\nid: y\n")
    assert agent_mod.parse_config_file(str(tmp_path / "sec.yaml")) == {
        "kube.namespace": "x", "id": "y"}


# -- against a live master ---------------------------------------------------

def start_port_agent(port, workdir, *extra, pool="default", env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "determined_clone_tpu_torch.agent",
         "--master-port", str(port), "--work-dir", str(workdir),
         "--resource-pool", pool, "--device", "cpu", *extra],
        cwd=str(REPO), stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": str(REPO), **(env or {})})


def test_task_env_matches_the_cpp_agent(tmp_path):
    """One command task through each agent (pools ``cpp`` and ``port``):
    the ``DCT_*`` environment is the same, key for key, but the ids and
    the token; the port's adds ``DCT_DEVICE`` and the card list."""
    if not build_binaries() or not AGENT_BIN.exists():
        pytest.skip("C++ master/agent build unavailable")
    proc, port = start_master(tmp_path)
    (tmp_path / "cpp").mkdir()
    agents = [subprocess.Popen(
        [str(AGENT_BIN), "--master-port", str(port), "--id", "cpp-agent",
         "--resource-pool", "cpp", "--work-dir", str(tmp_path / "cpp")],
        cwd=str(tmp_path / "cpp"), stdout=subprocess.DEVNULL,
        stderr=subprocess.STDOUT,
        env={**os.environ, "DCT_AGENT_SLOTS": "1"}),
        start_port_agent(port, tmp_path / "port", "--id", "port-agent",
                         "--slots", "1", pool="port")]
    try:
        session = MasterSession("127.0.0.1", port, timeout=10, retries=3)
        session.token = None
        wait_for(lambda: len(session.list_agents()) == 2, desc="agents")
        dump = ("import json, os, sys; json.dump(dict(os.environ), "
                "open(sys.argv[1], 'w'))")
        for pool in ("cpp", "port"):
            session.create_task(
                "command", name=f"env-{pool}", slots=1, resource_pool=pool,
                env={"EXTRA": "x"},
                cmd=[sys.executable, "-c", dump, str(tmp_path / pool
                                                     / "env.json")])
        wait_for(lambda: all(t["state"] == "COMPLETED"
                             for t in session.list_tasks()) and len(
            session.list_tasks()) == 2, desc="both tasks done")
        envs = {pool: json.loads((tmp_path / pool / "env.json").read_text())
                for pool in ("cpp", "port")}
    finally:
        for a in agents:
            a.kill()
            a.wait(timeout=10)
        proc.kill()
        proc.wait(timeout=10)
    ids = ("DCT_ALLOCATION_ID", "DCT_ALLOC_TOKEN", "DCT_AGENT_ID")

    def dct(env):
        return {k: v for k, v in env.items()
                if k.startswith("DCT_") and k not in ids
                and k not in ("DCT_AGENT_SLOTS", "DCT_DEVICE")}

    assert dct(envs["port"]) == dct(envs["cpp"])
    assert set(envs["port"]) >= set(ids) and envs["port"]["EXTRA"] == "x"
    assert envs["port"]["DCT_AGENT_ID"] == "port-agent"
    assert (envs["port"]["CUDA_VISIBLE_DEVICES"], envs["port"]["DCT_DEVICE"]
            ) == ("0", "cpu")


@pytest.fixture()
def cluster(tmp_path):
    if not build_binaries():
        pytest.skip("C++ master build unavailable")
    workdir = tmp_path / "agent-work"
    proc, port = start_master(tmp_path, "--agent-timeout", "30")

    def spawn_agent():
        return start_port_agent(port, workdir, "--id", "ra-agent",
                                "--runtime", "container", "--slots", "1")

    state = {"agent": spawn_agent()}
    session = MasterSession("127.0.0.1", port, timeout=10, retries=5)
    session.token = None
    wait_for(lambda: session.list_agents(), 60, desc="the agent")
    yield {"session": session, "tmp": tmp_path, "workdir": workdir,
           "spawn_agent": spawn_agent, "state": state}
    state["agent"].kill()
    state["agent"].wait(timeout=10)
    proc.kill()
    proc.wait(timeout=10)


def test_task_survives_agent_restart(cluster):
    session = cluster["session"]
    marker = cluster["tmp"] / "survived.txt"
    task = session.create_task(
        "command", name="survivor", slots=1,
        cmd=["python", "-c", "import time; time.sleep(6); "
                             f"open({str(marker)!r}, 'w').write('alive')"])
    tid = task["id"]
    wait_for(lambda: session.get_task(tid)["state"] == "RUNNING",
             desc="task running")
    agent = cluster["state"]["agent"]
    agent.kill()  # SIGKILL: the supervisor and the task live on
    agent.wait(timeout=10)
    assert not marker.exists(), "task finished before the agent was killed"
    state = json.loads((cluster["workdir"] / "agent-state.json").read_text())
    assert [t["allocation_id"] for t in state["tasks"]] == [tid]
    assert state["tasks"][0]["cards"] == ["0"]
    assert (cluster["workdir"] / "agent-state.json").stat().st_mode \
        & 0o777 == 0o600
    cluster["state"]["agent"] = cluster["spawn_agent"]()
    final = wait_for(
        lambda: (lambda t: t if t["state"] == "COMPLETED" else None)(
            session.get_task(tid)), 60, desc="completion after reattach")
    assert final["exit_code"] == 0
    assert marker.read_text() == "alive"


def test_exit_while_agent_down_is_reported_on_restart(cluster):
    session = cluster["session"]
    task = session.create_task(
        "command", name="fast-exit", slots=1,
        cmd=["python", "-c", "import sys, time; time.sleep(1.5); "
                             "sys.exit(4)"])
    tid = task["id"]
    wait_for(lambda: session.get_task(tid)["state"] == "RUNNING",
             desc="task running")
    agent = cluster["state"]["agent"]
    agent.kill()
    agent.wait(timeout=10)
    time.sleep(3)  # the task ends while no agent watches
    assert (cluster["workdir"] / f"task-{tid}.exit").read_text() == "4"
    cluster["state"]["agent"] = cluster["spawn_agent"]()
    final = wait_for(
        lambda: (lambda t: t if t["state"] in ("COMPLETED", "ERRORED")
                 else None)(session.get_task(tid)), 30,
        desc="exit reported after restart")
    # the supervisor outlived the agent and recorded the real exit code
    assert final["exit_code"] == 4


def test_deploy_local_starts_the_ports_agents(tmp_path):
    """``deploy local``: the C++ master and the port's agents (never
    ``dct-agent``), the state file, status and a clean teardown; without
    CUDA it refuses unless the CPU is asked for."""
    if not build_binaries():
        pytest.skip("C++ master build unavailable")
    from determined_clone_tpu_torch.deploy import local

    state_path = str(tmp_path / "cluster.json")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            local.cluster_up(base_dir=str(tmp_path), state_path=state_path)
    state = local.cluster_up(n_agents=2, slots_per_agent=1,
                             base_dir=str(tmp_path), state_path=state_path,
                             device="cpu", wait_sec=60)
    try:
        session = MasterSession("127.0.0.1", state["port"], timeout=10)
        session.token = None
        agents = session.list_agents()
        assert sorted(a["id"] for a in agents) == ["local-agent-0",
                                                   "local-agent-1"]
        assert all(a["slots"] == 1 for a in agents)
        assert state["master_build_s"] == 0.0  # built by build_binaries
        for a in state["agents"]:
            cmdline = Path(f"/proc/{a['pid']}/cmdline").read_bytes()
            assert b"determined_clone_tpu_torch.agent" in cmdline
        status = local.cluster_status(state_path=state_path)
        assert status["alive"] and status["agents_alive"] == 2
        with pytest.raises(RuntimeError, match="already up"):
            local.cluster_up(base_dir=str(tmp_path), state_path=state_path,
                             device="cpu", slots_per_agent=1)
    finally:
        out = local.cluster_down(state_path=state_path)
    assert out["stopped"] == 3
    assert local.cluster_status(state_path=state_path)["alive"] is False
    assert not any(local._alive(a["pid"]) for a in state["agents"])


@pytest.mark.parametrize("sweep", [False, True])
def test_gc_task_deletes_and_sweeps_like_jax(tmp_path, monkeypatch, sweep):
    """``exec/gc_checkpoints.py`` against the JAX task on two copies of one
    store: the listed checkpoints deleted (a missing one is no failure),
    and with ``DCT_GC_SWEEP_UNCOMMITTED=1`` the uncommitted leftovers
    older than the age floor swept, the ``cas`` namespace never."""
    from determined_clone_tpu.exec import gc_checkpoints as jgc
    from determined_clone_tpu_torch.exec import gc_checkpoints as tgc

    def store(root):
        for sid, committed in (("a", True), ("b", True), ("c", False),
                               ("keep", True), ("cas", False)):
            d = root / sid
            d.mkdir(parents=True)
            (d / "state.bin").write_bytes(b"x" * 8)
            if committed:
                (d / "COMMIT").write_text("{}")
        return root

    left = {}
    for name, mod in (("jax", jgc), ("port", tgc)):
        root = store(tmp_path / name)
        monkeypatch.setenv("DCT_GC_STORAGE", json.dumps(
            {"type": "shared_fs", "host_path": str(root)}))
        monkeypatch.setenv("DCT_GC_UUIDS", "a,b,gone")
        monkeypatch.setenv("DCT_GC_UNCOMMITTED_AGE_S", "0")
        if sweep:
            monkeypatch.setenv("DCT_GC_SWEEP_UNCOMMITTED", "1")
        else:
            monkeypatch.delenv("DCT_GC_SWEEP_UNCOMMITTED", raising=False)
        assert mod.main() == 0
        left[name] = sorted(p.name for p in root.iterdir())
    assert left["port"] == left["jax"] == (
        ["cas", "keep"] if sweep else ["c", "cas", "keep"])
    monkeypatch.delenv("DCT_GC_STORAGE")
    assert tgc.main() == 0  # nothing to do
