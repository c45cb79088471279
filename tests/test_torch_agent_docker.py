"""The port's ``docker`` runtime (``agent/agent.py``) held against the C++
agent's (``determined_clone_tpu/agent/src/docker.h`` ``docker_run_argv``,
``agent.cc`` ``start_detached``/``kill_task``/``reattach_tasks``).

The argv: the C++ function itself, compiled here with g++ into a small
program, lays out ``docker run`` for the same seeded inputs; the port's argv
must be the same list, element for element, with the one designed
difference in the device flags (the task's cards as ``--gpus
"device=..."`` where the TPU agent passes ``--device /dev/accel*``).

The runtime: neither this machine nor the chip machine has ``docker``, so
a fake ``docker`` on ``PATH`` stands in. It records each argv, runs the
command after the image with only the ``-e`` variables (and ``PATH``),
forwards SIGTERM as the real CLI's signal proxy does, and on ``docker
kill <name>`` SIGKILLs that container's command. Through it an agent in
this process runs a task, preempts one, kills one (``docker kill``), and
a second agent on the same work dir re-adopts a running task from the
state file and reports the exit of one that ended while it was down.
"""
import json
import os
import random
import signal
import stat
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from determined_clone_tpu_torch.agent import Agent, AgentConfig
from determined_clone_tpu_torch.agent import agent as agent_mod
from determined_clone_tpu_torch.exec.launch import free_port

REPO = Path(__file__).resolve().parent.parent
DOCKER_H = REPO / "determined_clone_tpu" / "agent" / "src"

PROBE_SRC = r"""
#include "docker.h"
#include <cstdlib>
#include <iostream>
// argv: alloc image work cwd n_env (k v)... n_dev dev... argv...
int main(int argc, char** argv) {
  int i = 1;
  std::string alloc = argv[i++], image = argv[i++], work = argv[i++],
              cwd = argv[i++];
  std::map<std::string, std::string> env;
  for (int n = std::atoi(argv[i++]); n > 0; --n, i += 2)
    env[argv[i]] = argv[i + 1];
  std::vector<std::string> devices;
  for (int n = std::atoi(argv[i++]); n > 0; --n) devices.push_back(argv[i++]);
  std::vector<std::string> task(argv + i, argv + argc);
  for (const auto& a :
       dct::docker_run_argv(alloc, image, work, cwd, env, devices, task))
    std::cout << a << '\0';
  return 0;
}
"""


@pytest.fixture(scope="module")
def cpp_argv(tmp_path_factory):
    d = tmp_path_factory.mktemp("docker_h")
    (d / "probe.cc").write_text(PROBE_SRC)
    subprocess.run(["g++", "-std=c++17", "-O0", "-I", str(DOCKER_H),
                    str(d / "probe.cc"), "-o", str(d / "probe")],
                   check=True, timeout=120)

    def build(alloc, image, work, cwd, env, devices, argv):
        flat = [alloc, image, work, cwd, str(len(env))]
        for k in sorted(env):
            flat += [k, env[k]]
        flat += [str(len(devices)), *devices, *argv]
        out = subprocess.run([str(d / "probe"), *flat], check=True,
                             capture_output=True, timeout=30).stdout
        return out.decode().split("\0")[:-1]

    return build


def seeded_case(seed):
    rng = random.Random(seed)
    alloc = f"{rng.randrange(1 << 32):08x}.{rng.randrange(4)}"
    env = {f"DCT_K{i}": rng.choice(["", "a b", "x=y", str(rng.random())])
           for i in range(rng.randrange(1, 6))}
    env["CUDA_VISIBLE_DEVICES"] = "0"
    n_cards = rng.randrange(0, 4)
    cards = sorted(rng.sample(range(8), n_cards))
    argv = ["python", "-m", "determined_clone_tpu_torch.exec.trial",
            f"model_def:T{seed}"][:rng.randrange(1, 5)]
    return (alloc, f"img:{seed}", f"/w/{seed}", f"/w/{seed}/run-{alloc}",
            env, [str(c) for c in cards], argv)


@pytest.mark.parametrize("seed", range(6))
def test_argv_is_the_cpp_argvs(seed, cpp_argv):
    alloc, image, work, cwd, env, cards, argv = seeded_case(seed)
    port = agent_mod.docker_run_argv(alloc, image, work, cwd, env, cards,
                                     argv)
    # no device: the two lists are the same
    assert agent_mod.docker_run_argv(alloc, image, work, cwd, env, [],
                                     argv) == cpp_argv(
        alloc, image, work, cwd, env, [], argv)
    # with cards: the C++ agent's --device pairs stand where the port's
    # one --gpus pair stands
    cpp = cpp_argv(alloc, image, work, cwd, env,
                      ["/dev/accel0", "/dev/accel1"], argv)
    head = cpp.index("--device")
    want = cpp[:head] + (
        ["--gpus", f'"device={",".join(cards)}"'] if cards else []) + \
        cpp[head + 4:]
    assert port == want
    assert port[:5] == ["docker", "run", "--rm", "--name",
                        f"dct-task-{alloc}"]


FAKE_DOCKER = textwrap.dedent("""\
    import json, os, signal, subprocess, sys
    args = sys.argv[1:]
    state = os.environ["FAKE_DOCKER_DIR"]
    with open(os.path.join(state, "calls.jsonl"), "a") as f:
        f.write(json.dumps(args) + "\\n")
    if args[0] == "kill":
        try:
            with open(os.path.join(state, args[1] + ".pid")) as f:
                pid = int(f.read())
        except OSError:
            sys.exit("Error: No such container: " + args[1])
        os.kill(pid, signal.SIGKILL)
        print(args[1])
        sys.exit(0)
    assert args[0] == "run", args
    i, name, cwd = 1, None, None
    env = {"PATH": os.environ["PATH"]}
    while args[i].startswith("-"):
        if args[i] == "--rm":
            i += 1
            continue
        flag, value = args[i], args[i + 1]
        i += 2
        if flag == "--name":
            name = value
        elif flag == "-w":
            cwd = value
        elif flag == "-e":
            key, _, val = value.partition("=")
            env[key] = val
    cmd = args[i + 1:]
    if cmd[0] == "python":
        cmd[0] = sys.executable
    proc = subprocess.Popen(cmd, env=env, cwd=cwd)
    pidfile = os.path.join(state, name + ".pid")
    with open(pidfile, "w") as f:
        f.write(str(proc.pid))
    signal.signal(signal.SIGTERM, lambda *a: proc.send_signal(signal.SIGTERM))
    rc = proc.wait()
    os.remove(pidfile)
    sys.exit(rc if rc >= 0 else 128 - rc)
    """)


def wait_for(predicate, timeout=30, interval=0.05, desc="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = predicate()
        if result:
            return result
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {desc}")


@pytest.fixture()
def fake_docker(tmp_path, monkeypatch):
    bin_dir, state = tmp_path / "bin", tmp_path / "docker-state"
    bin_dir.mkdir()
    state.mkdir()
    script = bin_dir / "docker"
    script.write_text(f"#!{sys.executable}\n" + FAKE_DOCKER)
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_DOCKER_DIR", str(state))

    def calls():
        path = state / "calls.jsonl"
        if not path.exists():
            return []
        return [json.loads(line) for line in path.read_text().splitlines()]

    return calls


def docker_agent(work, agent_id="dk", image="img:test"):
    agent = Agent(AgentConfig(master_port=free_port(), id=agent_id, slots=2,
                              device="cpu", runtime="docker",
                              docker_image=image, work_dir=str(work)))
    agent.setup()
    return agent


def command(alloc_id, argv, slots=0):
    return {"type": "start", "allocation_id": alloc_id, "slots": slots,
            "rank": 0, "world_size": 1, "task_type": "command",
            "alloc_token": f"tok-{alloc_id}",
            "spec": {"argv": argv, "env": {"EXTRA": "x"}}}


def reap_exit(agent, alloc_id, timeout=30):
    wait_for(lambda: (agent.reap_tasks(), alloc_id not in agent.tasks)[1],
             timeout, desc=f"{alloc_id} to exit")
    return [e["exit_code"] for e in agent.pending_exits
            if e["allocation_id"] == alloc_id][-1]


def pid_gone(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


DUMP = ("import json, os, sys, time\n"
        "json.dump({'env': dict(os.environ), 'cwd': os.getcwd(),\n"
        "           'pid': os.getpid()}, open(sys.argv[1], 'w'))\n"
        "time.sleep(float(sys.argv[2]))\n")


def test_task_runs_in_docker_with_its_cards(fake_docker, tmp_path):
    """The agent's argv reaches docker as the C++ layout, the task sees
    only its -e variables, its cards renumbered from 0 inside the
    container, and the docker CLI's exit code is the task's."""
    agent = docker_agent(tmp_path / "work")
    out = tmp_path / "env.json"
    agent.start_task(command("d1", ["python", "-c", DUMP, str(out), "0"],
                             slots=1))
    assert agent.tasks["d1"].cards == ["0"]
    assert reap_exit(agent, "d1") == 0
    run = fake_docker()[0]
    work = str(tmp_path / "work")
    vars_ = agent.task_vars(command("d1", [], slots=1), "d1", ["0"])
    assert ["docker", *run] == agent_mod.docker_run_argv(
        "d1", "img:test", work, work, vars_, ["0"],
        ["python", "-c", DUMP, str(out), "0"])
    assert run[run.index("--gpus") + 1] == '"device=0"'
    seen = json.loads(out.read_text())
    # (Python itself may add LC_CTYPE at start-up: PEP 538)
    assert set(seen["env"]) - {"LC_CTYPE"} == set(vars_) | {"PATH"}
    assert seen["env"]["CUDA_VISIBLE_DEVICES"] == "0"
    assert seen["env"]["DCT_ALLOCATION_ID"] == "d1"
    assert seen["env"]["EXTRA"] == "x" and seen["cwd"] == work
    assert agent.free_cards == ["0", "1"]
    # a zero-slot task gets no --gpus; the harness runs the image's python
    agent.start_task({**command("d2", []), "spec": {
        "entrypoint": "model_def:T"}})
    assert reap_exit(agent, "d2") != 0  # no model_def here
    run = fake_docker()[1]
    assert "--gpus" not in run
    assert run[-4:] == ["python", "-m",
                        "determined_clone_tpu_torch.exec.trial",
                        "model_def:T"]


def test_second_card_maps_to_zero_inside(fake_docker, tmp_path):
    agent = docker_agent(tmp_path / "work")
    agent.free_cards = ["1"]  # card 0 held elsewhere
    out = tmp_path / "env.json"
    agent.start_task(command("c1", ["python", "-c", DUMP, str(out), "0"],
                             slots=1))
    assert reap_exit(agent, "c1") == 0
    run = fake_docker()[0]
    assert run[run.index("--gpus") + 1] == '"device=1"'
    assert json.loads(out.read_text())["env"]["CUDA_VISIBLE_DEVICES"] == "0"


def test_preempt_reaches_the_task_and_kill_runs_docker_kill(fake_docker,
                                                            tmp_path):
    agent = docker_agent(tmp_path / "work")
    trap = ("import signal, sys, time\n"
            "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
            f"open({str(tmp_path / 'up')!r}, 'w').close()\n"
            "time.sleep(60)\n")
    agent.start_task(command("p1", ["python", "-c", trap]))
    wait_for(lambda: (tmp_path / "up").exists(), desc="task up")
    agent.preempt_task("p1")
    assert reap_exit(agent, "p1") == 0

    out = tmp_path / "k.json"
    agent.start_task(command("k1", ["python", "-c", DUMP, str(out), "60"]))
    wait_for(out.exists, desc="k1 up")
    inner = json.loads(out.read_text())["pid"]
    agent.kill_task("k1")
    assert reap_exit(agent, "k1") == 128 + signal.SIGKILL
    wait_for(lambda: pid_gone(inner), desc="the container's command dead")
    wait_for(lambda: ["kill", "dct-task-k1"] in fake_docker(),
             desc="docker kill")
    wait_for(lambda: (agent.reap_tasks(), not agent._kill_helpers)[1],
             desc="the kill helper reaped")


def test_reattach_adopts_a_running_task_and_reports_a_finished_one(
        fake_docker, tmp_path):
    """A restarted agent re-adopts the running task (the docker CLI,
    matched by the container name in its cmdline), keeps its card, kills
    it with docker kill, and reports the exit code of the task that
    ended while no agent was up."""
    work = tmp_path / "work"
    first = docker_agent(work, "dk1")
    out = tmp_path / "long.json"
    first.start_task(command("r1", ["python", "-c", DUMP, str(out), "60"],
                             slots=1))
    first.start_task(command("r2", ["python", "-c", "import sys; "
                                                     "sys.exit(5)"]))
    wait_for(out.exists, desc="r1 up")
    wait_for(lambda: os.path.exists(first.exit_file("r2")), desc="r2 done")
    r1 = first.tasks["r1"]
    assert agent_mod.proc_matches_task(r1.task_pid, "r1")
    assert not agent_mod.proc_matches_task(r1.task_pid, "r2")
    del first  # the agent "dies"; its supervisors live on

    second = docker_agent(work, "dk2")
    second.reattach_tasks()
    assert list(second.tasks) == ["r1"] and second.tasks["r1"].adopted
    assert second.free_cards == ["1"]
    assert [(e["allocation_id"], e["exit_code"])
            for e in second.pending_exits] == [("r2", 5)]
    inner = json.loads(out.read_text())["pid"]
    second.kill_task("r1")
    assert reap_exit(second, "r1") == 128 + signal.SIGKILL
    wait_for(lambda: pid_gone(inner), desc="r1's command dead")
    assert second.free_cards == ["0", "1"]


def test_docker_image_flag_and_config_key(tmp_path):
    cfg = tmp_path / "agent.yaml"
    cfg.write_text("runtime: docker\ndocker_image: from-file:1\n")
    parse = agent_mod.build_parser().parse_args
    c = agent_mod.config_from_args(parse(["--config", str(cfg)]))
    assert (c.runtime, c.docker_image) == ("docker", "from-file:1")
    c = agent_mod.config_from_args(parse(
        ["--config", str(cfg), "--docker-image", "flag:2"]))
    assert c.docker_image == "flag:2"
    assert AgentConfig().docker_image == "python:3.11-slim"
