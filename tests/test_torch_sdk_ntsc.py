"""The port's SDK (``sdk.py``), its CLI and its NTSC task server
(``exec/task.py``) on one C++ master and the port's agent
(``python -m determined_clone_tpu_torch.agent --device cpu``).

The counterparts of ``tests/test_cli_sdk.py`` (the SDK with a context
upload, the CLI's surface, login/logout, a shell's lifecycle) and of
``tests/test_ntsc_proxy.py`` (a shell's ``/exec`` through the master's
proxy, a command's argv, the command's refusal without one, listing
and filtering, the idle watcher, a TensorBoard task's ``/data``). The
trial is the JAX test's written as a ``TorchTrial`` (the uploaded
context has two modules; ``w`` moves to ``TARGET`` by SGD), and the
master's argv for a task, ``python -m determined_clone_tpu.exec.task``,
runs the port's server under the port's agent.

Against the JAX package, on the same master: the JAX SDK's refs read
what the port's read (describe, trials, checkpoints, the top
checkpoint, a model's versions); the CLI's commands print what the JAX
CLI prints; a downloaded checkpoint passes the port's and the JAX
package's ``validate_checkpoint_dir``; a TensorBoard task's ``/data``
equals the master's metrics for the experiment. Nothing here is a
float computed twice, so every comparison is exact.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import yaml

from determined_clone_tpu import sdk as jsdk
from determined_clone_tpu.cli import cli as jcli
from determined_clone_tpu.core import validate_checkpoint_dir as jvalidate
from determined_clone_tpu_torch import cli, sdk
from determined_clone_tpu_torch.api.client import MasterError, MasterSession
from determined_clone_tpu_torch.core import validate_checkpoint_dir
from tests.test_torch_master_client import build_binaries, start_master

REPO = Path(__file__).resolve().parent.parent

TRIAL_MODULE = '''
import numpy as np
import torch

from determined_clone_tpu_torch.training import TorchTrial
from determined_clone_tpu_torch.training import optim
from uploaded_helper import TARGET


class Trial(TorchTrial):
    def initial_params(self, gen):
        return {"w": torch.zeros((), device=self.context.device)}

    def optimizer(self):
        return optim.sgd(0.3)

    def loss(self, params, batch, seed):
        return (params["w"] - TARGET) ** 2, {}

    def training_data(self):
        for _ in range(64):
            yield np.zeros((2, 1), np.float32)

    def validation_data(self):
        return [np.zeros((2, 1), np.float32)]

    @property
    def global_batch_size(self):
        return 2
'''

HELPER_MODULE = "TARGET = 1.5\n"


def wait_for(predicate, timeout=60, interval=0.2, desc="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = predicate()
        if result:
            return result
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {desc}")


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """One C++ master and one port agent with one (CPU) slot, its work
    directory without any model code."""
    if not build_binaries():
        pytest.skip("C++ master build unavailable")
    tmp = tmp_path_factory.mktemp("sdk-ntsc")
    (tmp / "agent-work").mkdir()
    proc, port = start_master(tmp)
    agent = subprocess.Popen(
        [sys.executable, "-m", "determined_clone_tpu_torch.agent",
         "--master-port", str(port), "--id", "cli-agent", "--slots", "1",
         "--device", "cpu", "--work-dir", str(tmp / "agent-work")],
        cwd=str(tmp / "agent-work"), stdout=subprocess.DEVNULL,
        stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    session = MasterSession("127.0.0.1", port, timeout=10, retries=20)
    session.token = None
    try:
        wait_for(lambda: session.list_agents(), 60, desc="the port agent")
        yield {"session": session, "tmp": tmp, "port": port,
               "master_addr": f"127.0.0.1:{port}"}
    finally:
        agent.kill()
        agent.wait(timeout=10)
        proc.kill()
        proc.wait(timeout=10)


@pytest.fixture()
def det(cluster, tmp_path, monkeypatch):
    """The port's CLI in-process against the fixture master; each CLI's
    login store under its own HOME."""
    monkeypatch.setenv("HOME", str(tmp_path))

    def run(*argv):
        return cli.main(["-m", cluster["master_addr"], *argv])

    return run


def write_model_dir(tmp) -> Path:
    model_dir = tmp / "model_def"
    model_dir.mkdir(exist_ok=True)
    (model_dir / "model_def.py").write_text(TRIAL_MODULE)
    (model_dir / "uploaded_helper.py").write_text(HELPER_MODULE)
    return model_dir


def exp_config(cluster, name="cli-exp", batches=6):
    return {
        "name": name,
        "entrypoint": "model_def:Trial",
        "searcher": {"name": "single", "metric": "loss",
                     "max_length": {"batches": batches}},
        "resources": {"slots_per_trial": 1},
        "scheduling_unit": 2,
        "checkpoint_storage": {"type": "shared_fs",
                               "host_path": str(cluster["tmp"] / "ckpts")},
        "hyperparameters": {},
        "max_restarts": 0,
    }


def trial_log(session, trial_id):
    return "\n".join(str(r.get("log", "")) for r in
                     session.task_logs(f"trial-{trial_id}.0", limit=500))


@pytest.fixture(scope="module")
def completed(cluster, tmp_path_factory):
    """One finished experiment through the port's SDK, for the reads."""
    d = sdk.Determined("127.0.0.1", cluster["port"])
    model_dir = write_model_dir(tmp_path_factory.mktemp("completed"))
    exp = d.create_experiment(exp_config(cluster, "sdk-reads"),
                              model_dir=str(model_dir))
    state = exp.wait(timeout=180, interval=0.3)
    if state != "COMPLETED":
        tid = exp.describe()["trials"][0]["id"]
        raise AssertionError(f"{state}:\n{trial_log(cluster['session'], tid)}")
    return exp.id


# -- tests/test_cli_sdk.py ------------------------------------------------------

def test_sdk_experiment_with_context_upload(cluster, completed, tmp_path):
    """The agent's work directory has no model code: the trial ran from
    the uploaded context. The port's refs read what the JAX SDK's read;
    the download validates in both packages; archive and delete."""
    d = sdk.Determined("127.0.0.1", cluster["port"])
    jd = jsdk.Determined("127.0.0.1", cluster["port"])
    exp, jexp = d.get_experiment(completed), jd.get_experiment(completed)
    assert exp.state == "COMPLETED"
    assert exp.describe() == jexp.describe()
    trials = exp.trials()
    assert len(trials) == 1
    metrics = trials[0].metrics()
    assert metrics == jexp.trials()[0].metrics()
    val = [m for m in metrics if m.get("group") == "validation"]
    assert val and val[-1]["metrics"]["loss"] < 0.5

    ckpts = exp.checkpoints()
    assert [c.uuid for c in ckpts] == [c.uuid for c in jexp.checkpoints()]
    assert [c.uuid for c in trials[0].checkpoints()] == [c.uuid
                                                         for c in ckpts]
    out = tmp_path / "dl"
    assert ckpts[-1].download(str(out)) == str(out)
    assert validate_checkpoint_dir(str(out), ckpts[-1].uuid)
    assert jvalidate(str(out), ckpts[-1].uuid)

    top = exp.top_checkpoint()
    assert top is not None and top.uuid == jexp.top_checkpoint().uuid
    model = d.create_model("sdk-model")
    version = model.register_version(top.uuid)
    assert version == jd.get_model("sdk-model").versions()[0]
    assert [v["version"] for v in model.versions()] == [1]

    # lifecycle: a second experiment, archived, then deleted
    e2 = d.create_experiment(exp_config(cluster, "sdk-ctx", batches=2),
                             model_dir=str(write_model_dir(tmp_path)))
    assert e2.wait(timeout=180, interval=0.3) == "COMPLETED"
    e2.archive()
    assert e2.describe()["experiment"]["archived"] is True
    e2.archive(archived=False)
    e2.delete()
    with pytest.raises(MasterError):
        e2.describe()


def test_cli_full_surface(cluster, completed, det, tmp_path, capsys):
    session = cluster["session"]
    assert det("master", "info") == 0
    assert json.loads(capsys.readouterr().out)["cluster_name"] == "dct"

    model_dir = write_model_dir(tmp_path)
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(exp_config(cluster, "cli-exp",
                                                  batches=2)))
    rc = det("experiment", "create", str(cfg_path), str(model_dir),
             "--follow", "--timeout", "180")
    out = capsys.readouterr().out
    exp_id = int(out.split("Created experiment ")[1].split()[0])
    trial_id = session.get_experiment(exp_id)["trials"][0]["id"]
    assert rc == 0 and "COMPLETED" in out, (
        f"{out}\n{trial_log(session, trial_id)}")

    assert det("checkpoint", "list", str(exp_id)) == 0
    uuid = capsys.readouterr().out.splitlines()[2].split("|")[0].strip()
    dl_dir = tmp_path / "ckpt-dl"
    assert det("checkpoint", "download", uuid, "-o", str(dl_dir)) == 0
    assert f"Downloaded checkpoint {uuid}" in capsys.readouterr().out
    assert validate_checkpoint_dir(str(dl_dir), uuid)

    assert det("model", "create", "cli-model") == 0
    assert det("model", "register-version", "cli-model", uuid) == 0
    assert "version 1" in capsys.readouterr().out
    assert det("workspace", "create", "cli-ws") == 0
    ws_id = int(capsys.readouterr().out.split("(id ")[1].rstrip(")\n"))
    assert det("project", "create", str(ws_id), "cli-proj") == 0
    proj_id = int(capsys.readouterr().out.split("(id ")[1].rstrip(")\n"))
    assert det("experiment", "move", str(exp_id), str(proj_id)) == 0
    assert "to cli-ws/cli-proj" in capsys.readouterr().out
    assert det("experiment", "label", str(exp_id), "a,b") == 0
    assert "['a', 'b']" in capsys.readouterr().out
    tpl_path = tmp_path / "tpl.yaml"
    tpl_path.write_text(yaml.safe_dump({"max_restarts": 2}))
    assert det("template", "set", "cli-tpl", str(tpl_path)) == 0
    assert det("webhook", "create", "http://127.0.0.1:9/hook",
               "--trigger", "COMPLETED") == 0
    assert det("group", "create", "cli-group") == 0
    capsys.readouterr()
    # the experiment reads COMPLETED before the agent has reported its
    # trial's exit; the queue must not change between the two CLIs' reads
    wait_for(lambda: not session.job_queue(), desc="an empty job queue")

    # every read prints what the JAX CLI prints against this master
    reads = [["master", "config"], ["master", "logs", "--limit", "5"],
             ["experiment", "list"], ["experiment", "describe", str(exp_id)],
             ["experiment", "progress", str(exp_id)],
             ["trial", "describe", str(trial_id)],
             ["trial", "summary", str(trial_id)],
             ["trial", "metrics", str(trial_id)],
             ["checkpoint", "list", str(completed)],
             ["checkpoint", "describe", uuid], ["agent", "list"],
             ["job", "list"], ["workspace", "list"],
             ["workspace", "describe", str(ws_id)], ["model", "list"],
             ["model", "describe", "cli-model"], ["template", "list"],
             ["template", "describe", "cli-tpl"], ["webhook", "list"],
             ["group", "list"], ["rbac", "list-roles"],
             ["rbac", "list-assignments"], ["task", "list"],
             ["shell", "list"], ["notebook", "list"], ["cmd", "list"],
             ["tensorboard", "list"]]
    master = ["-m", cluster["master_addr"]]
    for argv in reads:
        assert cli.main(master + argv) == 0, argv
        port_out = capsys.readouterr().out
        assert jcli.main(master + argv) == 0, argv
        assert port_out == capsys.readouterr().out, argv

    # the CLI's override plumbing, archive and trial kill
    cfg2_path = tmp_path / "config2.yaml"
    cfg2_path.write_text(yaml.safe_dump(exp_config(cluster, "cli-exp2",
                                                   batches=10_000)))
    assert det("experiment", "create", str(cfg2_path), str(model_dir),
               "--config-override", "name=overridden") == 0
    exp2 = int(capsys.readouterr().out.split("Created experiment ")[1]
               .split()[0])
    t2 = wait_for(lambda: session.get_experiment(exp2)["trials"],
                  desc="the trial")[0]["id"]
    assert det("trial", "kill", str(t2)) == 0
    assert det("experiment", "list") == 0
    assert "overridden" in capsys.readouterr().out
    wait_for(lambda: session.get_experiment(exp2)["experiment"]["state"]
             in ("CANCELED", "COMPLETED", "ERRORED"), 60,
             desc="the killed experiment")
    assert det("experiment", "archive", str(exp2)) == 0
    assert "archived=True" in capsys.readouterr().out

    # the refusals left name their ROADMAP.md item; checkpoint stats
    # reads the content-addressed store (an empty one here)
    assert det("checkpoint", "stats", "--host-path",
               str(tmp_path / "cas-root")) == 0
    assert json.loads(capsys.readouterr().out)["cas_checkpoints"] == 0
    for argv, item in ((["exec-cache", "stats", "--dir", "x"], "item 6"),
                       (["deploy", "gcp", "up", "--project", "p",
                         "--zone", "z"], "item 6"),
                       (["deploy", "gke", "down", "--project", "p",
                         "--zone", "z"], "item 6")):
        assert det(*argv) == 2, argv
        assert item in capsys.readouterr().err, argv


def test_cli_auth_login_logout(cluster, det, capsys):
    assert det("user", "login", "admin", "--password", "") == 0
    capsys.readouterr()
    assert det("user", "whoami") == 0
    assert "admin" in capsys.readouterr().out
    assert det("user", "create", "cliuser", "--password", "pw") == 0
    capsys.readouterr()
    assert det("user", "list") == 0
    assert "cliuser" in capsys.readouterr().out
    assert det("user", "settings", "theme", "dark") == 0
    assert json.loads(capsys.readouterr().out)["theme"] == "dark"
    assert det("rbac", "me") == 0
    capsys.readouterr()
    assert det("user", "logout") == 0
    capsys.readouterr()


def test_cli_shell_lifecycle(cluster, det, capsys):
    """``shell start``, ``shell exec`` through the proxy (a zero-slot task
    sees no card: ``CUDA_VISIBLE_DEVICES`` is empty), ``task list`` and
    ``task kill``."""
    assert det("shell", "start", "--name", "cli-sh") == 0
    task_id = capsys.readouterr().out.split("Started shell ")[1].strip()
    session = cluster["session"]
    wait_proxied(session, task_id)
    assert det("shell", "exec", task_id, "echo", "from-cli") == 0
    assert "from-cli" in capsys.readouterr().out
    assert det("shell", "exec", task_id, "--", sys.executable, "-c",
               "import os; print(repr(os.environ.get("
               "'CUDA_VISIBLE_DEVICES')))") == 0
    assert capsys.readouterr().out.strip() == "''"
    assert det("task", "list") == 0
    assert task_id in capsys.readouterr().out
    assert det("task", "kill", task_id) == 0
    capsys.readouterr()
    wait_for(lambda: session.get_task(task_id)["state"] == "CANCELED",
             desc="the shell to end")
    # the agent ships a task's log once it has reaped the process
    wait_for(lambda: any("shell server on" in str(r.get("log", ""))
                         for r in session.task_logs(task_id)),
             desc="the shell's shipped log")
    assert det("task", "logs", task_id) == 0
    assert "shell server on" in capsys.readouterr().out


# -- tests/test_ntsc_proxy.py ---------------------------------------------------

def wait_proxied(session, task_id):
    """Task RUNNING with a registered proxy address."""
    return wait_for(
        lambda: (lambda t: t if t["state"] == "RUNNING" and
                 t["proxy_address"] else None)(session.get_task(task_id)),
        desc=f"{task_id} running + proxied")


def test_shell_task_exec_through_proxy(cluster):
    session = cluster["session"]
    task = session.create_task("shell", name="sh1")
    assert task["task_type"] == "shell" and task["slots"] == 0
    wait_proxied(session, task["id"])
    out = session.proxy(task["id"], "/exec", "POST",
                        {"cmd": ["echo", "hello-ntsc"]})
    assert out["code"] == 0 and out["stdout"].strip() == "hello-ntsc"
    page = session.proxy(task["id"], "/")
    assert page["mode"] == "shell"
    assert page["endpoints"] == ["/exec (POST)", "/data (GET, tensorboard)"]
    session.kill_task(task["id"])
    wait_for(lambda: session.get_task(task["id"])["state"] == "CANCELED",
             desc="task canceled")


def test_command_task_runs_user_argv(cluster):
    session = cluster["session"]
    marker = cluster["tmp"] / "cmd-ran.txt"
    task = session.create_task(
        "command", name="cmd1",
        cmd=["python", "-c",
             f"open({str(marker)!r}, 'w').write('done'); print('cmd-log')"])
    wait_for(lambda: session.get_task(task["id"])["state"] == "COMPLETED",
             desc="command task completion")
    assert marker.read_text() == "done"
    assert session.get_task(task["id"])["exit_code"] == 0
    logs = wait_for(lambda: [r for r in session.task_logs(task["id"])
                             if "cmd-log" in str(r.get("log", ""))],
                    desc="the command's shipped log")
    assert logs


def test_command_task_requires_argv(cluster):
    with pytest.raises(MasterError) as err:
        cluster["session"].create_task("command", name="bad")
    assert err.value.status == 400


def test_task_listing_and_filter(cluster):
    session = cluster["session"]
    task = session.create_task("notebook", name="nb1")
    assert task["id"] in {t["id"] for t in session.list_tasks()}
    assert task["id"] in {t["id"] for t in session.list_tasks("notebook")}
    assert task["id"] not in {t["id"] for t in session.list_tasks("shell")}
    wait_proxied(session, task["id"])
    page = session.proxy(task["id"], "/")
    assert page["mode"] == "notebook"
    # /exec is the shell's alone
    with pytest.raises(MasterError) as err:
        session.proxy(task["id"], "/exec", "POST", {"cmd": ["true"]})
    assert err.value.status == 403
    session.kill_task(task["id"])


def test_idle_watcher_reaps_idle_task(cluster):
    session = cluster["session"]
    task = session.create_task("shell", name="idle1", idle_timeout=2.0)
    wait_proxied(session, task["id"])
    final = wait_for(
        lambda: (lambda t: t if t["state"] == "CANCELED" else None)(
            session.get_task(task["id"])),
        timeout=30, desc="idle task reaped")
    assert final["state"] == "CANCELED"


def test_tensorboard_task_serves_metric_data(cluster, completed):
    """``/data`` with no experiment is empty; with one it holds every
    trial's metrics as the master lists them."""
    session = cluster["session"]
    task = session.create_task("tensorboard", name="tb1", experiment_ids=[])
    wait_proxied(session, task["id"])
    assert session.proxy(task["id"], "/data") == {"experiments": {}}
    session.kill_task(task["id"])
    task = session.create_task("tensorboard", name="tb2",
                               experiment_ids=[completed])
    wait_proxied(session, task["id"])
    data = session.proxy(task["id"], "/data")["experiments"]
    tid = session.get_experiment(completed)["trials"][0]["id"]
    assert data == {str(completed): {"trials": {
        str(tid): session.trial_metrics(tid, limit=10000)}}}
    session.kill_task(task["id"])


def test_task_server_starts_without_torch():
    """A task is a zero-slot process: the NTSC server and the REST client
    it uses import no torch (and nothing of the JAX package)."""
    probe = ("import sys; import determined_clone_tpu_torch.exec.task as t; "
             "t._master(); import determined_clone_tpu_torch.tensorboard; "
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('torch', 'jax', 'determined_clone_tpu')); print(bad)")
    run = subprocess.run([sys.executable, "-c", probe], cwd=str(REPO),
                         env={**os.environ, "PYTHONPATH": str(REPO)},
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "[]"


def test_every_jax_command_exists():
    """The port's command tree is the JAX CLI's: every command and flag,
    with ``--device`` where a model or the scaling bench runs (the card
    unless ``cpu``) and the fleet's ``--resource-pool``; ``kv stats
    --config`` is there since the content-addressed checkpoint store
    is."""
    import argparse

    def paths(parser, pre=()):
        out = set()
        for action in parser._actions:
            if isinstance(action, argparse._SubParsersAction):
                for name, sub in action.choices.items():
                    out |= {pre + (name,)} | paths(sub, pre + (name,))
            elif action.option_strings:
                out.add(pre + tuple(sorted(action.option_strings)))
        return out

    jax_tree, port_tree = (paths(mod.build_parser()) for mod in (jcli, cli))
    assert jax_tree - port_tree == set()
    assert port_tree - jax_tree == {
        ("deploy", "local", "cluster-up", "--device"),
        ("fleet", "up", "--device"), ("fleet", "up", "--resource-pool"),
        ("mesh", "--device"), ("serve", "--device")}
