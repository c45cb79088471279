"""The port's fleet as the C++ master's serving gang allocations
(``serving/fleet.py`` ``MasterLink``), held against the JAX package.

The counterpart of ``tests/test_serving_fleet.py::
test_master_serving_gang_lifecycle``: a port ``ServingFleet`` of a 2-layer,
d-64 GPT (the JAX ``init``'s weights through ``convert.params_from_numpy``,
scaled by 10 so that tokens depend on the context; fp32, one torch
thread) registers with one C++ master through ``MasterLink``. Held: the
master's fleet record and its ``dct_master_sched_serving_*`` families,
greedy tokens equal to the JAX reference's (an uncached JAX forward per
token) token for token, a master-driven scale-down that drains without
losing a request in flight, the kill reclaiming every slot, and no
``fleet-link``/``fleet-drain`` thread left (``tests/conftest.py``).

The pool choice: the master schedules a ``serving`` allocation onto any
enabled agent of the fleet's pool with free slots. A port agent (the
trial agent, ``--device cpu``) waits in pool ``default``: a fleet given
a pool of its own never lands there, and a fleet record in ``default`` does,
where the agent runs the master's argv ``python -m
determined_clone_tpu.serving.fleet`` as the port's module, which exits
naming ``dct fleet up``. ``fleet up --with-master`` and ``fleet status``/
``scale`` through the master run here too, the status printed as the
JAX CLI prints it.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch

from determined_clone_tpu.cli import cli as jcli
from determined_clone_tpu.models import gpt as jgpt
from determined_clone_tpu_torch import cli, convert
from determined_clone_tpu_torch.api.client import MasterSession
from determined_clone_tpu_torch.models import gpt as tgpt
from determined_clone_tpu_torch.serving import (
    BucketSpec,
    KVCacheConfig,
    MasterLink,
    ServingFleet,
)
from tests.test_torch_master_client import build_binaries, start_master

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = dataclasses.replace(jgpt.GPTConfig.tiny(), compute_dtype=jnp.float32,
                           attention_impl="mha")
TCFG = dataclasses.replace(tgpt.GPTConfig.tiny(), compute_dtype=torch.float32,
                           attention_impl="mha")
PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11], [42], [5, 6, 200, 17]]
MAX_NEW = 8


def pool_of(name):
    """Each fleet gets a pool of its own: the agent a closed link
    registered stays enabled in its pool until the master times it out,
    and the master would place a later fleet's replicas on it."""
    return f"fleet-{name}"


def wait_for(predicate, timeout=60.0, interval=0.05, desc="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = predicate()
        if got:
            return got
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {desc}")


def master_get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        raw = resp.read().decode()
    return raw if path == "/metrics" else json.loads(raw)


def fleet_record(port, name):
    return next((f for f in master_get(port, "/api/v1/serving/fleets")[
        "fleets"] if f["name"] == name), None)


@pytest.fixture(scope="module")
def params():
    """(jax, port) params: the JAX ``init`` from seed 0, scaled by 10."""
    jp = jax.tree_util.tree_map(
        lambda x: x * 10.0,
        jax.jit(jgpt.init, static_argnums=1)(jax.random.PRNGKey(0), JCFG))
    return jp, convert.params_from_numpy(jax.device_get(jp), "cpu")


@pytest.fixture(scope="module")
def reference(params):
    """The JAX reference's greedy tokens: the uncached forward per token."""
    jp = params[0]
    out = []
    for prompt in PROMPTS:
        toks = list(prompt)
        for _ in range(MAX_NEW):
            logits = jgpt.apply(jp, JCFG, jnp.asarray([toks], jnp.int32))
            toks.append(int(jnp.argmax(logits[0, -1])))
        out.append(toks[len(prompt):])
    yield out
    jax.clear_caches()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """One C++ master and one port agent (``--device cpu``, one slot) in
    pool ``default``, the trial agent a fleet must keep off."""
    if not build_binaries():
        pytest.skip("C++ master build unavailable")
    tmp = tmp_path_factory.mktemp("fleet-master")
    proc, port = start_master(tmp)
    (tmp / "agent").mkdir()
    agent = subprocess.Popen(
        [sys.executable, "-m", "determined_clone_tpu_torch.agent",
         "--master-port", str(port), "--id", "trial-agent", "--slots", "1",
         "--device", "cpu", "--work-dir", str(tmp / "agent")],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    session = MasterSession("127.0.0.1", port, timeout=10, retries=5)
    session.token = None
    try:
        wait_for(lambda: session.list_agents(), 60, 0.2, "the port agent")
        yield {"port": port, "session": session, "tmp": tmp}
    finally:
        agent.kill()
        agent.wait(timeout=10)
        proc.kill()
        proc.wait(timeout=10)


def port_fleet(tp, name):
    return ServingFleet(tp, TCFG, name=name, buckets=BucketSpec.build(2, 32),
                        cache=KVCacheConfig(num_blocks=32, block_size=8),
                        warmup=False, tracing=False, device="cpu")


def test_master_serving_gang_lifecycle(cluster, params, reference):
    """Replicas ride real master allocations in the fleet's own pool: the
    fleet shows up in /api/v1/serving/fleets with running gangs, the
    scheduler's telemetry carries the serving families, the tokens are
    the JAX reference's, a master-driven scale-down drains locally with
    every request in flight answered, and the kill reclaims every slot."""
    port, session = cluster["port"], cluster["session"]
    fleet = port_fleet(params[1], "itest")
    link = None
    try:
        t0 = time.monotonic()
        link = MasterLink(fleet, port, replicas=2,
                          resource_pool=pool_of("itest"))
        link.wait_replicas(2, timeout=60.0)
        up_s = time.monotonic() - t0
        mine = wait_for(lambda: (lambda f: f if f and f["running"] == 2
                                 else None)(fleet_record(port, "itest")),
                        desc="both replicas RUNNING")
        assert mine["queued"] == 0
        assert mine["resource_pool"] == pool_of("itest")
        assert [r["state"] for r in mine["replicas"]] == ["RUNNING"] * 2
        # the pool choice: nothing of the fleet reached the trial agent
        agents = {a["id"]: a for a in session.list_agents()}
        assert agents["fleet-itest"]["resource_pool"] == pool_of("itest")
        assert not [j for j in session.job_queue()
                    if j.get("resource_pool") == "default"]

        text = master_get(port, "/metrics")
        for fam in ("dct_master_sched_serving_submitted_total",
                    "dct_master_sched_serving_running_total",
                    "dct_master_sched_serving_completed_total"):
            assert fam in text
        assert "dct_master_sched_serving_submitted_total 2" in text

        handles = [fleet.submit(p, MAX_NEW, timeout=60.0) for p in PROMPTS]
        assert [h.result(60.0).tokens for h in handles] == reference

        # master-driven scale-down with requests in flight: the kill
        # command drains the replica, which reports `exited` only after
        # its last request
        inflight = [fleet.submit(p, MAX_NEW, timeout=60.0)
                    for p in PROMPTS * 2]
        link.scale(1)
        wait_for(lambda: len(fleet.replica_ids()) == 1, desc="the drain")
        assert [h.result(60.0).tokens for h in inflight] == reference * 2
        assert fleet.stats().rejected == 0
        mine = wait_for(lambda: (lambda f: f if f["running"] == 1
                                 else None)(fleet_record(port, "itest")),
                        desc="the master to see the exit")
        assert mine["desired"] == 1

        link.close(kill_fleet=True)
        link = None
        assert fleet_record(port, "itest")["running"] == 0
        assert not [t for t in threading.enumerate()
                    if t.name.startswith(("fleet-link", "fleet-drain"))]
        assert up_s < 60.0
    finally:
        if link is not None:
            link.close(kill_fleet=True)
        fleet.close()


def test_a_fleet_in_the_trial_agents_pool_lands_on_it(cluster):
    """A fleet record in pool ``default`` is scheduled onto the port's
    trial agent, which runs the master's serving argv as the port's
    ``serving/fleet.py``: its ``__main__`` exits at once naming ``dct
    fleet up`` (a replica needs the in-process ``MasterLink``). This is
    why ``MasterLink`` takes a pool of its own."""
    port, session = cluster["port"], cluster["session"]
    session.post("/api/v1/serving/fleets", {
        "name": "stray", "replicas": 1, "resource_pool": "default",
        "slots_per_replica": 1})
    try:
        rep = wait_for(lambda: (lambda f: f["replicas"][0]
                                if f and f["replicas"] else None)(
            fleet_record(port, "stray")), desc="the stray replica")

        def shipped():
            try:
                logs = session.task_logs(rep["id"])
            except Exception:  # noqa: BLE001 - not registered yet
                return None
            text = "\n".join(str(r.get("log", "")) for r in logs)
            return text if "dct fleet up" in text else None

        text = wait_for(shipped, 60, 0.2, "the replica's shipped log")
        assert "determined_clone_tpu_torch.serving.fleet is a library" in text
    finally:
        session.post("/api/v1/serving/fleets/stray/kill", {})
        wait_for(lambda: not [j for j in session.job_queue()
                              if j.get("resource_pool") == "default"],
                 60, 0.2, "the trial agent's slot to free")


def test_cli_fleet_through_the_master(cluster, params, capsys):
    """``fleet status`` and ``fleet scale`` without ``--url`` ask the
    master (status printed as the JAX CLI prints it); ``fleet up
    --with-master --selftest`` serves through master-scheduled
    replicas and leaves nothing running."""
    port = cluster["port"]
    addr = ["-m", f"127.0.0.1:{port}"]
    fleet = port_fleet(params[1], "cli")
    link = MasterLink(fleet, port, replicas=1, resource_pool=pool_of("cli"))
    try:
        link.wait_replicas(1, timeout=60.0)
        wait_for(lambda: (fleet_record(port, "cli") or {}).get(
            "running") == 1, desc="the replica RUNNING")
        capsys.readouterr()
        for argv in (["fleet", "status"], ["fleet", "status", "--json"]):
            assert cli.main(addr + argv) == 0
            port_out = capsys.readouterr().out
            assert jcli.main(addr + argv) == 0
            assert port_out == capsys.readouterr().out, argv
        assert "fleet 'cli': 1 running / 0 queued / 1 desired" in port_out \
            or '"name": "cli"' in port_out
        assert cli.main(addr + ["fleet", "scale", "--name", "cli",
                                "--replicas", "2"]) == 0
        assert "scaling to 2 replicas" in capsys.readouterr().out
        link.wait_replicas(2, timeout=60.0)
    finally:
        link.close(kill_fleet=True)
        fleet.close()
    assert fleet_record(port, "cli")["running"] == 0

    rc = cli.main(addr + ["fleet", "up", "--with-master", "--selftest",
                          "--replicas", "2", "--name", "cli-up",
                          "--resource-pool", pool_of("cli-up"), "--device",
                          "cpu"])
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and doc["with_master"] is True
    assert doc["replicas"] == ["cli-up-1", "cli-up-2"]
    assert doc["stats"]["completed"] == 4
    assert fleet_record(port, "cli-up")["running"] == 0
