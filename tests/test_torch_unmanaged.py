"""Unmanaged trials of the port reporting in to a real C++ master: the
counterparts of ``tests/test_unmanaged.py``, each run through
``determined_clone_tpu_torch.core.init_unmanaged`` and, where the JAX
package can run the same scenario, through ``determined_clone_tpu.core``
too, with the master's records of the two held equal but for ids, times
and names. No agent is involved: the "trial" runs in this process.
"""
import logging
import os
import time

import pytest

from determined_clone_tpu import core as jcore
from determined_clone_tpu_torch import core as tcore
from determined_clone_tpu_torch.api.client import MasterError, MasterSession
from tests.test_torch_master_client import build_binaries, start_master

SIDES = {"jax": jcore, "port": tcore}
VOLATILE = {"id", "experiment_id", "trial_id", "created_at", "ended_at",
            "time", "name", "reported_at", "latest_checkpoint", "uuid",
            "idempotency_key"}


def _strip(obj):
    if isinstance(obj, dict):
        if "COMMIT" in obj:
            # the marker holds the commit's time, whose printed length
            # varies: its presence is compared, not its size
            obj = {**obj, "COMMIT": True}
        return {k: _strip(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


@pytest.fixture(scope="module")
def master(tmp_path_factory):
    if not build_binaries():
        pytest.skip("C++ master build unavailable")
    tmp = tmp_path_factory.mktemp("unmanaged")
    proc, port = start_master(tmp)
    session = MasterSession("127.0.0.1", port, timeout=10, retries=5)
    session.token = None
    yield {"session": session, "port": port}
    proc.kill()
    proc.wait(timeout=10)


def _reports_in(mod, master, storage, name):
    session = master["session"]
    with mod.init_unmanaged(
        master_port=master["port"], name=name,
        config={"searcher": {"name": "single", "metric": "loss",
                             "max_length": {"batches": 10}},
                "checkpoint_storage": {"type": "shared_fs",
                                       "host_path": str(storage)}},
        heartbeat_interval=0.2,
    ) as ctx:
        exp_id = ctx.experiment_id
        # visible as a live experiment, held by no scheduler
        live = session.get_experiment(exp_id)
        queued = [j["id"] for j in session.job_queue()]
        for step in range(1, 4):
            ctx.train.report_training_metrics(
                steps_completed=step, metrics={"loss": 1.0 / step})
        ctx.train.report_validation_metrics(3, {"loss": 0.3})
        with ctx.checkpoint.store_path({"steps_completed": 3}) as (path, _):
            with open(os.path.join(path, "w.txt"), "w") as f:
                f.write("3")
        logging.getLogger("unmanaged-test").warning(
            "hello from off-cluster (%s)", name)
        preempt = ctx.preempt.should_preempt()
        alloc = ctx.allocation_id
    detail = session.get_experiment(exp_id)
    trial = detail["trials"][0]
    return {"live": live, "queued": queued, "alloc": alloc,
            "preempt": preempt, "detail": detail,
            "metrics": session.trial_metrics(trial["id"]),
            "checkpoints": session.get(
                f"/api/v1/experiments/{exp_id}/checkpoints")["checkpoints"],
            "logs": session.task_logs(f"unmanaged-{trial['id']}.0")}


def test_unmanaged_trial_reports_in_like_jax(master, tmp_path):
    runs = {side: _reports_in(mod, master, tmp_path / side, f"run-{side}")
            for side, mod in SIDES.items()}
    for side, run in runs.items():
        assert run["live"]["experiment"]["state"] == "RUNNING"
        assert run["live"]["trials"][0]["state"] == "RUNNING"
        assert run["alloc"] not in run["queued"]
        assert run["preempt"] is False
        assert run["detail"]["experiment"]["state"] == "COMPLETED"
        assert run["detail"]["trials"][0]["state"] == "COMPLETED"
        assert any(m["metrics"]["loss"] == 1.0 for m in run["metrics"])
        assert any(f"hello from off-cluster (run-{side})" in str(r["log"])
                   for r in run["logs"])
        assert len(run["checkpoints"]) == 1
    jax_run, port_run = runs["jax"], runs["port"]
    assert _strip(port_run["metrics"]) == _strip(jax_run["metrics"])
    assert _strip(port_run["detail"]["trials"]) == _strip(
        jax_run["detail"]["trials"])
    assert _strip(port_run["checkpoints"]) == _strip(jax_run["checkpoints"])
    assert (port_run["detail"]["experiment"]["config"]["unmanaged"]
            is jax_run["detail"]["experiment"]["config"]["unmanaged"] is True)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_unmanaged_failure_marks_errored(master, side):
    session = master["session"]
    with pytest.raises(RuntimeError, match="boom"):
        with SIDES[side].init_unmanaged(master_port=master["port"],
                                        name=f"failing-{side}",
                                        heartbeat_interval=0.2) as ctx:
            exp_id = ctx.experiment_id
            raise RuntimeError("boom")
    exp = session.get_experiment(exp_id)
    assert exp["experiment"]["state"] == "ERRORED"
    assert "boom" in exp["trials"][0]["error"]


def test_dead_client_reaped_by_watchdog(tmp_path):
    """A client that registers through the port's session and never
    heartbeats is errored by the master's watchdog, once."""
    if not build_binaries():
        pytest.skip("C++ master build unavailable")
    proc, port = start_master(tmp_path, "--unmanaged-timeout", "1")
    try:
        session = MasterSession("127.0.0.1", port, timeout=10, retries=5)
        session.token = None
        resp = session.post("/api/v1/experiments", {"config": {
            "name": "dead-client", "entrypoint": "unmanaged",
            "unmanaged": True,
            "searcher": {"name": "single", "metric": "loss",
                         "max_length": {"batches": 1}}}})
        exp_id = resp["experiment"]["id"]
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            exp = session.get_experiment(exp_id)
            if exp["experiment"]["state"] == "ERRORED":
                break
            time.sleep(0.3)
        else:
            pytest.fail("watchdog never errored the silent unmanaged trial")
        assert "heartbeat lost" in exp["trials"][0]["error"]
        restarts = exp["trials"][0]["restarts"]
        assert restarts <= 1
        time.sleep(2.5)
        exp = session.get_experiment(exp_id)
        assert exp["experiment"]["state"] == "ERRORED"
        assert exp["trials"][0]["restarts"] == restarts
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_unmanaged_heartbeat_requires_token_under_auth(tmp_path):
    if not build_binaries():
        pytest.skip("C++ master build unavailable")
    proc, port = start_master(tmp_path, "--auth-required")
    try:
        session = MasterSession("127.0.0.1", port, timeout=10, retries=5)
        session.token = None
        user = session.login("admin")
        with tcore.init_unmanaged(master_port=port, name="authed-run",
                                  heartbeat_interval=0.2,
                                  token=session.token) as ctx:
            trial_id = ctx.trial_id
            # anonymous mutation is rejected; the shipped data-plane token
            # (used by the heartbeat thread) is what authorises
            anon = MasterSession("127.0.0.1", port)
            anon.token = None
            with pytest.raises(MasterError) as err:
                anon.post(f"/api/v1/trials/{trial_id}/heartbeat",
                          {"state": "ERRORED"})
            assert err.value.status == 401
        assert user["username"] == "admin"
        assert session.get_experiment(ctx.experiment_id)["experiment"][
            "state"] == "COMPLETED"
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_unmanaged_preemption_flag(master):
    """A kill raises the preempt flag: the master's preempt endpoint says
    so, and the heartbeat's piggybacked flag reaches
    ``ctx.preempt.should_preempt()`` in the port."""
    session = master["session"]
    with tcore.init_unmanaged(master_port=master["port"], name="preempt-run",
                              heartbeat_interval=0.1) as ctx:
        session.kill_experiment(ctx.experiment_id)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if (session.get(f"/api/v1/allocations/{ctx.allocation_id}"
                            f"/preempt")["preempt"]
                    and ctx.preempt.should_preempt()):
                break
            time.sleep(0.1)
        else:
            pytest.fail("preempt flag never raised for unmanaged trial")


def test_log_shipper_batches_and_survives_a_dead_master(master):
    """``LogShipperHandler`` ships batched lines to the allocation's log
    and drops, never raises, when the master is gone."""
    session = master["session"]
    resp = session.post("/api/v1/experiments", {"config": {
        "name": "shipper", "entrypoint": "unmanaged", "unmanaged": True,
        "searcher": {"name": "single", "metric": "loss",
                     "max_length": {"batches": 1}}}})
    handle = resp["unmanaged"][0]
    data = MasterSession("127.0.0.1", master["port"])
    data.token = handle["token"]
    shipper = tcore.LogShipperHandler(data, handle["allocation_id"],
                                      flush_interval=60, max_batch=3)
    log = logging.getLogger("shipper-test")
    log.addHandler(shipper)
    try:
        for i in range(5):
            log.warning("shipped %d", i)
    finally:
        log.removeHandler(shipper)
        shipper.close()
    lines = [r["log"] for r in session.task_logs(handle["allocation_id"])]
    assert [f"shipped {i}" for i in range(5)] == [
        x for x in lines if x.startswith("shipped")]
    from determined_clone_tpu_torch.exec.launch import free_port

    dead = MasterSession("127.0.0.1", free_port(), timeout=1, retries=1)
    gone = tcore.LogShipperHandler(dead, "nowhere", flush_interval=60)
    gone.emit(logging.LogRecord("x", logging.WARNING, __file__, 1, "lost",
                                None, None))
    gone.close()  # the failed post is dropped
