"""The port's goodput ledger (``telemetry/goodput.py``) and its wiring
held against the JAX package's, case for case with
``tests/test_goodput.py``: the same span records, notes and journals go
through both ledgers, a journal written by either package is read and
merged by the other, and a real ``Trainer.fit`` of the port balances its
books as the JAX one does, across a killed leg and its restart too.

Tolerance: categories, snapshots (less their clock readings), merged
accounts and rendered text compare exactly — both ledgers do the same
float arithmetic on the same inputs. Conservation is the ledger's own
1% check.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from determined_clone_tpu_torch import core as tcore  # noqa: E402
from determined_clone_tpu_torch import faults as tfaults  # noqa: E402
from determined_clone_tpu_torch.config import (  # noqa: E402
    ExperimentConfig as TConfig,
)
from determined_clone_tpu_torch.telemetry import goodput as tgoodput  # noqa: E402
from determined_clone_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402
from determined_clone_tpu_torch.telemetry import (  # noqa: E402
    telemetry_from_config as t_telemetry_from_config,
)
from determined_clone_tpu_torch.training import Trainer as TTrainer  # noqa: E402
from determined_clone_tpu_torch.training import TorchTrial  # noqa: E402
from determined_clone_tpu_torch.training import (  # noqa: E402
    TrialContext as TContext,
)
from determined_clone_tpu_torch.training import optim  # noqa: E402

if __name__ != "__main__":  # a restart leg run as a script imports no JAX
    from determined_clone_tpu import faults as jfaults
    from determined_clone_tpu.telemetry import goodput as jgoodput
    from determined_clone_tpu.telemetry import metrics as jmetrics
    from determined_clone_tpu.telemetry import (
        telemetry_from_config as j_telemetry_from_config,
    )

    # (ledger module, metrics module, faults module, telemetry_from_config)
    PKGS = {"jax": (jgoodput, jmetrics, jfaults, j_telemetry_from_config),
            "port": (tgoodput, tmetrics, tfaults,
                     t_telemetry_from_config)}
torch.set_num_threads(1)

@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in ("DCT_FAULT_PLAN", "DCT_GOODPUT_DIR", "DCT_QUEUE_WAIT_S",
                "DCT_TELEMETRY_DISABLED", "DCT_OBSERVABILITY",
                "DCT_FLIGHT_DIR", "DCT_TRACE_ID"):
        monkeypatch.delenv(var, raising=False)
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


def span(name, dur_s, *, depth=0, tid=0, **args):
    return {"name": name, "ts_us": 0.0, "dur_us": dur_s * 1e6,
            "tid": tid, "tname": "consumer", "depth": depth, "args": args}


def instant(name, **args):
    return {"name": name, "ph": "i", "ts_us": 0.0, "dur_us": 0.0,
            "tid": 0, "tname": "consumer", "depth": 1, "args": args}


def attributed(snap):
    """The categories less the clock's remainder."""
    return {k: v for k, v in snap["categories"].items()
            if k != "unattributed"}


def both(fn):
    """``fn(goodput, metrics, faults, telemetry_from_config)`` for each
    package: (the JAX result, the port's)."""
    return fn(*PKGS["jax"]), fn(*PKGS["port"])


def test_categories_and_span_map_are_jax_s():
    assert tgoodput.CATEGORIES == jgoodput.CATEGORIES
    assert tgoodput.RESTART_CATEGORIES == jgoodput.RESTART_CATEGORIES
    assert tgoodput.SPAN_CATEGORIES == jgoodput.SPAN_CATEGORIES
    assert tgoodput.GOODPUT_RE.pattern == jgoodput.GOODPUT_RE.pattern


# -- ledger unit behaviour ------------------------------------------------

def test_span_bucketing_and_conservation():
    def run(g, *_):
        led = g.GoodputLedger(trial_id=3)
        for rec in (span("train_dispatch", 0.5, step=1),
                    span("dataload_wait", 0.2), span("host_sync", 0.1),
                    span("validate", 0.3), span("checkpoint_save", 0.4),
                    span("eval_dispatch", 9.0, depth=1),
                    span("storage_upload", 9.0, depth=1),
                    span("produce_batch", 9.0, tid=1)):
            led.observe_span(rec)
        snap = led.snapshot()
        return (attributed(snap), snap["overcount_s"] > 0,
                g.check_conservation(snap)["ok"], set(snap["categories"]))

    j, t = both(run)
    assert t == j
    assert t[0]["productive"] == pytest.approx(0.5)
    assert t[1] and not t[2]


def test_unattributed_is_the_remainder_and_books_balance():
    def run(g, *_):
        led = g.GoodputLedger()
        time.sleep(0.05)
        led.observe_span(span("train_dispatch", 0.01))
        snap = led.snapshot()
        res = g.check_conservation(snap)
        return (attributed(snap), snap["categories"]["unattributed"] > 0,
                sum(snap["categories"].values())
                == pytest.approx(snap["wall_s"], rel=1e-6),
                res["ok"] and res["error_fraction"] < 0.01)

    j, t = both(run)
    assert t == j == ({**dict.fromkeys(attributed(
        {"categories": dict.fromkeys(jgoodput.CATEGORIES, 0.0)}), 0.0),
        "productive": 0.01}, True, True, True)


@pytest.mark.parametrize("records", [
    # a compiled dispatch and its same-interval xla_compile are one
    # interval; the explicit capture counts directly
    [span("train_dispatch", 0.8, compiled=True), span("xla_compile", 0.8),
     span("xla_compile", 0.3, explicit=True)],
    # the straggler's overhang moves out of productive; malformed and
    # non-positive instants are ignored
    [span("train_dispatch", 0.10), span("train_dispatch", 0.55),
     instant("step_time_anomaly", duration_s=0.55, median_s=0.10, step=2),
     instant("step_time_anomaly", duration_s=0.05, median_s=0.10),
     instant("step_time_anomaly", duration_s="nan?")],
    # overhang clamps to the productive time there is
    [span("train_dispatch", 0.1),
     instant("step_time_anomaly", duration_s=5.0, median_s=0.5)],
], ids=["compile_dedupe", "anomaly_overhang", "anomaly_clamp"])
def test_ledger_scripts_match_jax(records):
    def run(g, *_):
        led = g.GoodputLedger()
        for rec in records:
            led.observe_span(rec)
        return attributed(led.snapshot())

    j, t = both(run)
    assert t == j


def test_note_validates_category_and_pre_wall_extends_wall():
    def run(g, *_):
        led = g.GoodputLedger()
        errors = []
        for cat in ("coffee_break", "unattributed"):
            with pytest.raises(ValueError) as e:
                led.note(cat, 1.0)
            errors.append(str(e.value))
        before = led.snapshot()["wall_epoch_start"]
        led.note("queue_wait", 2.5, pre_wall=True)
        snap = led.snapshot()
        return (errors, attributed(snap), snap["wall_s"] > 2.5,
                snap["wall_epoch_start"] == pytest.approx(before - 2.5,
                                                          abs=0.05),
                g.check_conservation(snap)["ok"])

    j, t = both(run)
    assert t == j
    assert t[1]["queue_wait"] == 2.5 and all(t[2:])


def test_publish_metrics_lands_the_same_families():
    def run(g, m, *_):
        reg = m.MetricsRegistry()
        led = g.GoodputLedger(registry=reg, trial_id=9)
        led.observe_span(span("train_dispatch", 0.01))
        snap = led.publish_metrics()
        samples = m.parse_prometheus_text(reg.dump())["samples"]
        return (sorted((n, sorted(lb.items())) for n, lb, _ in samples),
                snap["trial_id"])

    j, t = both(run)
    assert t == j
    assert ("goodput_seconds_total", [("category", "productive")]) in t[0]


# -- journals: each package reads and merges the other's -------------------

@pytest.mark.parametrize("writer,reader", [
    ("jax", "port"), ("port", "jax"), ("port", "port")])
def test_journal_written_by_one_is_read_by_the_other(tmp_path, writer,
                                                     reader):
    wg, rg = PKGS[writer][0], PKGS[reader][0]
    led = wg.GoodputLedger(trial_id=7)
    led.attach_journal(str(tmp_path))
    led.observe_span(span("train_dispatch", 0.02))
    led.publish_metrics()
    led.observe_span(span("train_dispatch", 0.03))
    led.close()
    assert sorted(os.listdir(tmp_path)) == [
        "goodput-trial00007-leg00001.jsonl"]
    lines = (tmp_path / "goodput-trial00007-leg00001.jsonl"
             ).read_text().splitlines()
    meta = json.loads(lines[0])
    assert (meta["kind"], meta["trial_id"], meta["leg"]) == ("meta", 7, 1)
    recs = list(rg.read_goodput(str(tmp_path)))
    assert len(recs) == 1
    assert recs[0]["categories"]["productive"] == pytest.approx(0.05)
    assert (recs[0]["trial_id"], recs[0]["leg"]) == (7, 1)
    assert rg.merge_goodput(str(tmp_path)) == wg.merge_goodput(
        str(tmp_path))


def test_legs_of_both_packages_number_and_merge_as_one(tmp_path):
    """Restart legs alternate between the packages in one directory:
    each leg resumes the numbering of the other's files, and both merges
    give one account."""
    order = ["jax", "port", "jax"]
    for expected, side in enumerate(order, start=1):
        led = PKGS[side][0].GoodputLedger(trial_id=4)
        led.attach_journal(str(tmp_path))
        led.publish_metrics()
        assert led.journal.leg == expected
        led.close()
    other = tgoodput.GoodputLedger(trial_id=5)
    other.attach_journal(str(tmp_path))
    other.publish_metrics()
    assert other.journal.leg == 1
    other.close()
    legs = [sorted((r["trial_id"], r["leg"]) for r in g.read_goodput(
        str(tmp_path))) for g in (jgoodput, tgoodput)]
    assert legs[0] == legs[1] == [(4, 1), (4, 2), (4, 3), (5, 1)]
    assert tgoodput.merge_goodput(str(tmp_path)) == jgoodput.merge_goodput(
        str(tmp_path))


def test_reader_tolerates_torn_final_line(tmp_path):
    led = tgoodput.GoodputLedger(trial_id=2)
    led.attach_journal(str(tmp_path))
    led.observe_span(span("train_dispatch", 0.04))
    led.publish_metrics()
    led.close()
    with open(tmp_path / "goodput-trial00002-leg00001.jsonl", "a") as f:
        f.write('{"kind": "goodput", "wall_s": 99.0, "catego')  # mid-crash
    got = [list(g.read_goodput(str(tmp_path))) for g in (jgoodput, tgoodput)]
    assert got[0] == got[1]
    assert len(got[1]) == 1 and got[1][0]["wall_s"] != 99.0


def test_journal_write_fault_drops_and_counts(tmp_path):
    def run(g, m, f, _):
        reg = m.MetricsRegistry()
        led = g.GoodputLedger(registry=reg, trial_id=1)
        d = tmp_path / g.__name__.split(".")[0]
        led.attach_journal(str(d))
        with f.plan_active({"rules": [
                {"point": "goodput.write", "nth": 1, "times": 1}]}):
            led.publish_metrics()   # injected write error: dropped
            led.publish_metrics()   # plan exhausted: lands
        return (led.journal.records_dropped,
                reg.counter("goodput_records_dropped").value,
                len(list(g.read_goodput(str(d)))))

    j, t = both(run)
    assert t == j == (1, 1, 1)


def hand_leg(trial, leg, start, wall, **cats):
    categories = {c: 0.0 for c in tgoodput.CATEGORIES}
    categories.update(cats)
    categories["unattributed"] = max(
        0.0, wall - sum(v for k, v in categories.items()
                        if k != "unattributed"))
    return {"kind": "goodput", "trial_id": trial, "leg": leg,
            "wall_s": wall, "wall_epoch_start": start,
            "wall_epoch": start + wall, "categories": categories,
            "overcount_s": 0.0,
            "goodput_fraction": categories["productive"] / wall}


def write_leg(directory, rec):
    path = os.path.join(directory, f"goodput-trial{rec['trial_id']:05d}"
                                   f"-leg{rec['leg']:05d}.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "meta"}) + "\n")
        f.write(json.dumps(rec) + "\n")


@pytest.mark.parametrize("legs,trial", [
    # leg 1 0→10 s, a 6 s gap, leg 2 16→46 s: the gap is restart badput
    ([hand_leg(7, 1, 1000.0, 10.0, productive=8.0, compile=1.0),
      hand_leg(7, 2, 1016.0, 30.0, productive=24.0, restore_replay=3.0)],
     7),
    # a cooked leg (overcount) is flagged; clock skew clamps the gap to 0
    ([dict(hand_leg(3, 1, 1000.0, 5.0, productive=4.0),
           categories={**hand_leg(3, 1, 1000.0, 5.0)["categories"],
                       "productive": 9.0}),
      hand_leg(3, 2, 1003.0, 5.0, productive=4.0)], 3),
], ids=["inter_leg_gap", "violated_and_skewed"])
def test_merge_and_format_match_jax(tmp_path, legs, trial):
    for rec in legs:
        write_leg(str(tmp_path), rec)
    merged = tgoodput.merge_goodput(str(tmp_path))
    assert merged == jgoodput.merge_goodput(str(tmp_path))
    assert tgoodput.format_goodput(merged) == jgoodput.format_goodput(merged)
    acct = merged[trial]
    if trial == 7:
        assert acct["wall_s"] == pytest.approx(46.0)
        assert acct["categories"]["restart_backoff"] == pytest.approx(6.0)
        assert acct["conservation_ok"]
    else:
        assert not acct["conservation_ok"]
        assert acct["categories"]["restart_backoff"] == 0.0


# -- wiring: telemetry_from_config and its environment switches ------------

def obs_config(**extra):
    return {"observability": {"enabled": True, **extra}}


def test_telemetry_wires_ledger_as_tracer_sink():
    def run(*pkg):
        tel = pkg[3](obs_config())
        try:
            with tel.tracer.span("train_dispatch", step=1):
                time.sleep(0.01)
            return tel.goodput.snapshot()["categories"]["productive"] > 0
        finally:
            tel.close()

    assert both(run) == (True, True)


def test_goodput_dir_env_force_enables_and_journals(tmp_path, monkeypatch):
    for side in ("jax", "port"):
        d = tmp_path / side
        monkeypatch.setenv("DCT_GOODPUT_DIR", str(d))
        tel = PKGS[side][3]({})  # observability NOT enabled in the config
        assert tel is not None and tel.goodput is not None
        tel.goodput.set_identity(trial_id=11)
        tel.publish(None, 4)
        tel.close()
    # each reads the other's
    assert [r["trial_id"] for r in jgoodput.read_goodput(
        str(tmp_path / "port"))] == [11]
    assert [r["trial_id"] for r in tgoodput.read_goodput(
        str(tmp_path / "jax"))] == [11]


@pytest.mark.parametrize("value,booked", [("1.75", 1.75), ("soon", 0.0)])
def test_queue_wait_env_contract(monkeypatch, value, booked):
    monkeypatch.setenv("DCT_QUEUE_WAIT_S", value)

    def run(*pkg):
        tel = pkg[3](obs_config())
        try:
            snap = tel.goodput.snapshot()
            return (snap["categories"]["queue_wait"], snap["wall_s"] > booked,
                    pkg[0].check_conservation(snap)["ok"])
        finally:
            tel.close()

    assert both(run) == ((booked, True, True),) * 2


def test_telemetry_disabled_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("DCT_TELEMETRY_DISABLED", "1")
    monkeypatch.setenv("DCT_GOODPUT_DIR", str(tmp_path))  # loses
    assert both(lambda *pkg: pkg[3](obs_config())) == (None, None)


def test_aggregator_rollup_of_port_ledgers_equals_jax_s():
    """The aggregator (the JAX package's, and the port's byte-equal
    copy) rolls up the port ledger's shipped gauges as it rolls up the
    JAX ledger's: time-weighted, 91/110."""
    from determined_clone_tpu.telemetry.aggregate import (
        ClusterMetricsAggregator as JAgg,
    )
    from determined_clone_tpu_torch.telemetry.aggregate import (
        ClusterMetricsAggregator as TAgg,
    )

    def ship(agg, g, m, trial_id, productive, wall, experiment_id,
             **extra):
        reg = m.MetricsRegistry()
        led = g.GoodputLedger(registry=reg, trial_id=trial_id)
        led.note("productive", productive)
        for cat, secs in extra.items():
            led.note(cat, secs)
        led.publish_metrics()
        reg.gauge("goodput_wall_seconds", "").set(wall)
        reg.gauge("goodput_fraction", "").set(productive / wall)
        agg.ingest(trial_id, [{"time": 1.0, "group": "telemetry",
                               "metrics": reg.snapshot()}],
                   experiment_id=experiment_id)

    rolls = []
    for agg_cls, (g, m) in ((JAgg, (jgoodput, jmetrics)),
                            (JAgg, (tgoodput, tmetrics)),
                            (TAgg, (tgoodput, tmetrics))):
        agg = agg_cls()
        ship(agg, g, m, 1, 90.0, 100.0, 5, checkpoint_save=5.0)
        ship(agg, g, m, 2, 1.0, 10.0, 6)
        rolls.append(agg.goodput_rollup())
    assert rolls[0] == rolls[1] == rolls[2]
    assert rolls[1]["cluster_fraction"] == pytest.approx(91.0 / 110.0)


def test_jax_goodput_command_reads_a_port_journal(tmp_path, capsys):
    """The port has no ``goodput`` command or master route; the JAX
    package's ``dct goodput --dir`` renders a journal the port wrote."""
    from determined_clone_tpu.cli.cli import main as cli_main

    led = tgoodput.GoodputLedger(trial_id=1)
    led.attach_journal(str(tmp_path))
    time.sleep(0.03)
    led.observe_span(span("train_dispatch", 0.02))
    led.close()
    assert cli_main(["goodput", "--dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "trial 1" in out and "productive" in out
    assert out.strip() == tgoodput.format_goodput(
        tgoodput.merge_goodput(str(tmp_path)))
    assert cli_main(["goodput", "--dir", str(tmp_path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["1"]["conservation_ok"]


# -- end to end: the port's Trainer balances its books -----------------------

class DriftTrial(TorchTrial):
    """The JAX goodput suite's drift trial: the loss depends on the
    batch, so a replay mistake would change the result."""

    n_batches = 24

    def initial_params(self, gen):
        return {"w": torch.zeros((), device=self.context.device)}

    def optimizer(self):
        return optim.sgd(0.05)

    def loss(self, params, batch, seed):
        loss = (params["w"] - batch.float().mean()) ** 2
        return loss, {"w": params["w"].detach()}

    def training_data(self):
        for i in range(self.n_batches):
            yield np.full((4, 1), float(i % 7), np.float32)

    def validation_data(self):
        return [np.ones((4, 1), np.float32)]

    @property
    def global_batch_size(self):
        return 4


def drift_config(storage, batches=24, **obs):
    return {"searcher": {"name": "single", "metric": "loss",
                         "max_length": {"batches": batches}},
            "scheduling_unit": 4, "min_checkpoint_period": {"batches": 8},
            "checkpoint_storage": {"type": "shared_fs",
                                   "host_path": str(storage)},
            "optimizations": {"prefetch_depth": 0},
            "observability": {"enabled": True, **obs}}


def test_real_trainer_run_conserves_wall_clock(tmp_path):
    """A port ``Trainer.fit`` balances within 1%, books its three saves
    and no restart, and its ledger's wall lies inside a stopwatch's."""
    cfg = TConfig.from_dict(drift_config(tmp_path))
    t0 = time.perf_counter()
    with tcore.init(config=cfg, trial_id=1) as ctx:
        trial = DriftTrial(TContext(config=cfg, hparams={}, core=ctx,
                                    device="cpu"))
        result = TTrainer(trial).fit()
        snap = ctx.telemetry.goodput.snapshot()
    external_wall = time.perf_counter() - t0
    assert result["batches_trained"] == 24
    res = tgoodput.check_conservation(snap)
    assert res["ok"], res
    assert snap["overcount_s"] == 0.0
    assert snap["goodput_fraction"] > 0
    assert snap["wall_s"] <= external_wall + 0.01
    cats = snap["categories"]
    assert cats["productive"] > 0 and cats["compile"] > 0
    assert cats["checkpoint_save"] > 0      # batches 8/16/24 committed
    assert cats["restart_backoff"] == 0.0 and cats["restore_replay"] == 0.0


def worker_leg(storage):
    """One restart leg of the drift trial (run as a script, no JAX)."""
    torch.set_num_threads(1)
    latest = os.environ.get("DCT_RESUME_FROM") or None
    cfg = TConfig.from_dict(drift_config(storage))
    with tcore.init(config=cfg, trial_id=1) as ctx:
        trial = DriftTrial(TContext(config=cfg, hparams={}, core=ctx,
                                    device="cpu"))
        result = TTrainer(trial).fit(latest_checkpoint=latest)
    print("COMPLETED", result["batches_trained"])


def test_killed_leg_and_restart_merge_into_restart_badput(tmp_path):
    """The JAX chaos case on the port: leg 1 is killed (a fault plan's
    ``exit`` at step 13, after the batch-8 checkpoint and its journal
    line), leg 2 resumes from that checkpoint. Both packages merge the
    two journals into one balanced account whose restart shows up as
    restart badput, and leg 2 replays from batch 8."""
    storage, goodput_dir = tmp_path / "ckpts", tmp_path / "goodput"
    storage.mkdir()
    leg = [sys.executable, os.path.abspath(__file__), "leg", str(storage)]
    env = {**os.environ, "DCT_GOODPUT_DIR": str(goodput_dir),
           "DCT_FAULT_PLAN": json.dumps({"rules": [
               {"point": "training.pre_step", "action": "exit", "nth": 13,
                "exit_code": 137}]})}
    proc = subprocess.run(leg, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 137, proc.stdout + proc.stderr
    legs = list(tgoodput.read_goodput(str(goodput_dir)))
    assert [r["leg"] for r in legs] == [1]
    assert tgoodput.check_conservation(legs[0])["ok"]

    recs = tcore.LocalCheckpointRegistry(
        str(storage / "checkpoints.jsonl")).list()
    assert [r["metadata"]["steps_completed"] for r in recs] == [8]
    env.pop("DCT_FAULT_PLAN")
    env["DCT_RESUME_FROM"] = recs[0]["storage_id"]
    proc = subprocess.run(leg, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "COMPLETED 24" in proc.stdout

    merged = tgoodput.merge_goodput(str(goodput_dir))
    assert merged == jgoodput.merge_goodput(str(goodput_dir))
    acct = merged[1]
    assert acct["legs"] == 2 and acct["conservation_ok"], acct
    cats = acct["categories"]
    assert sum(cats.values()) == pytest.approx(acct["wall_s"], rel=0.01)
    assert cats["restart_backoff"] > 0       # the dead time between legs
    assert cats["restore_replay"] > 0        # restore + replay of 8
    assert cats["productive"] > 0


if __name__ == "__main__":
    {"leg": worker_leg}[sys.argv[1]](sys.argv[2])
