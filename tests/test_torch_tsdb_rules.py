"""The port's time-series store, alert rules, the in-process master's
time-series routes, the observability commands over them and
``TimeSeriesSignals``, held against the JAX package's.

One case for each test of ``tests/test_tsdb_rules.py``: its scenario is
written once against a namespace of either package's classes, so the
same samples and the same injected clock go through both. A scenario
asserts what the JAX test asserts and returns what it saw at every step
(query payloads, ``stats()``, rule states tick by tick, routes' codes
and bodies, the CLI's output, the autoscaler's decisions); the case
holds the port's record equal to the JAX package's. The tolerance is
none: both are the same pure-Python arithmetic in the same order, so
every float is compared exactly.

Beyond those: segments written by one package replay in the other, the
CLI's ``query``/``alerts``/``top`` print the same against one master of
either package, and a bad ``observability.rules`` entry fails the
port's ``ExperimentConfig`` with the JAX one's message, now that both
validate it with their own ``telemetry/rules.py``.
"""
import json
import os
import time
import types

import pytest

from determined_clone_tpu.api import inprocess as jinproc
from determined_clone_tpu.cli import cli as jcli
from determined_clone_tpu.config import ExperimentConfig as JConfig
from determined_clone_tpu.serving import autoscale as jautoscale
from determined_clone_tpu.telemetry import aggregate as jaggregate
from determined_clone_tpu.telemetry import rules as jrules
from determined_clone_tpu.telemetry import slo as jslo
from determined_clone_tpu.telemetry import tsdb as jtsdb
from determined_clone_tpu_torch import cli as tcli
from determined_clone_tpu_torch.api import inprocess as tinproc
from determined_clone_tpu_torch.config import ExperimentConfig as TConfig
from determined_clone_tpu_torch.serving import autoscale as tautoscale
from determined_clone_tpu_torch.telemetry import aggregate as taggregate
from determined_clone_tpu_torch.telemetry import rules as trules
from determined_clone_tpu_torch.telemetry import slo as tslo
from determined_clone_tpu_torch.telemetry import tsdb as ttsdb


def _ns(inproc, cli, autoscale, aggregate, rules, slo, tsdb):
    return types.SimpleNamespace(
        InProcessMaster=inproc.InProcessMaster,
        MasterHTTPServer=inproc.MasterHTTPServer, main=cli.main,
        AutoscalePolicy=autoscale.AutoscalePolicy,
        Autoscaler=autoscale.Autoscaler,
        TimeSeriesSignals=autoscale.TimeSeriesSignals,
        ClusterMetricsAggregator=aggregate.ClusterMetricsAggregator,
        AlertRule=rules.AlertRule, RuleEngine=rules.RuleEngine,
        format_alerts=rules.format_alerts,
        stock_slo_rules=rules.stock_slo_rules, SLOEngine=slo.SLOEngine,
        TimeSeriesDB=tsdb.TimeSeriesDB)


PKGS = {
    "jax": _ns(jinproc, jcli, jautoscale, jaggregate, jrules, jslo, jtsdb),
    "port": _ns(tinproc, tcli, tautoscale, taggregate, trules, tslo, ttsdb),
}

T0 = 1_000_000.0  # simulated wall-clock origin; nothing reads time.time

REPLICA_TEXT = """# TYPE serving_queue_depth gauge
serving_queue_depth {queue}
# TYPE serving_tokens_per_sec gauge
serving_tokens_per_sec 120
# TYPE serving_requests_completed_total counter
serving_requests_completed_total {completed}
"""


def sim_clock(start=T0):
    state = {"t": start}

    def clock():
        return state["t"]

    return state, clock


def make_tsdb(ns, **kw):
    state, clock = sim_clock()
    kw.setdefault("clock", clock)
    return state, ns.TimeSeriesDB(**kw)


def no_wall(obj):
    """``obj`` without the ``time_wall`` stamps (``RuleEngine.alerts``
    reads the wall clock; everything else rides the injected one)."""
    if isinstance(obj, dict):
        return {k: no_wall(v) for k, v in obj.items() if k != "time_wall"}
    if isinstance(obj, (list, tuple)):
        return [no_wall(v) for v in obj]
    if isinstance(obj, str) and obj.lstrip().startswith("{"):
        try:
            return no_wall(json.loads(obj))
        except ValueError:
            return obj
    return obj


def approx(x, want, rel=1e-6):
    return x == pytest.approx(want, rel=rel)


# -- storage + query ---------------------------------------------------------

def sc_record_and_windowed_query(ns, tmp):
    state, db = make_tsdb(ns)
    for i in range(10):
        db.record("q_depth", float(i), t=T0 + 5.0 * i)
    state["t"] = T0 + 45.0
    out = [db.query("q_depth", window_s=20.0, reduce=r)
           for r in ("raw", "avg", "max", "last")]
    assert out[0]["series"][0]["samples"] == [
        [T0 + 30.0, 6.0], [T0 + 35.0, 7.0],
        [T0 + 40.0, 8.0], [T0 + 45.0, 9.0]]
    assert [o["series"][0].get("value") for o in out[1:]] == [7.5, 9.0, 9.0]
    with pytest.raises(ValueError) as err:
        db.query("q_depth", reduce="median")
    return out + [str(err.value), db.stats()]


def sc_label_subset_matching(ns, tmp):
    _, db = make_tsdb(ns)
    db.record("lat", 1.0, labels={"component": "r0", "quantile": "0.99"},
              t=T0)
    db.record("lat", 2.0, labels={"component": "r1", "quantile": "0.99"},
              t=T0)
    db.record("lat", 9.0, labels={"component": "r0", "quantile": "0.5"},
              t=T0)
    res = db.query("lat", {"quantile": "0.99"}, window_s=60.0,
                   reduce="last", now=T0)
    assert sorted(s["labels"]["component"] for s in res["series"]) == \
        ["r0", "r1"]
    only = db.query("lat", {"component": "r0", "quantile": "0.99"},
                    window_s=60.0, reduce="last", now=T0)
    assert [s["value"] for s in only["series"]] == [1.0]
    return [res, only, db.stats()]


def sc_rate_tolerates_counter_reset(ns, tmp):
    _, db = make_tsdb(ns)
    for i, v in enumerate([100.0, 150.0, 30.0]):
        db.record("steps_total", v, kind="counter", t=T0 + 10.0 * i)
    inc = db.query("steps_total", window_s=60.0, reduce="increase",
                   now=T0 + 20.0)
    rate = db.query("steps_total", window_s=60.0, reduce="rate",
                    now=T0 + 20.0)
    assert approx(inc["series"][0]["value"], 80.0)
    assert approx(rate["series"][0]["value"], 80.0 / 20.0)
    db.record("lone_total", 5.0, kind="counter", t=T0)
    lone = db.query("lone_total", window_s=60.0, reduce="rate", now=T0)
    assert lone["series"][0]["value"] is None
    return [inc, rate, lone]


def sc_staircase_keeps_long_windows_answerable(ns, tmp):
    _, db = make_tsdb(ns, capacity_per_series=10, coarse_step_s=60.0)
    for i in range(100):
        db.record("work_total", 7.0 * i, kind="counter", t=T0 + 10.0 * i)
    now = T0 + 990.0
    inc = db.query("work_total", window_s=900.0, reduce="increase",
                   now=now)
    raw = db.query("work_total", window_s=900.0, reduce="raw", now=now)
    samples = raw["series"][0]["samples"]
    assert inc["series"][0]["n"] > 10 and samples == sorted(samples)
    assert inc["series"][0]["value"] == samples[-1][1] - samples[0][1]
    _, db2 = make_tsdb(ns, capacity_per_series=10, coarse_step_s=60.0)
    for i in range(100):
        db2.record("g", 10.0, t=T0 + 10.0 * i)
    avg = db2.query("g", window_s=900.0, reduce="avg", now=now)
    assert approx(avg["series"][0]["value"], 10.0)
    return [inc, raw, avg, db.stats(), db2.stats()]


def sc_memory_budget_evicts_stalest_series_under_soak(ns, tmp):
    state, db = make_tsdb(ns, capacity_per_series=50,
                          memory_budget_bytes=40_000)
    trace = []
    for tick in range(400):
        state["t"] = T0 + 5.0 * tick
        for s in range(40):
            if tick > 100 and s < 20:
                continue
            db.record(f"metric_{s}", float(tick))
        if tick % 50 == 0:
            trace.append((db.series_names(), db.stats()))
    stats = db.stats()
    assert stats["within_budget"], stats
    assert stats["bytes_estimate"] <= stats["memory_budget_bytes"]
    assert stats["series_evicted_total"] > 0
    names = db.series_names()
    assert all(int(n.split("_")[1]) >= 20 for n in names), names
    assert stats["top_series_bytes"]
    return trace + [names, stats]


def sc_max_series_cap_evicts(ns, tmp):
    _, db = make_tsdb(ns, max_series=5)
    for s in range(8):
        db.record(f"m{s}", 1.0, t=T0 + s)
    assert len(db.series_names()) == 5 and "m7" in db.series_names()
    return [db.series_names(), db.stats()]


def sc_from_dict_reads_config_units(ns, tmp):
    db = ns.TimeSeriesDB.from_dict({"memory_budget_mb": 2,
                                    "capacity_per_series": 16})
    assert db.memory_budget_bytes == 2 * 1024 * 1024
    assert db.capacity_per_series == 16
    with pytest.raises(ValueError) as err:
        ns.TimeSeriesDB(capacity_per_series=1)
    return [db.memory_budget_bytes, db.capacity_per_series, str(err.value)]


# -- persistence -------------------------------------------------------------

def write_segments(ns, d, clock_state, clock, n=7, **kw):
    db = ns.TimeSeriesDB(persist_dir=d, clock=clock, **kw)
    stored = []
    for i in range(n):
        clock_state["t"] = T0 + 5.0 * i
        stored.append(db.scrape_text("# TYPE steps_total counter\n"
                                     f"steps_total {10 * i}\n"
                                     "# TYPE q gauge\n"
                                     f"q {i}\n"))
    db.close()
    return stored


def replay(ns, d, clock_state, clock):
    db = ns.TimeSeriesDB(persist_dir=d, clock=clock)
    clock_state["t"] = T0 + 30.0
    out = [db.query("steps_total", window_s=3600.0, reduce="increase"),
           db.query("q", window_s=3600.0, reduce="last"), db.series_names()]
    db.close()
    return out


def sc_segments_replay_after_restart(ns, tmp):
    d = os.path.join(tmp, "tsdb")
    state, clock = sim_clock()
    stored = write_segments(ns, d, state, clock, segment_scrapes=3)
    assert stored == [2] * 7
    segs = sorted(p for p in os.listdir(d) if p.endswith(".jsonl"))
    assert len(segs) >= 2
    with open(os.path.join(d, segs[-1]), "a") as f:
        f.write('{"t": 123, "samples": [["x", {}')
    out = replay(ns, d, state, clock)
    assert approx(out[0]["series"][0]["value"], 60.0)
    assert out[1]["series"][0]["value"] == 6.0
    db3 = ns.TimeSeriesDB(persist_dir=d, replay=False, clock=clock)
    assert db3.series_names() == []
    db3.close()
    return [stored, segs, out]


def sc_segment_ring_bounds_disk(ns, tmp):
    d = os.path.join(tmp, "ring")
    state, clock = sim_clock()
    db = ns.TimeSeriesDB(persist_dir=d, segment_scrapes=2, max_segments=3,
                         clock=clock)
    for i in range(20):
        state["t"] = T0 + 5.0 * i
        db.scrape_text(f"g {i}\n")
    db.close()
    segs = sorted(p for p in os.listdir(d) if p.endswith(".jsonl"))
    assert len(segs) <= 3
    return [segs]


# -- scrape freshness --------------------------------------------------------

def sc_scrape_skips_sources_that_did_not_reingest(ns, tmp):
    state, clock = sim_clock()
    agg = ns.ClusterMetricsAggregator(clock=clock)
    db = ns.TimeSeriesDB(clock=clock)
    agg.ingest_prometheus_text("serving_replica_r0",
                               REPLICA_TEXT.format(queue=3, completed=10))
    seen = [db.scrape(agg)]
    for tick in range(1, 5):
        state["t"] = T0 + 5.0 * tick
        seen.append(db.scrape(agg))
    q = db.query("serving_queue_depth", window_s=3600.0, reduce="raw")
    fleet = db.query("dct_fleet_queue_depth", window_s=3600.0, reduce="raw")
    assert len(q["series"][0]["samples"]) == 1
    assert len(fleet["series"][0]["samples"]) == 5
    state["t"] = T0 + 25.0
    agg.ingest_prometheus_text("serving_replica_r0",
                               REPLICA_TEXT.format(queue=4, completed=20))
    seen.append(db.scrape(agg))
    q2 = db.query("serving_queue_depth", window_s=3600.0, reduce="raw")
    samples = q2["series"][0]["samples"]
    assert len(samples) == 2 and samples[-1][1] == 4.0
    return [seen, q, fleet, q2, db.stats()]


# -- rules -------------------------------------------------------------------

def sc_threshold_rule_state_machine_with_hold_down(ns, tmp):
    state, db = make_tsdb(ns)
    rule = ns.AlertRule("deep", "threshold", series="q", window_s=30.0,
                        reduce="avg", op="gt", value=4.0, for_s=10.0)
    engine = ns.RuleEngine([rule], clock=db._clock)
    snaps = []

    def tick(value):
        db.record("q", value)
        snap = engine.evaluate(db)[0]
        snaps.append(snap)
        state["t"] += 5.0
        return snap["state"]

    states = [tick(1.0), tick(9.0), tick(9.0), tick(9.0)]
    assert states == ["inactive", "pending", "pending", "firing"]
    assert "q avg=" in rule.detail
    states += [tick(0.0), tick(0.0)]
    state["t"] += 30.0
    states += [tick(0.0), tick(0.0)]
    assert states[4:] == ["firing", "firing", "resolved", "inactive"]
    instant = ns.AlertRule("now", "threshold", series="q", window_s=10.0,
                           reduce="last", op="gt", value=5.0)
    db.record("q", 9.0)
    last = instant.evaluate(db, state["t"])
    assert last["state"] == "firing"
    return [snaps, last, engine.alerts()]


def sc_rate_of_change_rule(ns, tmp):
    state, db = make_tsdb(ns)
    rule = ns.AlertRule("hot", "rate_of_change", series="err_total",
                        window_s=60.0, op="gt", value=1.0)
    for i in range(4):
        db.record("err_total", 2.0 * i, kind="counter", t=T0 + 5.0 * i)
    state["t"] = T0 + 15.0
    first = rule.evaluate(db, state["t"])
    for i in range(4, 8):
        db.record("err_total", 8.0 + 50.0 * (i - 3), kind="counter",
                  t=T0 + 5.0 * i)
    state["t"] = T0 + 35.0
    second = rule.evaluate(db, state["t"])
    assert (first["state"], second["state"]) == ("inactive", "firing")
    return [first, second]


def sc_absence_rule_fires_on_missing_and_stale(ns, tmp):
    state, db = make_tsdb(ns)
    rule = ns.AlertRule("gone", "absence", series="hb",
                        labels={"component": "r0"}, stale_s=20.0,
                        severity="page")
    snaps = [rule.evaluate(db, T0)]
    assert snaps[0]["state"] == "firing" and "absent" in snaps[0]["detail"]
    db.record("hb", 1.0, labels={"component": "r0"})
    snaps += [rule.evaluate(db, state["t"]), rule.evaluate(db, state["t"])]
    state["t"] = T0 + 50.0
    snaps.append(rule.evaluate(db, state["t"]))
    assert [s["state"] for s in snaps] == ["firing", "resolved", "inactive",
                                           "firing"]
    assert 'hb{component="r0"}' in snaps[-1]["detail"]
    return snaps


def sc_burn_rate_counter_pair_needs_every_window(ns, tmp):
    state, db = make_tsdb(ns)
    rule = ns.AlertRule("err-burn", "burn_rate",
                        bad_series="bad_total", total_series="all_total",
                        windows=[60.0, 600.0], threshold=2.0, objective=0.9)
    for i in range(121):
        t = T0 + 5.0 * i
        db.record("bad_total", 5.0 * i, kind="counter", t=t)
        db.record("all_total", 10.0 * i, kind="counter", t=t)
    state["t"] = T0 + 600.0
    first = rule.evaluate(db, state["t"])
    assert first["state"] == "firing" and "burning" in first["detail"]
    for i in range(121, 145):
        t = T0 + 5.0 * i
        db.record("bad_total", 600.0, kind="counter", t=t)
        db.record("all_total", 10.0 * i, kind="counter", t=t)
    state["t"] = T0 + 720.0
    second = rule.evaluate(db, state["t"])
    assert second["state"] == "resolved" and "60" in second["detail"]
    return [first, second]


def sc_stock_slo_rules_reproduce_fast_burn_from_stored_series(ns, tmp):
    state, clock = sim_clock()
    master = ns.InProcessMaster(clock=clock)
    master.enable_timeseries({"stock_slo_rules": True})
    slo = ns.SLOEngine(availability_objective=0.999, clock=clock)
    fast, slow = ns.stock_slo_rules(objective="availability")
    master.rules.add(fast)
    master.rules.add(slow)
    slo.record_request(ok=False, n=20, t=T0)
    slo.record_request(ok=True, n=980, t=T0)
    slo.record_request(ok=True, n=100_000, t=T0 - 1800.0)
    slo.publish(master.aggregator.registry)
    ticks = [master.scrape_tick()]
    assert fast.state == "inactive"
    state["t"] = T0 + 5.0
    for tick in range(12):
        slo.record_request(ok=False, n=5000, t=T0 - tick * 300.0)
    slo.publish(master.aggregator.registry)
    ticks.append(master.scrape_tick())
    verdict = slo.evaluate(now=state["t"])["verdict"]
    assert verdict == "fast_burn" and fast.state == "firing"
    assert "slo-availability-fast-burn" in master.rules.firing()
    payload = master.rules.alerts()
    text = ns.format_alerts(payload)
    assert "burning" in text
    dump = master.aggregator.registry.dump()
    assert 'dct_alert_firing{rule="slo-availability-fast-burn"' in dump
    master.stop_scraper()
    return [ticks, verdict, payload, text,
            [ln for ln in dump.splitlines() if "dct_alert" in ln]]


def sc_rule_validation_rejects_bad_configs(ns, tmp):
    bad = [lambda: ns.AlertRule("x", "nope"),
           lambda: ns.AlertRule("x", "threshold", series="s"),
           lambda: ns.AlertRule("x", "absence", series="s", stale_s=0.0),
           lambda: ns.AlertRule("x", "burn_rate", windows=["5m"]),
           lambda: ns.AlertRule("x", "burn_rate", bad_series="b",
                                windows=[60.0], threshold=1.0),
           lambda: ns.AlertRule.from_dict({"name": "x", "kind": "threshold",
                                           "series": "s", "value": 1.0,
                                           "bogus": 2}),
           lambda: ns.RuleEngine.from_config([
               {"name": "d", "kind": "absence", "series": "s",
                "stale_s": 5.0},
               {"name": "d", "kind": "absence", "series": "s",
                "stale_s": 5.0}])]
    msgs = []
    for make in bad:
        with pytest.raises(ValueError) as err:
            make()
        msgs.append(str(err.value))
    return msgs


# -- master routes + scraper lifecycle ---------------------------------------

def feed_fleet(master, state, ticks=6):
    """A synthetic two-replica fleet through the aggregator, one scrape
    tick every 5 simulated seconds."""
    out = []
    for tick in range(ticks):
        for r in range(2):
            master.aggregator.ingest_prometheus_text(
                f"serving_replica_r{r}",
                REPLICA_TEXT.format(queue=4 + tick, completed=50 * tick))
        out.append(master.scrape_tick())
        state["t"] += 5.0
    return out


DEEP_RULE = {"name": "deep", "kind": "threshold",
             "series": "dct_fleet_queue_depth", "window_s": 60.0,
             "reduce": "avg", "op": "gt", "value": 5.0}


def sc_master_timeseries_and_alert_routes(ns, tmp):
    state, clock = sim_clock()
    master = ns.InProcessMaster(clock=clock)
    master.enable_timeseries({"timeseries": {"capacity_per_series": 64},
                              "rules": [DEEP_RULE]})
    ticks = feed_fleet(master, state)
    calls = [
        "/api/v1/timeseries",
        "/api/v1/timeseries?name=dct_fleet_requests_completed"
        "&reduce=rate&window=60",
        "/api/v1/timeseries?name=serving_queue_depth"
        "&labels=component%3Dserving_replica_r0&reduce=quantile"
        "&q=0.5&window=600",
        "/api/v1/alerts",
        "/api/v1/timeseries?name=x&reduce=median",
        "/api/v1/timeseries?name=x&labels=oops"]
    got = [master.handle("GET", path, None)[:2] for path in calls]
    assert got[0][0] == 200
    assert "dct_fleet_requests_completed" in got[0][1]["series"]
    assert got[0][1]["stats"]["within_budget"]
    assert approx(got[1][1]["series"][0]["value"], 20.0)
    assert len(got[2][1]["series"]) == 1
    assert approx(got[2][1]["series"][0]["value"], 6.5)
    assert got[3] == (200, got[3][1]) and got[3][1]["firing"] == ["deep"]
    assert [g[0] for g in got[4:]] == [400, 400]
    master.stop_scraper()
    return [ticks, got]


def sc_routes_404_when_not_enabled(ns, tmp):
    master = ns.InProcessMaster()
    got = [master.handle("GET", p, None)[:2]
           for p in ("/api/v1/timeseries", "/api/v1/alerts")]
    assert all(st == 404 and "not enabled" in body["error"]
               for st, body in got)
    return got


def sc_scraper_thread_runs_and_stops(ns, tmp):
    master = ns.InProcessMaster()
    master.enable_timeseries({})
    master.aggregator.ingest_prometheus_text(
        "serving_replica_r0", REPLICA_TEXT.format(queue=1, completed=1))
    master.start_scraper(period_s=0.02)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if master.tsdb.stats()["scrapes_total"] >= 2:
            break
        time.sleep(0.01)
    scrapes = master.tsdb.stats()["scrapes_total"]
    with pytest.raises(RuntimeError) as err:
        master.start_scraper(period_s=0.02)
    master.stop_scraper()  # conftest fails the case if the thread leaks
    assert scrapes >= 2
    # wall-clock scrapes: the count differs run to run, the rest not
    return [scrapes >= 2, str(err.value), sorted(master.tsdb.series_names())]


# -- CLI ---------------------------------------------------------------------

def live_master(ns):
    state, clock = sim_clock()
    master = ns.InProcessMaster(clock=clock)
    master.enable_timeseries({"rules": [DEEP_RULE]})
    feed_fleet(master, state)
    return master


def run_cli(ns, addr, capsys, *argv):
    rc = ns.main(["-m", addr, *argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


def with_live_master(ns, fn):
    master = live_master(ns)
    try:
        with ns.MasterHTTPServer(master, 0) as srv:
            return fn(f"127.0.0.1:{srv.port}")
    finally:
        master.stop_scraper()


def sc_cli_query(ns, tmp, capsys):
    def fn(addr):
        out = [run_cli(ns, addr, capsys, "query"),
               run_cli(ns, addr, capsys, "query",
                       "dct_fleet_requests_completed", "--reduce", "rate",
                       "--window", "60"),
               run_cli(ns, addr, capsys, "query", "dct_fleet_queue_depth",
                       "--reduce", "last", "--json"),
               run_cli(ns, addr, capsys, "query", "no_such_series")]
        assert out[0][0] == 0 and "dct_fleet_queue_depth" in out[0][1]
        assert "rate over 60s: 20" in out[1][1]
        assert json.loads(out[2][1])["series"][0]["value"] == 18.0
        assert out[3][0] == 1
        return out
    return with_live_master(ns, fn)


def sc_cli_alerts(ns, tmp, capsys):
    def fn(addr):
        out = [run_cli(ns, addr, capsys, "alerts"),
               run_cli(ns, addr, capsys, "alerts", "--json")]
        assert out[0][0] == 0 and "1 firing" in out[0][1]
        assert json.loads(out[1][1])["firing"] == ["deep"]
        return out
    return with_live_master(ns, fn)


def sc_cli_top_once(ns, tmp, capsys):
    def fn(addr):
        rc, out, err = run_cli(ns, addr, capsys, "top", "--once")
        assert rc == 0 and "dct top" in out and "tokens/s" in out
        assert "serving_replica_r0" in out and "ALERTS FIRING: deep" in out
        return [rc, out, err]
    return with_live_master(ns, fn)


def sc_cli_against_plain_master_says_not_enabled(ns, tmp, capsys):
    master = ns.InProcessMaster()
    with ns.MasterHTTPServer(master, 0) as srv:
        addr = f"127.0.0.1:{srv.port}"
        out = [run_cli(ns, addr, capsys, *argv)
               for argv in (["query"], ["alerts"], ["top", "--once"])]
    assert [o[0] for o in out] == [1, 1, 1]
    assert all("not enabled" in o[2] for o in out)
    # the error names the master's port, which differs between the runs
    return [(rc, o, e.replace(addr, "<master>")) for rc, o, e in out]


# -- autoscaler adapter ------------------------------------------------------

class _FakeFleet:
    def __init__(self):
        self.grown = 0

    def scale_up(self, n):
        self.grown += n

    def scale_down(self, n):
        raise AssertionError("should not shrink in this scenario")


def sc_timeseries_signals_drive_autoscaler(ns, tmp):
    state, clock = sim_clock()
    master = ns.InProcessMaster(clock=clock)
    master.enable_timeseries({})
    feed_fleet(master, state, ticks=8)
    signals = ns.TimeSeriesSignals(master.tsdb, window_s=30.0)
    fleet = _FakeFleet()
    scaler = ns.Autoscaler(
        fleet, ns.AutoscalePolicy(queue_high=8.0, breach_ticks=2,
                                  max_replicas=4),
        signals_fn=signals)
    s = signals()
    assert s.healthy == 2 and s.queue_depth > 16
    decisions = [scaler.tick(), scaler.tick()]
    assert decisions == ["hold", "grow"] and fleet.grown == 1
    master.stop_scraper()
    # NaN (no p99 stored) compares by its repr
    return [(s.healthy, s.queue_depth, repr(s.p99_s)), decisions,
            fleet.grown]


def sc_rule_override_forces_congestion(ns, tmp):
    state, clock = sim_clock()
    master = ns.InProcessMaster(clock=clock)
    master.enable_timeseries({"rules": [dict(DEEP_RULE, name="congested")]})
    feed_fleet(master, state)
    signals = ns.TimeSeriesSignals(master.tsdb, rules=master.rules,
                                   congestion_rules=["congested"])
    s = signals()
    assert s.p99_s == float("inf")
    master.stop_scraper()
    return [(s.healthy, s.queue_depth, repr(s.p99_s))]


SCENARIOS = [
    sc_record_and_windowed_query, sc_label_subset_matching,
    sc_rate_tolerates_counter_reset,
    sc_staircase_keeps_long_windows_answerable,
    sc_memory_budget_evicts_stalest_series_under_soak,
    sc_max_series_cap_evicts, sc_from_dict_reads_config_units,
    sc_segments_replay_after_restart, sc_segment_ring_bounds_disk,
    sc_scrape_skips_sources_that_did_not_reingest,
    sc_threshold_rule_state_machine_with_hold_down, sc_rate_of_change_rule,
    sc_absence_rule_fires_on_missing_and_stale,
    sc_burn_rate_counter_pair_needs_every_window,
    sc_stock_slo_rules_reproduce_fast_burn_from_stored_series,
    sc_rule_validation_rejects_bad_configs,
    sc_master_timeseries_and_alert_routes, sc_routes_404_when_not_enabled,
    sc_scraper_thread_runs_and_stops, sc_cli_query, sc_cli_alerts,
    sc_cli_top_once, sc_cli_against_plain_master_says_not_enabled,
    sc_timeseries_signals_drive_autoscaler,
    sc_rule_override_forces_congestion,
]
CLI_SCENARIOS = {sc_cli_query, sc_cli_alerts, sc_cli_top_once,
                 sc_cli_against_plain_master_says_not_enabled}


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[3:] for s in SCENARIOS])
def test_same_record_as_jax(scenario, tmp_path, capsys):
    """Each scenario of ``tests/test_tsdb_rules.py`` through both
    packages: its assertions hold in both, and the records are equal."""
    records = {}
    for pkg, ns in PKGS.items():
        tmp = str(tmp_path / pkg)
        os.makedirs(tmp)
        args = (ns, tmp, capsys) if scenario in CLI_SCENARIOS else (ns, tmp)
        records[pkg] = no_wall(scenario(*args))
    assert records["port"] == records["jax"]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_segments_replay_in_the_other_package(writer, reader, tmp_path):
    """JSONL segments one package writes replay in the other to the same
    queries as in the writer itself."""
    d = str(tmp_path / "tsdb")
    state, clock = sim_clock()
    write_segments(PKGS[writer], d, state, clock, segment_scrapes=3)
    got = replay(PKGS[reader], d, state, clock)
    assert got == replay(PKGS[writer], d, state, clock)
    assert approx(got[0]["series"][0]["value"], 60.0)


@pytest.mark.parametrize("master_pkg", ["jax", "port"])
def test_cli_prints_as_the_jax_cli_against_one_master(master_pkg, capsys):
    """``query``, ``alerts`` and ``top --once`` of both CLIs against one
    live master (either package's): the same codes and the same text."""
    def fn(addr):
        out = {}
        for argv in (["query"], ["query", "dct_fleet_queue_depth",
                                 "--reduce", "avg", "--window", "60"],
                     ["query", "serving_queue_depth", "--labels",
                      "component=serving_replica_r1"],
                     ["alerts"], ["alerts", "--json"], ["top", "--once"]):
            out[tuple(argv)] = [run_cli(PKGS[p], addr, capsys, *argv)
                                for p in ("jax", "port")]
        return out
    out = with_live_master(PKGS[master_pkg], fn)
    for argv, (jax_out, port_out) in out.items():
        assert no_wall(port_out) == no_wall(jax_out), argv
        assert port_out[0] == 0, argv


BAD_RULES = [
    {"name": "x", "kind": "nope"},
    {"name": "x", "kind": "threshold", "series": "s"},
    {"name": "x", "kind": "threshold", "series": "s", "value": 1.0,
     "op": "eq"},
    {"name": "x", "kind": "threshold", "series": "s", "value": 1.0,
     "severity": "sms"},
    {"name": "x", "kind": "threshold", "series": "s", "value": 1.0,
     "reduce": "median"},
    {"name": "x", "kind": "absence", "series": "s", "stale_s": 0.0},
    {"name": "x", "kind": "burn_rate", "windows": ["5m"]},
    {"name": "x", "kind": "burn_rate", "bad_series": "b",
     "windows": [60.0], "threshold": 1.0},
    {"name": "x", "kind": "threshold", "series": "s", "value": 1.0,
     "bogus": 2},
    {"kind": "threshold"},
    "not-a-mapping",
    {"name": "x", "kind": "threshold", "series": "s", "value": "high"},
    {"name": "x", "kind": "threshold", "series": "s", "value": 1.0,
     "for_s": "soon"},
]


def test_config_rejects_a_bad_rule_as_jax_does():
    """Every bad ``observability.rules`` entry fails both
    ``ExperimentConfig``s with the same error type and message; a good
    one passes both."""
    def verdict(config_cls, rules):
        try:
            config_cls.from_dict({"observability": {"rules": rules}})
            return None
        except Exception as e:  # noqa: BLE001 - the type is compared
            return type(e).__name__, str(e)

    for rule in BAD_RULES:
        want = verdict(JConfig, [DEEP_RULE, rule])
        assert want is not None, rule
        assert verdict(TConfig, [DEEP_RULE, rule]) == want, rule
        assert "observability.rules[1]" in want[1]
    assert verdict(TConfig, [DEEP_RULE]) is None
    assert verdict(JConfig, [DEEP_RULE]) is None


OBSERVABILITY_ARGV = [
    ["metrics"], ["metrics", "--raw"], ["goodput"],
    ["goodput", "--dir", "{tmp}"], ["slo"], ["mesh"],
    ["debug", "flight", "{tmp}", "-o", "{tmp}/flight.json"],
    ["trace", "export", "--from-file", "{tmp}/spans.jsonl", "-o",
     "{tmp}/trace.json"],
    ["trace", "request", "req-1", "--archive-dir", "{tmp}", "-o",
     "{tmp}/request.json"],
]


@pytest.mark.parametrize("argv", OBSERVABILITY_ARGV,
                         ids=lambda a: "-".join(a[:2]))
def test_observability_commands_print_as_jax(argv, tmp_path, capsys):
    """``metrics``, ``goodput``, ``slo``, ``mesh``, ``debug flight`` and
    ``trace export|request`` of both CLIs against one master with a
    fleet's rollup: the same codes, the same text, the same files."""
    with open(tmp_path / "spans.jsonl", "w") as f:
        f.write(json.dumps({"group": "span", "name": "train_dispatch",
                            "ts_us": 1, "dur_us": 5, "tid": 0}) + "\n")
    argv = [a.format(tmp=tmp_path) for a in argv]
    out = {}

    def fn(addr):
        for pkg in ("jax", "port"):
            out[pkg] = run_cli(PKGS[pkg], addr, capsys, *argv)
            written = argv[-1] if "-o" in argv else None
            if written and os.path.exists(written):
                with open(written) as f:
                    out[pkg] += (json.load(f),)
                os.unlink(written)
    with_live_master(PKGS["port"], fn)
    assert no_wall(out["port"]) == no_wall(out["jax"])
