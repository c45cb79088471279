"""The port's fleet on the CPU against the JAX package's: the router's
choices, breaker states and counters on scripted fake ports; a fleet's
stats, its aggregator rollup, scale-down in the middle of a burst and a
blue-green rollout under load, with tokens equal to the JAX fleet's; the
autoscaler's decisions on a fake fleet; the supervisor's verdicts;
``FleetHTTPServer``'s status codes and fields; the six chaos scenarios;
the SLO engine's evaluation, the request archive's records and the
metrics aggregator's text; and the ``fleet`` and ``kv`` commands.

Tolerance: decisions, states, counters, status codes, field sets and
archive records are compared exactly; tokens exactly (fp32 compute,
where the two frameworks differ only in summation order, far below the
logit gaps of these prompts). Concurrent requests wait on their handles
or on events, never on sleeps, except where a burst must span a
rollout window (as in the JAX tests).
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_clone_tpu.core._serialization import save_pytree
from determined_clone_tpu.models import gpt as jgpt
from determined_clone_tpu.serving import autoscale as jautoscale
from determined_clone_tpu.serving import bucketing as jbucket
from determined_clone_tpu.serving import engine as jengine
from determined_clone_tpu.serving import fleet as jfleet
from determined_clone_tpu.serving import http as jhttp
from determined_clone_tpu.serving import kv_cache as jkv
from determined_clone_tpu.serving import router as jrouter
from determined_clone_tpu.serving import supervisor as jsupervisor
from determined_clone_tpu.telemetry import aggregate as jaggregate
from determined_clone_tpu.telemetry import flight as jflight
from determined_clone_tpu.telemetry import metrics as jmetrics
from determined_clone_tpu.telemetry import slo as jslo
from determined_clone_tpu_torch import cli, convert
from determined_clone_tpu_torch.models import gpt as tgpt
from determined_clone_tpu_torch.serving import (
    AutoscalePolicy,
    Autoscaler,
    AutoscaleSignals,
    BucketSpec,
    FleetSupervisor,
    KVBlockStore,
    KVCacheConfig,
    LeastLoadedRouter,
    NoHealthyReplica,
    ReplicaFailed,
    ServerOverloaded,
    ServingFleet,
)
from determined_clone_tpu_torch.serving.chaos import run_scenarios
from determined_clone_tpu_torch.serving.http import (
    FleetHTTPServer,
    generate_over_http,
)
from determined_clone_tpu_torch.telemetry import aggregate, flight, slo
from determined_clone_tpu_torch.telemetry.metrics import MetricsRegistry
from determined_clone_tpu_torch.utils.retry import RetryPolicy

torch.set_num_threads(1)
if torch.get_num_interop_threads() != 1:
    try:
        torch.set_num_interop_threads(1)
    except RuntimeError:  # already fixed once inter-op work has run here
        pass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = dataclasses.replace(jgpt.GPTConfig.tiny(), compute_dtype=jnp.float32,
                           attention_impl="mha")
TCFG = dataclasses.replace(tgpt.GPTConfig.tiny(), compute_dtype=torch.float32,
                           attention_impl="mha")
LADDER = (2, 32)
POOL = dict(num_blocks=24, block_size=8)
PROMPT = [1, 2, 3]  # == the rollout probe default
MAX_NEW = 8
CHAOS = ("kill_replica_mid_decode", "wedged_scheduler", "double_fault",
         "poison_pill", "kv_warm_failover", "deadline_storm")


@pytest.fixture(scope="module")
def models():
    """(jax, port) params of two versions: JAX ``init`` from seeds 0 and 1,
    scaled by 10 (so tokens depend on the context)."""
    init = jax.jit(jgpt.init, static_argnums=1)
    jp, jp2 = (jax.tree_util.tree_map(
        lambda x: x * 10.0, init(jax.random.PRNGKey(seed), JCFG))
        for seed in (0, 1))
    return {"v1": (jp, convert.params_from_numpy(jax.device_get(jp), "cpu")),
            "v2": (jp2, convert.params_from_numpy(jax.device_get(jp2),
                                                  "cpu"))}


def jax_fleet(jp, **kw):
    kw.setdefault("warmup", False)
    kw.setdefault("tracing", False)
    return jfleet.ServingFleet(jp, JCFG,
                               buckets=jbucket.BucketSpec.build(*LADDER),
                               cache=jkv.KVCacheConfig(**POOL), **kw)


def port_fleet(tp, **kw):
    kw.setdefault("warmup", False)
    kw.setdefault("tracing", False)
    return ServingFleet(tp, TCFG, buckets=BucketSpec.build(*LADDER),
                        cache=KVCacheConfig(**POOL), device="cpu", **kw)


def prompts_of(n, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, int(rng.integers(2, 12))).tolist()
            for _ in range(n)]


# -- router: the same scripts on both packages ----------------------------------

class FakePort:
    def __init__(self, rid, queue=0, free=16, fail=None, inventory=None):
        self.replica_id = rid
        self.queue = queue
        self.free = free
        self.fail = fail
        self.admit = True
        self.submitted = 0
        self.inventory = inventory

    def admitting(self):
        return self.admit

    def load(self):
        return (self.queue, -self.free)

    def prefix_inventory(self):
        return self.inventory

    def submit(self, prompt, max_new_tokens, *, eos_token_id=None,
               request_id=None, deadline_t=None):
        if self.fail is not None:
            raise self.fail
        self.submitted += 1
        return types.SimpleNamespace(result=lambda timeout=None: None)


PKG = {
    "port": types.SimpleNamespace(
        Router=LeastLoadedRouter, Overloaded=ServerOverloaded,
        Failed=ReplicaFailed, NoHealthy=NoHealthyReplica,
        Registry=MetricsRegistry, Policy=RetryPolicy),
    "jax": types.SimpleNamespace(
        Router=jrouter.LeastLoadedRouter,
        Overloaded=jengine.ServerOverloaded, Failed=jengine.ReplicaFailed,
        NoHealthy=jrouter.NoHealthyReplica,
        Registry=jmetrics.MetricsRegistry,
        Policy=jrouter.RetryPolicy),
}


def _router_script_picks(p):
    r = p.Router()
    a, b, c = (FakePort("a", 3, 16), FakePort("b", 1, 2),
               FakePort("c", 1, 9))
    for port in (a, b, c):
        r.add(port)
    out = [r.pick().replica_id]
    c.free = 2
    r.add(FakePort("a0", 1, 2))
    out.append(r.pick().replica_id)
    for port in r._replicas.values():
        port.admit = port.replica_id == "a"
    out.append(r.pick().replica_id)
    return out


def _router_script_failover(p):
    now = [0.0]
    r = p.Router(exclude_cooldown_s=5.0, clock=lambda: now[0])
    bad = FakePort("bad", 0, fail=p.Overloaded("queue full"))
    good = FakePort("good", 7)
    flaky = FakePort("flaky", 0, fail=ConnectionError("reset"))
    for port in (bad, good):
        r.add(port)
    out = [r.submit(PROMPT, MAX_NEW).replica_id, r.excluded(),
           r.submit(PROMPT, MAX_NEW).replica_id]
    now[0] = 6.0
    bad.fail = None
    out += [r.excluded(), r.submit(PROMPT, MAX_NEW).replica_id]
    r.add(flaky)
    out += [r.submit(PROMPT, MAX_NEW).replica_id, r.excluded()]
    text = r.registry.dump()
    out.append(sorted(ln for ln in text.splitlines()
                      if ln.startswith("router_") and "{" in ln))
    return out


def _router_script_breaker(p):
    now = [0.0]
    reg = p.Registry()
    r = p.Router(reg, exclude_cooldown_s=1.0, exclude_max_s=8.0,
                 clock=lambda: now[0])
    bad, good = FakePort("a", 0), FakePort("b", 5)
    bad.fail = p.Failed("died", active=True)
    r.add(bad)
    r.add(good)
    out = []
    for t, fail in ((0.0, True), (0.5, True), (1.1, True), (2.5, True),
                    (3.5, False), (3.6, False)):
        now[0] = t
        bad.fail = p.Failed("died", active=True) if fail else None
        out.append((t, r.submit(PROMPT, MAX_NEW).replica_id,
                    r.replica_states(), r.excluded(),
                    reg.gauge("router_replica_state",
                              labels={"replica": "a"}).value))
    return out


def _router_script_affinity(p):
    from determined_clone_tpu.serving.kv_store import (
        PrefixInventory,
        prompt_chain_keys,
    )
    prompt = list(range(1, 25))
    warm = PrefixInventory.build(prompt_chain_keys(prompt, 8, 8)).to_dict()
    r = p.Router(prefix_block_size=8, affinity_queue_slack=2)
    cold = FakePort("a-cold", 0, 16)
    hot = FakePort("b-warm", 1, 16, inventory=warm)
    r.add(cold)
    r.add(hot)
    out = [r.pick(prompt=prompt).replica_id]
    hot.queue = 3
    out += [r.pick(prompt=prompt).replica_id, r.pick().replica_id,
            r.registry.counter("router_affinity_picks_total", "").value]
    return out


def _router_script_errors(p):
    out = []
    r = p.Router()
    fast = p.Policy(name="t", max_attempts=3, base_delay_s=0.0,
                    max_delay_s=0.0, retryable=(p.NoHealthy,))
    r.policy = fast
    for fail in (None, p.Overloaded("full")):
        if fail is not None:
            r.add(FakePort("sick", fail=fail))
        try:
            r.submit(PROMPT, MAX_NEW)
            out.append("ok")
        except p.NoHealthy:
            out.append("no-healthy")
    boom = FakePort("boom", fail=ValueError("empty prompt"))
    spare = FakePort("spare", 9)
    r2 = p.Router()
    r2.add(boom)
    r2.add(spare)
    try:
        r2.submit(PROMPT, MAX_NEW)
    except ValueError:
        out.append(("value-error", spare.submitted, r2.excluded()))
    try:
        r2.submit(PROMPT, MAX_NEW, deadline_t=time.monotonic() - 1.0)
    except TimeoutError as e:
        out.append(("expired", "before dispatch" in str(e)))
    return out


@pytest.mark.parametrize("script", [
    _router_script_picks, _router_script_failover, _router_script_breaker,
    _router_script_affinity, _router_script_errors])
def test_router_script_matches_jax(script):
    assert script(PKG["port"]) == script(PKG["jax"])


# -- fleet: stats, rollup, drain, rollout ---------------------------------------

def test_fleet_stats_and_rollup_match_jax(models):
    (jp, tp) = models["v1"]
    prompts = prompts_of(12)
    out = {}
    for pkg, mk, params, agg_mod in (
            ("port", port_fleet, tp, aggregate),
            ("jax", jax_fleet, jp, jaggregate)):
        agg = agg_mod.ClusterMetricsAggregator(clock=lambda: 1000.0)
        fleet = mk(params, aggregator=agg, iteration_floor_s=0.01)
        try:
            fleet.scale_up(2)
            hs = [fleet.submit(p, MAX_NEW, timeout=60.0) for p in prompts]
            toks = [h.result(timeout=60.0).tokens for h in hs]
            spread = {h.replica_id for h in hs}
            for rep in fleet.replicas():
                rep.engine.wait_idle()
            st = fleet.stats()
            fleet.sample_telemetry()
            roll = agg.serving_fleet_rollup()
            out[pkg] = (toks, spread, (st.replicas, st.healthy,
                                       st.completed, st.tokens_generated,
                                       st.rejected, st.free_blocks),
                        {k: roll[k] for k in ("replicas",
                                              "requests_completed",
                                              "free_kv_blocks")},
                        "dct_fleet_replicas 2" in agg.dump())
        finally:
            fleet.close()
    assert out["port"] == out["jax"]
    assert out["port"][1] == {"fleet-1", "fleet-2"} and out["port"][4]


def test_scale_down_mid_burst_drops_nothing_like_jax(models):
    (jp, tp) = models["v1"]
    prompts = prompts_of(16, seed=8)
    out = {}
    for pkg, mk, params in (("port", port_fleet, tp),
                            ("jax", jax_fleet, jp)):
        fleet = mk(params, iteration_floor_s=0.02)
        try:
            fleet.scale_up(2)
            hs = [fleet.submit(p, MAX_NEW, timeout=60.0) for p in prompts]
            busy = fleet.stats().queue_depth > 0
            removed = fleet.scale_down(1, timeout=60.0)
            toks = [h.result(timeout=60.0).tokens for h in hs]
            out[pkg] = (toks, removed, fleet.replica_ids(),
                        fleet.stats().rejected, busy)
        finally:
            fleet.close()
    assert out["port"] == out["jax"]
    assert out["port"][1] == ["fleet-2"] and out["port"][4]


def test_blue_green_rollout_under_load_matches_jax(models):
    """Rollout in the middle of a burst: no request fails and every
    request's tokens are exactly one version's, the same tokens as the
    JAX fleet's for that version; the canary's probe equals the JAX
    canary's."""
    (jp, tp), (jp2, tp2) = models["v1"], models["v2"]
    prompts = prompts_of(24, seed=9)
    refs = {}
    for tag, (j, t) in (("old", (jp, tp)), ("new", (jp2, tp2))):
        with port_fleet(t) as fp, jax_fleet(j) as fj:
            fp.scale_up(1)
            fj.scale_up(1)
            mine = [fp.submit(p, MAX_NEW).result(60.0).tokens
                    for p in prompts]
            ref = [fj.submit(p, MAX_NEW).result(60.0).tokens
                   for p in prompts]
        assert mine == ref
        refs[tag] = mine
    assert all(a != b for a, b in zip(refs["old"], refs["new"]))
    reports = {}
    for pkg, mk, params, new in (("port", port_fleet, tp, tp2),
                                 ("jax", jax_fleet, jp, jp2)):
        fleet = mk(params, iteration_floor_s=0.01)
        try:
            fleet.scale_up(2)
            box = {}
            started = threading.Event()

            def roll():
                started.set()
                box["report"] = fleet.rollout(new, probe_tokens=MAX_NEW)

            roller = threading.Thread(target=roll, name="test-rollout")
            hs = []
            for i, p in enumerate(prompts):
                hs.append(fleet.submit(p, MAX_NEW, timeout=60.0))
                if i == 6:
                    roller.start()
                    started.wait(10.0)
                time.sleep(0.005)  # the burst must span the rollout window
            toks = [h.result(timeout=60.0).tokens for h in hs]
            roller.join(60.0)
            assert not roller.is_alive()
            versions = []
            for t, a, b in zip(toks, refs["old"], refs["new"]):
                assert (t == a) != (t == b)
                versions.append("old" if t == a else "new")
            rep = box["report"]
            reports[pkg] = (rep.order, rep.probe_output,
                            sorted(rep.drain_s), fleet.stats().rejected)
            assert versions[0] == "old"
            after = fleet.submit(prompts[0], MAX_NEW).result(60.0).tokens
            assert after == refs["new"][0]
        finally:
            fleet.close()
    assert reports["port"] == reports["jax"]


def test_fleet_refuses_kv_store_without_prefix_cache_and_needs_a_card(
        models):
    (_, tp) = models["v1"]
    with pytest.raises(ValueError, match="prefix_cache"):
        port_fleet(tp, kv_store=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ServingFleet(tp, TCFG)
    with port_fleet(tp, prefix_cache=True, kv_store=True) as fleet:
        assert isinstance(fleet.kv_store, KVBlockStore)
        assert fleet.kv_stats()["entries"] == 0


def test_replace_replica_warms_the_replacement_like_jax(models):
    """stop/replace teardown flushes resident blocks; the replacement
    promotes them on its first shared-prefix request: tokens, kv
    counters and the incident's fields equal the JAX fleet's."""
    (jp, tp) = models["v1"]
    prompt = list(range(5, 21)) + [3, 4]
    out = {}
    for pkg, mk, params, store in (
            ("port", port_fleet, tp, KVBlockStore()),
            ("jax", jax_fleet, jp, jfleet.KVBlockStore())):
        fleet = mk(params, prefix_cache=True, kv_store=store)
        try:
            ids = fleet.scale_up(1)
            first, _ = fleet.handle_request(prompt, MAX_NEW, timeout=60.0)
            for rep in fleet.replicas():
                rep.engine.wait_idle(15.0)
            replacement = fleet.replace_replica(ids[0], reason="test")
            again, _ = fleet.handle_request(prompt, MAX_NEW, timeout=60.0)
            st = fleet.replicas()[0].engine.stats()
            inc = fleet.last_incident()
            health = fleet.health_view()
            out[pkg] = (first.tokens, again.tokens, replacement,
                        (st.kv_host_hit_blocks, st.kv_promoted_blocks,
                         st.kv_miss_blocks),
                        {k: inc[k] for k in ("replica", "reason",
                                             "failed_requests",
                                             "leaked_blocks",
                                             "replacement")},
                        sorted(health), store.stats()["puts"])
        finally:
            fleet.close()
    assert out["port"] == out["jax"]
    assert out["port"][0] == out["port"][1]
    assert out["port"][3][1] == 2 and out["port"][3][2] == 0


# -- autoscaler and supervisor ----------------------------------------------------

class FakeFleet:
    def __init__(self, registry, healthy=1):
        self.registry = registry
        self.healthy = healthy
        self.ups = []
        self.downs = []

    def healthy_count(self):
        return self.healthy

    def scale_up(self, n):
        self.ups.append(n)
        self.healthy += n

    def scale_down(self, n, timeout=60.0):
        self.downs.append(n)
        self.healthy -= n


def _autoscale_script(mod, registry_cls):
    fleet = FakeFleet(registry_cls(), healthy=1)
    policy = mod.AutoscalePolicy(min_replicas=1, max_replicas=3,
                                 queue_high=8.0, p99_high_s=2.0,
                                 breach_ticks=2, queue_low=0.5,
                                 idle_ticks=2, cooldown_ticks=1)
    scaler = mod.Autoscaler(fleet, policy)
    sig = mod.AutoscaleSignals
    ticks = ([sig(1, 20, 0.1)] * 4 + [sig(2, 4, 0.1), sig(2, 20, 0.1),
                                      sig(2, 0, 5.0), sig(2, 0, 5.0)]
             + [sig(3, 60, 9.0)] * 2 + [sig(3, 0, 0.0)] * 3
             + [sig(2, 0, float("nan"))] * 4)
    decisions = [scaler.tick(s) for s in ticks]
    dry = mod.Autoscaler(FakeFleet(registry_cls()), mod.AutoscalePolicy(
        min_replicas=1, max_replicas=2, breach_ticks=1, idle_ticks=1,
        cooldown_ticks=0), dry_run=True)
    decisions.append(dry.tick(sig(1, 50, 9.0)))
    return (decisions, fleet.ups, fleet.downs, dry.fleet.ups,
            scaler.registry.dump())


def test_autoscaler_decisions_match_jax():
    mine = _autoscale_script(types.SimpleNamespace(
        AutoscalePolicy=AutoscalePolicy, Autoscaler=Autoscaler,
        AutoscaleSignals=AutoscaleSignals), MetricsRegistry)
    ref = _autoscale_script(jautoscale, jmetrics.MetricsRegistry)
    assert mine == ref
    assert "grow" in mine[0] and "shrink" in mine[0]


def test_autoscaler_thread_starts_and_closes(models):
    (_, tp) = models["v1"]
    with port_fleet(tp) as fleet:
        fleet.scale_up(1)
        scaler = Autoscaler(fleet, AutoscalePolicy(min_replicas=1,
                                                   max_replicas=1))
        scaler.start(interval_s=0.01)
        try:
            assert scaler.tick() == "hold"
        finally:
            scaler.close()


def test_supervisor_verdicts_match_jax():
    base = {"thread_alive": True, "fatal": None, "condemned": False,
            "warming": False, "pending": False, "beat_age_s": 0.0}
    cases = [base, {**base, "thread_alive": False},
             {**base, "fatal": RuntimeError("x")},
             {**base, "pending": True, "beat_age_s": 2.0},
             {**base, "pending": True, "warming": True, "beat_age_s": 2.0},
             {**base, "beat_age_s": 2.0}]
    verdicts = {}
    for pkg, cls, reg in (("port", FleetSupervisor, MetricsRegistry),
                          ("jax", jsupervisor.FleetSupervisor,
                           jmetrics.MetricsRegistry)):
        sup = cls(types.SimpleNamespace(registry=reg()), stale_after_s=1.0,
                  start=False)
        verdicts[pkg] = [sup.verdict(c) for c in cases]
    assert verdicts["port"] == verdicts["jax"] == [
        "ok", "dead", "dead", "wedged", "ok", "ok"]


def test_supervisor_replaces_a_dead_replica(models):
    from determined_clone_tpu_torch import faults

    (_, tp) = models["v1"]
    with port_fleet(tp) as fleet:
        fleet.scale_up(2)
        sup = fleet.start_supervisor(interval_s=0.02, stale_after_s=2.0)
        assert sup.running
        plan = faults.activate(faults.plan_from_dict({"rules": [
            {"point": "engine.step.fleet-1", "action": "error",
             "times": 1}]}))
        try:
            res, _ = fleet.handle_request(PROMPT, MAX_NEW, timeout=60.0)
            deadline = time.monotonic() + 30.0
            while not fleet.incidents() and time.monotonic() < deadline:
                fleet.handle_request(PROMPT, 1, timeout=60.0)
        finally:
            faults.deactivate(plan)
        assert len(res.tokens) == MAX_NEW
        inc = fleet.incidents()
        assert inc and inc[0]["replica"] == "fleet-1"
        assert fleet.healthy_count() == 2
    assert fleet.supervisor is None


# -- HTTP front door ---------------------------------------------------------------

def _http(url, method, path, body=None):
    req = urllib.request.Request(
        f"{url}{path}", method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            raw = resp.read()
            code = resp.status
    except urllib.error.HTTPError as e:
        raw, code = e.read(), e.code
    try:
        return code, json.loads(raw or b"{}")
    except ValueError:
        return code, raw.decode()


def _http_script(fleet, server_cls, ckpt):
    with server_cls(fleet) as srv:
        url = srv.url
        out = []

        def shape(v):
            """The document without its clock readings and minted ids."""
            if isinstance(v, dict):
                return {k: shape(x) for k, x in sorted(v.items())
                        if k not in ("beat_age_s", "duration_s",
                                     "max_p99_s", "drain_s", "time",
                                     "request_id", "trace_id",
                                     "replica_id")}
            if isinstance(v, list):
                return [shape(x) for x in v]
            if isinstance(v, str):
                return re.sub(r"req-[0-9a-f]{12}", "req-ID", v)
            return v

        for method, path, body in (
                ("POST", "/v1/generate", {"prompt": PROMPT,
                                          "max_new_tokens": MAX_NEW}),
                ("GET", "/healthz", None),
                ("GET", "/v1/fleet", None),
                ("GET", "/v1/slo", None),
                ("POST", "/v1/generate", {"prompt": "not-a-list"}),
                ("POST", "/v1/generate", {"prompt": PROMPT,
                                          "max_new_tokens": 0}),
                ("POST", "/v1/generate", {"prompt": PROMPT,
                                          "deadline_s": -1.0}),
                ("POST", "/v1/scale", {"replicas": 2}),
                ("POST", "/v1/scale", {}),
                ("POST", "/v1/rollout", {}),
                ("POST", "/v1/rollout", {"checkpoint": ckpt}),
                ("POST", "/v1/generate", {"prompt": PROMPT,
                                          "max_new_tokens": MAX_NEW}),
                ("GET", "/nope", None), ("POST", "/nope", {})):
            code, doc = _http(url, method, path, body)
            out.append((method, path, code, shape(doc)))
        code, text = _http(url, "GET", "/metrics")
        out.append(("GET", "/metrics", code,
                    sorted({ln.split("{")[0].split(" ")[0]
                            for ln in text.splitlines()
                            if ln and not ln.startswith("#")
                            and not ln.startswith("dct_cluster")})))
    return out


def test_fleet_http_codes_and_fields_match_jax(models, tmp_path):
    (jp, tp), (jp2, _) = models["v1"], models["v2"]
    ckpt = str(tmp_path / "v2")
    save_pytree(ckpt, jp2)
    out = {}
    for pkg, mk, params, server in (
            ("port", port_fleet, tp, FleetHTTPServer),
            ("jax", jax_fleet, jp, jhttp.FleetHTTPServer)):
        # a latency threshold no request here nears: the JAX fleet's
        # first request compiles its programs
        fleet = mk(params, tracing=True, prefix_cache=True, kv_store=True,
                   slo={"latency_threshold_s": 600.0})
        try:
            fleet.scale_up(1)
            out[pkg] = _http_script(fleet, server, ckpt)
        finally:
            fleet.close()
    assert out["port"] == out["jax"]
    codes = [c for _m, _p, c, _d in out["port"]]
    assert codes == [200, 200, 200, 200, 400, 400, 504, 200, 400, 400, 200,
                     200, 404, 404, 200]


def test_fleet_http_poison_pill_is_422(models):
    from determined_clone_tpu_torch import faults

    (_, tp) = models["v1"]
    with port_fleet(tp, max_request_crashes=1) as fleet:
        fleet.scale_up(1)
        sup = fleet.start_supervisor(interval_s=0.02, stale_after_s=2.0)
        plan = faults.activate(faults.plan_from_dict({"rules": [
            {"point": "engine.admit.pill", "action": "error",
             "times": 0}]}))
        try:
            with FleetHTTPServer(fleet) as srv:
                code, doc = _http(srv.url, "POST", "/v1/generate",
                                  {"prompt": PROMPT, "request_id": "pill",
                                   "max_new_tokens": 2})
        finally:
            faults.deactivate(plan)
        assert sup is fleet.supervisor
    assert code == 422
    assert doc["diagnostics"]["crashes"] == 1


# -- chaos -----------------------------------------------------------------------

@pytest.mark.parametrize("scenario", CHAOS)
def test_chaos_scenario_passes(scenario):
    (result,) = run_scenarios([scenario], seed=0, device="cpu")
    failed = [c.name + ": " + c.detail for c in result.checks if not c.ok]
    assert result.passed, failed
    assert result.to_dict()["scenario"] == scenario


def test_chaos_refuses_unknown_and_torn_warmstart():
    with pytest.raises(KeyError, match="torn_warmstart"):
        run_scenarios(["torn_warmstart"], device="cpu")


# -- SLO, request archive, aggregator ------------------------------------------------

T0 = 1_000_000.0


def _slo_script(mod, registry_cls, **kw):
    eng = mod.SLOEngine(clock=lambda: T0, **kw)
    evs = [eng.evaluate(now=T0)]
    for tick in range(72):
        eng.record_request(ok=True, latency_s=0.01 * (tick % 7), n=50,
                           t=T0 - tick * 3600.0)
        if tick % 5 == 0:
            eng.record_request(ok=False, n=3, t=T0 - tick * 3600.0)
    evs.append(eng.evaluate(now=T0))
    eng.record_request(ok=False, n=2000, t=T0)
    evs.append(eng.evaluate(now=T0))
    reg = registry_cls()
    ev = eng.publish(reg, now=T0) if "now" in \
        mod.SLOEngine.publish.__code__.co_varnames else eng.publish(reg)
    return evs, mod.format_slo(ev), reg.dump()


@pytest.mark.parametrize("kw", [{}, {"availability_objective": 0.99},
                                {"latency_objective": 0.9,
                                 "latency_threshold_s": 0.03}])
def test_slo_engine_evaluation_matches_jax(kw):
    mine = _slo_script(slo, MetricsRegistry, **kw)
    ref = _slo_script(jslo, jmetrics.MetricsRegistry, **kw)
    assert mine == ref
    assert mine[0][0]["verdict"] == "no_data"
    with pytest.raises(ValueError):
        slo.SLOEngine(availability_objective=1.5)


def _archive_script(mod, directory):
    archive = mod.RequestArchive(directory, slowest_n=2, sample_rate=0.5,
                                 seed=3)
    reasons = []
    for i, lat in enumerate((0.5, 0.2, 0.1, 0.3, 0.05, 0.7)):
        rid = f"r-{i}"
        for j, name in enumerate(("frontdoor_request", "request_admitted")):
            archive.observe_span(rid, {
                "name": name, "ts_us": 1000 * i + j, "dur_us": 10,
                "tid": 1, "tname": "main", "args": {"request_id": rid},
                "process": ("frontdoor", "serving_replica_r1")[j],
                "wall_epoch": 1.0, "trace_id": f"t-{i}"})
        reasons.append(archive.note_result(rid, ok=i != 4, latency_s=lat,
                                           error="boom" if i == 4 else None))
    archive.close()
    return reasons


def test_request_archive_records_match_jax(tmp_path):
    mine = _archive_script(flight, str(tmp_path / "port"))
    ref = _archive_script(jflight, str(tmp_path / "jax"))
    assert mine == ref
    for rid in ("r-0", "r-4"):
        recs = flight.request_records(str(tmp_path / "port"), rid)
        assert recs == jflight.request_records(str(tmp_path / "jax"), rid)
        assert len(recs) == 2
        # the port reads the JAX package's archive as the JAX reader does
        assert flight.request_records(str(tmp_path / "jax"), rid) == recs
    summary = flight.request_archive_summary(str(tmp_path / "port"))
    ref_summary = jflight.request_archive_summary(str(tmp_path / "jax"))
    drop = ("time",)
    assert [{k: v for k, v in r.items() if k not in drop}
            for r in summary["retained"]] == \
        [{k: v for k, v in r.items() if k not in drop}
         for r in ref_summary["retained"]]
    assert summary["live_spans"] == ref_summary["live_spans"] == 12
    trace = flight.request_chrome_trace(str(tmp_path / "port"), "r-0")
    assert trace["otherData"]["trace_ids"] == ["t-0"]
    with pytest.raises(KeyError):
        flight.request_chrome_trace(str(tmp_path / "port"), "r-unknown")


def _registries(reg_cls):
    out = []
    for i in range(2):
        reg = reg_cls()
        reg.counter("serving_requests_completed_total", "done").inc(3 + i)
        reg.counter("kv_tier_host_hit_blocks_total", "hits").inc(i)
        reg.gauge("serving_free_kv_blocks", "free").set(10 * i + 4)
        reg.gauge("serving_tokens_per_sec", "tps").set(12.5 * i)
        h = reg.histogram("serving_request_total_seconds", "lat")
        for v in (0.1, 0.2, 0.4 + i):
            h.observe(v)
        out.append(reg)
    return out


def test_aggregator_text_and_rollups_match_jax():
    out = {}
    for pkg, mod, reg_cls in (("port", aggregate, MetricsRegistry),
                              ("jax", jaggregate, jmetrics.MetricsRegistry)):
        agg = mod.ClusterMetricsAggregator(clock=lambda: 500.0)
        for i, reg in enumerate(_registries(reg_cls)):
            agg.ingest_component(f"serving_replica_r{i}", reg)
        agg.ingest_component_spans("frontdoor", [
            {"name": "frontdoor_request", "ts_us": 1, "dur_us": 2,
             "args": {"request_id": "x"}}])
        out[pkg] = (agg.dump(), agg.serving_fleet_rollup(),
                    mod.format_summary(agg.summary()),
                    len(agg.spans()))
    assert out["port"] == out["jax"]
    assert out["port"][1]["replicas"] == 2


# -- the fleet and kv commands --------------------------------------------------------

def test_fleet_up_selftest_on_the_cpu_and_refusals():
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run(
        [sys.executable, "-m", "determined_clone_tpu_torch.cli", "fleet",
         "up", "--selftest", "--replicas", "2", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert run.returncode == 0, run.stderr[-2000:]
    doc = json.loads(run.stdout.strip().splitlines()[-1])
    assert doc["selftest"] == "ok" and doc["replicas"] == [
        "fleet-1", "fleet-2"] and doc["stats"]["completed"] == 4
    # the master link speaks the loopback agent protocol: a remote master
    # is refused before any connection, as the JAX CLI refuses it
    assert cli.main(["-m", "master.example:8080", "fleet", "up",
                     "--with-master", "--device", "cpu"]) == 2
    # without --url, status and scale ask the master: none listens here
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{sock.getsockname()[1]}"
    assert cli.main(["-m", dead, "fleet", "status"]) == 1
    assert cli.main(["-m", dead, "fleet", "scale", "--replicas", "1"]) == 1
    assert cli.main(["kv", "stats"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["fleet", "up", "--selftest"])


def test_fleet_commands_against_a_front_door(models, tmp_path, capsys):
    (_, tp), (jp2, _) = models["v1"], models["v2"]
    ckpt = str(tmp_path / "v2")
    save_pytree(ckpt, jp2)
    with port_fleet(tp, prefix_cache=True, kv_store=True) as fleet, \
            FleetHTTPServer(fleet) as srv:
        fleet.scale_up(1)
        generate_over_http(srv.url, list(range(1, 20)), 2)
        capsys.readouterr()
        assert cli.main(["fleet", "status", "--url", srv.url]) == 0
        text = capsys.readouterr().out
        assert "fleet 'fleet': 1/1 healthy" in text and "fleet-1" in text
        assert cli.main(["fleet", "status", "--url", srv.url,
                         "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["name"] == "fleet"
        assert cli.main(["kv", "stats", "--url", srv.url]) == 0
        assert json.loads(capsys.readouterr().out) == fleet.kv_stats()
        assert cli.main(["fleet", "scale", "--url", srv.url,
                         "--replicas", "2"]) == 0
        assert "fleet now has 2 replicas" in capsys.readouterr().out
        assert cli.main(["fleet", "rollout", "--url", srv.url,
                         "--checkpoint", ckpt]) == 0
        assert "rollout complete" in capsys.readouterr().out
    store_root = str(tmp_path / "store")
    from determined_clone_tpu_torch.storage import SharedFSStorageManager
    from determined_clone_tpu_torch.storage.cas import KVBlobStore
    KVBlobStore(SharedFSStorageManager(store_root)).store(
        {"fingerprint": "fp", "chain": "ab" * 32}, {"k": np.zeros(4)})
    assert cli.main(["kv", "stats", "--host-path", store_root]) == 0
    assert json.loads(capsys.readouterr().out)["entries"] == 1


def test_rollout_from_storage_loads_once_and_serves_the_new_version(
        models, tmp_path):
    """A checkpoint written by the JAX package, uploaded to shared_fs
    storage, rolled out through ``rollout_from_storage``: afterwards the
    fleet's tokens are the JAX fleet's under those weights."""
    from determined_clone_tpu_torch.storage import SharedFSStorageManager

    (jp, tp), (jp2, _) = models["v1"], models["v2"]
    src = tmp_path / "v2"
    save_pytree(str(src), jp2)
    storage = SharedFSStorageManager(str(tmp_path / "store"))
    storage.upload(str(src), "ckpt-v2")
    with jax_fleet(jp2) as fj:
        fj.scale_up(1)
        want = fj.submit(PROMPT, MAX_NEW).result(60.0).tokens
    with port_fleet(tp) as fleet:
        fleet.scale_up(2)
        before = fleet.submit(PROMPT, MAX_NEW).result(60.0).tokens
        report = fleet.rollout_from_storage(storage, "ckpt-v2",
                                            base_tmp=str(tmp_path))
        after = [fleet.submit(PROMPT, MAX_NEW).result(60.0).tokens
                 for _ in range(2)]
        loads = fleet.registry.histogram(
            "fleet_rollout_load_seconds",
            "checkpoint fetch + deserialize (once per rollout)").count
    assert before != want
    assert after == [want, want] and report.probe_output == want
    assert report.order == ["fleet-1", "fleet-2"] and loads == 1


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """Leave no compiled JAX program behind this file:
    ``tests/test_serving.py`` counts the process-wide jit cache of the JAX
    engine's shared forward against its compile budget, and a worker may
    run it after this file."""
    yield
    jax.clear_caches()
