"""The port's local experiment runner and in-process master held against
the JAX package on the CPU.

One tiny trial, written for each package (loss ``(w - 1)² + lr``, SGD),
runs through both ``LocalExperimentRunner``s — the port's on
``device="cpu"`` — under random, grid, ASHA and adaptive ASHA searches,
a custom ``SearchMethod`` through ``LocalSearchRunner``, a restart and
exhausted restarts with zero backoff. Compared: the trials, their
hparams, states, units and restarts, ``best_trial``, and
``experiment_snapshot.json`` equal but for paths (a checkpoint's storage
id is a fresh uuid) with every metric in it within 1e-5 (the same fp32
arithmetic in each framework's kernels). The in-process masters fed the
same samples under one clock give byte-equal ``/metrics`` text and equal
``summary()``, directly and over HTTP.
"""
import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from determined_clone_tpu import searcher as jsearch
from determined_clone_tpu.api import inprocess as jinproc
from determined_clone_tpu.config import ExperimentConfig as JConfig
from determined_clone_tpu.experiment import LocalExperimentRunner as JRunner
from determined_clone_tpu.parallel import MeshSpec, make_mesh
from determined_clone_tpu.training import JaxTrial
from determined_clone_tpu.utils import retry as jretry
from determined_clone_tpu_torch import searcher as tsearch
from determined_clone_tpu_torch.api import inprocess as tinproc
from determined_clone_tpu_torch.config import ExperimentConfig as TConfig
from determined_clone_tpu_torch.experiment import (
    LocalExperimentRunner as TRunner,
)
from determined_clone_tpu_torch.telemetry import MetricsRegistry, Telemetry
from determined_clone_tpu_torch.training import TorchTrial, optim
from determined_clone_tpu_torch.utils import retry as tretry

torch.set_num_threads(1)

TOL = 1e-5


class JQuadratic(JaxTrial):
    """loss = (w - 1)² + lr: the searcher's signal is the ``lr`` hparam."""

    fail_once = {}

    def initial_params(self, rng):
        return {"w": jnp.zeros(())}

    def optimizer(self):
        return optax.sgd(0.3)

    def loss(self, params, batch, rng):
        lr = self.context.get_hparam("lr", 0.5)
        return (params["w"] - 1.0) ** 2 + lr, {}

    def training_data(self):
        if self.fail_once.pop("armed", False):
            raise RuntimeError("injected failure")
        if self.fail_once.get("always"):
            raise RuntimeError("always broken")
        for _ in range(128):
            yield np.zeros((2, 1), np.float32)

    def validation_data(self):
        return [np.zeros((2, 1), np.float32)]

    @property
    def global_batch_size(self):
        return 2


class TQuadratic(TorchTrial):
    fail_once = {}

    def initial_params(self, gen):
        return {"w": torch.zeros((), device=self.context.device)}

    def optimizer(self):
        return optim.sgd(0.3)

    def loss(self, params, batch, seed):
        lr = self.context.get_hparam("lr", 0.5)
        return (params["w"] - 1.0) ** 2 + lr, {}

    training_data = JQuadratic.training_data
    validation_data = JQuadratic.validation_data
    global_batch_size = JQuadratic.global_batch_size


@pytest.fixture(autouse=True)
def _disarm():
    """No failure flag outlives its test."""
    yield
    JQuadratic.fail_once.clear()
    TQuadratic.fail_once.clear()


SEARCHES = {
    "random": {"name": "random", "metric": "loss", "max_trials": 3,
               "max_length": {"batches": 4}, "max_concurrent_trials": 2},
    "grid": {"name": "grid", "metric": "loss", "max_trials": 3,
             "max_length": {"batches": 4}},
    "asha": {"name": "asha", "metric": "loss", "max_trials": 6,
             "num_rungs": 2, "divisor": 3, "max_length": {"batches": 6},
             "max_concurrent_trials": 6},
    "adaptive_asha": {"name": "adaptive_asha", "metric": "loss",
                      "max_trials": 5, "num_rungs": 2, "divisor": 2,
                      "mode": "standard", "max_length": {"batches": 4}},
    "single": {"name": "single", "metric": "loss",
               "max_length": {"batches": 4}},
}


def _raw(path, searcher, **extra):
    return {"searcher": searcher, "scheduling_unit": 2,
            "checkpoint_storage": {"type": "shared_fs",
                                   "host_path": str(path)},
            "hyperparameters": {"lr": {"type": "double", "minval": 0.1,
                                       "maxval": 1.0, "count": 3}},
            "reproducibility": {"experiment_seed": 4},
            "max_restarts": 1, **extra}


def _jmesh():
    return make_mesh(MeshSpec(dp=1), jax.devices()[:1])


def _both(tmp_path, searcher, *, jax_kw=None, port_kw=None, **extra):
    """One experiment through each package's runner; (results, runners,
    storage dirs)."""
    out = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        raw = _raw(d, searcher, **extra)
        if pkg == "jax":
            runner = JRunner(JConfig.from_dict(raw), JQuadratic,
                             storage_path=str(d), mesh=_jmesh(),
                             **(jax_kw or {}))
        else:
            runner = TRunner(TConfig.from_dict(raw), TQuadratic,
                             storage_path=str(d), device="cpu",
                             **(port_kw or {}))
        out[pkg] = (runner.run(), runner, d)
    return out


def _close(a, b, path="snapshot"):
    if isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= TOL, (path, a, b)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _snapshot(d):
    """``experiment_snapshot.json`` without its paths."""
    with open(d / "experiment_snapshot.json") as f:
        snap = json.load(f)
    for t in snap["trials"].values():
        t["latest_checkpoint"] = t["latest_checkpoint"] is not None
        t["metrics_path"] = os.path.basename(t["metrics_path"] or "")
    return snap


def _same_results(out):
    (jres, _j, jd), (tres, _t, td) = out["jax"], out["port"]
    assert (tres.shutdown, tres.n_trials) == (jres.shutdown, jres.n_trials)
    assert sorted(tres.trials) == sorted(jres.trials)
    for rid, t in tres.trials.items():
        j = jres.trials[rid]
        assert (t.hparams, t.units_done, t.state, t.restarts) == \
            (j.hparams, j.units_done, j.state, j.restarts)
        for key in ("last_metric", "best_metric"):
            a, b = getattr(t, key), getattr(j, key)
            assert (a is None) == (b is None)
            if a is not None:
                assert abs(a - b) <= TOL
    assert (tres.best_trial is None) == (jres.best_trial is None)
    if jres.best_trial is not None:
        assert tres.best_trial.request_id == jres.best_trial.request_id
    _close(_snapshot(td), _snapshot(jd))


@pytest.mark.parametrize("name", ["random", "grid", "asha",
                                  "adaptive_asha"])
def test_search_matches_jax(tmp_path, name):
    out = _both(tmp_path, SEARCHES[name])
    _same_results(out)
    tres = out["port"][0]
    assert tres.shutdown
    assert all(t.state == "completed" for t in tres.trials.values())
    if name == "asha":
        # promoted trials resumed their own rung-0 checkpoint: their
        # reports continue from batch 2 to 6
        promoted = [t for t in tres.trials.values() if t.units_done == 6]
        assert promoted
        for t in promoted:
            with open(t.metrics_path) as f:
                steps = [json.loads(line).get("steps_completed")
                         for line in f]
            assert steps == sorted(steps) and steps[-1] == 6


def _zero_backoff(mod):
    return mod.RetryPolicy(name="test", max_attempts=1, base_delay_s=0.0,
                           max_delay_s=0.0, jitter="none")


def test_restart_matches_jax(tmp_path):
    """A leg that raises once restarts from the same point: one restart,
    the counter at 1, and the same results as the JAX runner's."""
    JQuadratic.fail_once["armed"] = True
    TQuadratic.fail_once["armed"] = True
    out = _both(tmp_path, SEARCHES["single"],
                jax_kw={"restart_backoff": _zero_backoff(jretry)},
                port_kw={"restart_backoff": _zero_backoff(tretry)})
    _same_results(out)
    for res, runner, _d in out.values():
        t = list(res.trials.values())[0]
        assert (t.state, t.restarts) == ("completed", 1)
        assert runner.registry.snapshot()["trial_restarts_total"][
            "value"] == 1


def test_exhausted_restarts_match_jax(tmp_path):
    JQuadratic.fail_once["always"] = TQuadratic.fail_once["always"] = True
    out = _both(tmp_path, SEARCHES["single"],
                jax_kw={"restart_backoff": _zero_backoff(jretry)},
                port_kw={"restart_backoff": _zero_backoff(tretry)})
    _same_results(out)
    t = list(out["port"][0].trials.values())[0]
    assert (t.state, t.restarts) == ("errored", 2)


def _custom(S):
    """A user's search: two trials of fixed ``lr``, one leg each."""

    class Two(S.SearchMethod):
        def __init__(self):
            super().__init__()
            self.done = 0

        def initial_operations(self):
            return [S.Create(-1, {"lr": 0.3}), S.Create(-1, {"lr": 0.7})]

        def on_trial_created(self, request_id):
            return [S.ValidateAfter(request_id, 4)]

        def on_validation_completed(self, request_id, metric, units):
            self.done += 1
            return [S.Close(request_id)] + (
                [S.Shutdown()] if self.done == 2 else [])

        def progress(self):
            return self.done / 2

    return Two()


def test_custom_search_through_local_search_runner(tmp_path):
    results = {}
    for pkg, S in (("jax", jsearch), ("port", tsearch)):
        d = tmp_path / pkg
        d.mkdir()
        raw = _raw(d, {"name": "custom", "metric": "loss",
                       "max_length": {"batches": 4}})
        runner = S.LocalSearchRunner(_custom(S))
        if pkg == "jax":
            res = runner.run(JConfig.from_dict(raw), JQuadratic,
                             storage_path=str(d), mesh=_jmesh())
        else:
            res = runner.run(TConfig.from_dict(raw), TQuadratic,
                             storage_path=str(d), device="cpu")
        results[pkg] = (res, None, d)
    _same_results(results)
    assert results["port"][0].best_trial.hparams == {"lr": 0.3}


def test_runner_refuses_the_card_without_cuda(tmp_path):
    cfg = TConfig.from_dict(_raw(tmp_path, SEARCHES["single"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TRunner(cfg, TQuadratic, storage_path=str(tmp_path))


def _samples():
    """Profiler samples of two trials (registry snapshots and spans) and
    a component registry, from the port's telemetry."""
    tel = Telemetry(enabled=True, ship_spans=True, trace_id="t" * 32,
                    process_name="trial-1")
    reg = tel.registry
    reg.counter("batches_trained_total", "batches").inc(7)
    reg.gauge("samples_per_sec", "throughput").set(123.5)
    h = reg.histogram("train_dispatch_seconds", "step time")
    for v in (0.1, 0.2, 0.4, 0.3):
        h.observe(v)
    with tel.tracer.span("train_dispatch", step=1):
        pass
    with tel.tracer.span("validate"):
        pass

    class Collector:
        def __init__(self):
            self.samples = []

        def record(self, sample):
            self.samples.append(sample)

    c = Collector()
    tel.publish(c, batches_trained=7)
    comp = MetricsRegistry()
    comp.counter("trial_restarts_total", "restarts").inc(2)
    return c.samples, comp.snapshot()


def _feed(master, samples, component):
    master.register_trial(1, 3)
    master.register_trial(2, 3)
    master.ingest_trial(1, samples, idempotency_key="k1")
    master.ingest_trial(1, samples, idempotency_key="k1")   # a duplicate
    master.ingest_trial(2, samples[:1])
    master.ingest_trial(2, ["not a dict", {"group": None}])
    master.ingest_component("runner", component)
    master.ingest_component_spans("runner", samples[1:], experiment_id=3)


def test_inprocess_master_ingestion_matches_jax():
    samples, component = _samples()
    masters = {}
    for pkg, mod in (("jax", jinproc), ("port", tinproc)):
        m = mod.InProcessMaster(clock=lambda: 1000.0)
        _feed(m, samples, component)
        masters[pkg] = m
    j, t = masters["jax"], masters["port"]
    assert t.metrics_text() == j.metrics_text()
    assert t.summary() == j.summary()
    assert t.spans(experiment_id=3) == j.spans(experiment_id=3)
    for path in ("/api/v1/cluster/metrics", "/api/v1/cluster/goodput",
                 "/api/v1/cluster/slo", "/api/v1/experiments/3/trace",
                 "/api/v1/trials/1/trace", "/api/v1/timeseries",
                 "/api/v1/alerts", "/api/v1/nope"):
        assert t.handle("GET", path) == j.handle("GET", path), path
    body = {"samples": samples[:1], "idempotency_key": "k9"}
    assert t.handle("POST", "/api/v1/trials/2/profiler", body) == \
        j.handle("POST", "/api/v1/trials/2/profiler", body)
    assert t.handle("POST", "/api/v1/trials/2/profiler", {}) == \
        j.handle("POST", "/api/v1/trials/2/profiler", {})
    with pytest.raises(tinproc.MasterError) as te:
        tinproc.InProcessSession(t).get("/api/v1/nope")
    from determined_clone_tpu.api.client import MasterError
    with pytest.raises(MasterError) as je:
        jinproc.InProcessSession(j).get("/api/v1/nope")
    assert (str(te.value), te.value.status) == (str(je.value),
                                                je.value.status)


def _http(port, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.read().decode()


def test_inprocess_master_over_http_matches_jax():
    samples, component = _samples()
    texts = {}
    for pkg, mod in (("jax", jinproc), ("port", tinproc)):
        m = mod.InProcessMaster(clock=lambda: 1000.0)
        m.register_trial(1, 3)
        server = mod.serve_http(m)
        try:
            _http(server.port, "POST", "/api/v1/trials/1/profiler",
                  {"samples": samples, "idempotency_key": "a"})
            _http(server.port, "POST", "/api/v1/components/runner/profiler",
                  {"metrics": component, "spans": samples[1:],
                   "experiment_id": 3})
            texts[pkg] = (_http(server.port, "GET", "/metrics"),
                          _http(server.port, "GET",
                                "/api/v1/experiments/3/trace"))
        finally:
            server.stop()
    assert texts["port"] == texts["jax"]
    assert "trial_restarts_total" in texts["port"][0]


def test_timeseries_layer_raises_naming_the_roadmap():
    """The time-series layer is ported: before ``enable_timeseries`` the
    tick and the scraper raise as the JAX master's do, with its message;
    after it, one tick stores the same samples in both."""
    errors = {}
    for pkg, mod in (("jax", jinproc), ("port", tinproc)):
        m = mod.InProcessMaster(clock=lambda: 1000.0)
        errors[pkg] = []
        for call in (m.scrape_tick, m.start_scraper):
            with pytest.raises(RuntimeError) as err:
                call()
            errors[pkg].append(str(err.value))
        m.stop_scraper()   # nothing started: a no-op
        m.enable_timeseries({})
        m.aggregator.ingest_prometheus_text("serving_replica_r0",
                                            "serving_queue_depth 3\n")
        errors[pkg].append((m.scrape_tick()["stored"], m.tsdb.stats()))
        m.stop_scraper()
    assert errors["port"] == errors["jax"]
    assert "enable_timeseries" in errors["port"][0]


# families the JAX trial ships and the port's does not (ROADMAP.md, Queue
# 3, the telemetry differences): no XLA program to size; FLOPs counted by
# FlopCounterMode, which finds none in a scalar loss where XLA's cost
# analysis counts the elementwise ones, so no measured MFU; off the card
# the port's memory record is the host's RSS, not bytes in use
JAX_ONLY_FAMILIES = {
    f"{prefix}{name}" for prefix in ("", "dct_cluster_")
    for name in ("measured_flops_per_sec", "mfu_divergence_total",
                 "mfu_measured", "xla_program_bytes_accessed",
                 "xla_program_temp_bytes")} | {
    "dct_cluster_device_memory_bytes_in_use_avg"}


def test_runner_ships_to_the_master_as_jax(tmp_path):
    """Observability on, an in-process master attached, one restart: the
    port's master sees the same metric families as the JAX one, the
    restart counter, and the runner's ``experiment`` and ``trial_leg``
    lanes under the experiment's one trace id."""
    JQuadratic.fail_once["armed"] = True
    TQuadratic.fail_once["armed"] = True
    masters = {"jax": jinproc.InProcessMaster(),
               "port": tinproc.InProcessMaster()}
    obs = {"enabled": True, "ship_spans": True, "ship_metrics": True}
    _both(tmp_path, SEARCHES["single"], observability=obs,
          jax_kw={"master": masters["jax"],
                  "restart_backoff": _zero_backoff(jretry)},
          port_kw={"master": masters["port"],
                   "restart_backoff": _zero_backoff(tretry)})

    def families(m):
        return {line.split()[2] for line in m.metrics_text().splitlines()
                if line.startswith("# TYPE")}

    port, jax_ = families(masters["port"]), families(masters["jax"])
    assert port <= jax_
    assert jax_ - port == JAX_ONLY_FAMILIES
    text = masters["port"].metrics_text()
    assert 'trial_restarts_total{component="runner"} 1' in text
    spans = masters["port"].spans(experiment_id=1)
    names = {s["name"] for s in spans}
    assert {"experiment", "trial_leg"} <= names
    assert len({s["trace_id"] for s in spans}) == 1
    legs = [s for s in spans if s["name"] == "trial_leg"]
    assert len(legs) == 2   # the failed leg and its restart
