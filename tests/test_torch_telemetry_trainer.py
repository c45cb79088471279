"""The port's trial telemetry held against the JAX package's on the CPU:
the ``observability:`` config, device memory, the step-time anomaly
detector, the measured-MFU comparator, the compile capture that stands
in for ``telemetry/xla.py``, the FLOP helpers, and a tiny GPT trial
through both ``Trainer.fit``s with telemetry on.

Tolerance: config fields and errors, detector decisions and events,
gauge values, span names and counts, registry family names and FLOP
counts compare exactly. Reports with telemetry on equal the port's own
telemetry-off run bit for bit (the branch observes, it changes no
number). Device memory is the process's own at two instants, so the
records are compared by their keys and labels, not their byte counts.
"""
import dataclasses
import importlib.util
import logging
import os
import threading
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_clone_tpu import core as jcore
from determined_clone_tpu.config import ConfigError as JConfigError
from determined_clone_tpu.config import ExperimentConfig as JConfig
from determined_clone_tpu.config.experiment import (
    ObservabilityConfig as JObs,
)
from determined_clone_tpu.models import gpt as jgpt
from determined_clone_tpu.parallel import MeshSpec, make_mesh
from determined_clone_tpu.telemetry import Tracer as JTracer
from determined_clone_tpu.telemetry import device as jdevice
from determined_clone_tpu.telemetry import flops as jflops
from determined_clone_tpu.telemetry import metrics as jmetrics
from determined_clone_tpu.telemetry import xla as jxla
from determined_clone_tpu.training import Trainer as JTrainer
from determined_clone_tpu.training import TrialContext as JContext
from determined_clone_tpu_torch import convert
from determined_clone_tpu_torch import core as tcore
from determined_clone_tpu_torch.config import ConfigError as TConfigError
from determined_clone_tpu_torch.config import ExperimentConfig as TConfig
from determined_clone_tpu_torch.config import ObservabilityConfig as TObs
from determined_clone_tpu_torch.examples import gpt_fsdp as tgpt_trial
from determined_clone_tpu_torch.ops.flash_attention import (
    flash_attention,
    kernel_flops,
)
from determined_clone_tpu_torch.telemetry import Telemetry
from determined_clone_tpu_torch.telemetry import Tracer as TTracer
from determined_clone_tpu_torch.telemetry import compile as tcompile
from determined_clone_tpu_torch.telemetry import device as tdevice
from determined_clone_tpu_torch.telemetry import flops as tflops
from determined_clone_tpu_torch.telemetry import metrics as tmetrics
from determined_clone_tpu_torch.telemetry.goodput import check_conservation
from determined_clone_tpu_torch.training import Trainer as TTrainer
from determined_clone_tpu_torch.training import TrialContext as TContext
from determined_clone_tpu_torch.training import trainer as ttrainer_mod

torch.set_num_threads(1)


# -- the observability: block ----------------------------------------------

RULE = {"name": "slow", "kind": "threshold", "series": "step_seconds",
        "value": 2.0}
GOOD_OBS = [
    {},
    {"enabled": True},
    {"enabled": True, "max_events": 10, "ship_spans": True,
     "ship_metrics": False, "trace_path": "/tmp/t.json",
     "flight_dir": "/tmp/f", "flight_segment_events": 4,
     "flight_segments": 2, "goodput_dir": "/tmp/g", "anomaly_window": 4,
     "anomaly_threshold": 0.5, "anomaly_min_samples": 2,
     "timeseries": {"scrape_period_s": 60}, "stale_after_s": 5,
     "rules": [RULE, {"name": "burn", "kind": "burn_rate",
                      "windows": ["5m"], "threshold": 14.4,
                      "series": "dct_slo_burn_rate", "severity": "page"}],
     "stock_slo_rules": True},
]
BAD_OBS = [
    {"max_events": 0}, {"flight_segment_events": 0}, {"flight_segments": 1},
    {"anomaly_window": 3}, {"anomaly_threshold": 0},
    {"anomaly_min_samples": 1}, {"timeseries": [1]}, {"stale_after_s": 0},
    {"rules": [{"kind": "threshold"}]},
    {"rules": [dict(RULE, kind="median")]},
    {"rules": [dict(RULE, severity="sms")]},
    {"rules": [dict(RULE, op="eq")]},
    {"rules": [dict(RULE, reduce="p99")]},
    {"rules": [dict(RULE, value=None)]},
    {"rules": [dict(RULE, colour="red")]},
    {"rules": [{"name": "a", "kind": "absence", "series": "x",
                "stale_s": 0}]},
    {"rules": [{"name": "b", "kind": "burn_rate", "windows": [300],
                "threshold": 2, "bad_series": "bad"}]},
    {"rules": [{"name": "b", "kind": "burn_rate", "windows": [300],
                "threshold": 2, "bad_series": "bad",
                "total_series": "all", "objective": 1.5}]},
    {"rules": [{"name": "b", "kind": "burn_rate", "threshold": 2,
                "series": "s"}]},
    {"rules": [dict(RULE, window_s="soon")]},
    {"rules": ["not a rule"]},
]


@pytest.mark.parametrize("raw", GOOD_OBS, ids=range(len(GOOD_OBS)))
def test_observability_parses_as_jax_does(raw):
    t, j = TObs.from_dict(raw), JObs.from_dict(raw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.to_dict() == j.to_dict()
    # through the experiment config too
    tc, jc = (C.from_dict({"observability": raw}) for C in (TConfig, JConfig))
    assert dataclasses.asdict(tc.observability) == dataclasses.asdict(
        jc.observability)


@pytest.mark.parametrize("raw", BAD_OBS, ids=range(len(BAD_OBS)))
def test_observability_rejects_as_jax_does(raw):
    with pytest.raises(JConfigError) as je:
        JObs.from_dict(raw)
    with pytest.raises(TConfigError) as te:
        TObs.from_dict(raw)
    assert str(te.value) == str(je.value)
    with pytest.raises(TConfigError):
        TConfig.from_dict({"observability": raw})


@pytest.mark.parametrize("raw", [
    {"max_events": "10"}, {"timeseries": {"retention_s": 60}},
    {"enabled": "yes"}, {"rules": [dict(RULE, value="2")]},
    {"rules": [{"name": "b", "kind": "burn_rate", "windows": [300],
                "threshold": 2, "bad_series": "bad", "total_series": "all",
                "objective": 0.99}]},
    {"tracing": True}, [],
], ids=range(7))
def test_experiment_schema_rejects_the_block_as_jax_does(raw):
    """The JAX experiment schema types the block before parsing it (a
    rule's ``objective`` is typed a string there, so a numeric one is
    refused too); the port's config holds the same line."""
    with pytest.raises(JConfigError) as je:
        JConfig.from_dict({"observability": raw})
    with pytest.raises(TConfigError) as te:
        TConfig.from_dict({"observability": raw})
    assert str(te.value) == str(je.value)


# -- device memory (tests/test_device_telemetry.py's cases) -----------------

def _shape(rec):
    return {k: v for k, v in rec.items() if not k.endswith("bytes_in_use")}


def test_cpu_fallback_attributes_rss_once():
    """Off the card the port's snapshot is the JAX CPU fallback's one
    ``rss`` record for the host; the JAX package also gives each virtual
    device a ``live_buffers`` record, which torch has no registry for."""
    port = tdevice.device_memory_snapshot()
    ref = [r for r in jdevice.device_memory_snapshot()
           if r["source"] == "rss"]
    assert [_shape(r) for r in port] == [_shape(r) for r in ref]
    (rec,) = port
    assert rec["device"] == "host" and rec["bytes_in_use"] > 0
    assert rec["peak_bytes_in_use"] >= rec["bytes_in_use"]
    assert tdevice.live_buffer_bytes_by_device() == {}


def test_flat_stats_keep_the_jax_keys():
    port, ref = tdevice.device_memory_stats(), jdevice.device_memory_stats()
    assert set(port) == set(ref)
    assert port["device_bytes_in_use"] > 0 and "device_bytes_limit" in port
    assert port["device_count"] == 0.0   # only the host record off the card


def test_stats_have_the_profiler_sample_keys():
    from determined_clone_tpu.profiler import _device_memory_stats

    assert set(tdevice.device_memory_stats()) == set(_device_memory_stats())


def test_host_rss_readable_on_linux():
    rss = tdevice.host_rss_bytes()
    assert rss is None or rss > 1 << 20
    assert (rss is None) == (jdevice.host_rss_bytes() is None)


def test_snapshot_raises_watermark_and_take_resets():
    tdevice.take_peak_bytes()
    total = sum(r["bytes_in_use"] for r in tdevice.device_memory_snapshot())
    assert tdevice.take_peak_bytes() >= total > 0
    assert tdevice.take_peak_bytes() == 0.0


def test_monitor_take_peak_covers_other_samplers():
    mon = tdevice.DeviceMemoryMonitor()
    mon.take_peak()
    tdevice.device_memory_stats()  # another sampler
    assert mon.take_peak() > 0


def test_sample_feeds_the_jax_gauges():
    regs = {}
    for name, dev, met in (("jax", jdevice, jmetrics),
                           ("port", tdevice, tmetrics)):
        reg = met.MetricsRegistry()
        mon = dev.DeviceMemoryMonitor(reg)
        stats = mon.sample()
        assert mon.take_peak() >= stats["device_bytes_in_use"]
        regs[name] = {(n, lb.get("device"), lb.get("source")) for n, lb, _ in
                      met.parse_prometheus_text(reg.dump())["samples"]}
    assert regs["port"] == {s for s in regs["jax"] if s[2] == "rss"}


def test_registry_free_monitor_still_tracks_peak():
    mon = tdevice.DeviceMemoryMonitor()
    mon.sample()
    assert mon.take_peak() > 0
    tdevice.device_memory_snapshot()
    assert mon.take_peak() > 0


def test_block_until_ready_returns_the_tree():
    tree = ({"a": [torch.ones(2)]}, {"loss": torch.zeros(())})
    assert tdevice.block_until_ready(tree) is tree
    assert tdevice.block_until_ready({}) == {}


# -- anomaly detector and MFU comparator (tests/test_xla_telemetry.py) --------

def _detector_run(mod, met, tracer_cls, durations, **kw):
    reg, tr = met.MetricsRegistry(), tracer_cls()
    det = mod.StepTimeAnomalyDetector(reg, tracer=tr, **kw)
    flags = [det.observe(d) for d in durations]
    events = [(e["name"], e.get("ph"), e["args"]) for e in tr.events()]
    return (flags, list(det.events), det.anomalies, list(det.window),
            det.summary(), reg.counter("step_time_anomalies_total").value,
            events)


@pytest.mark.parametrize("durations,kw,anomalies", [
    ([0.5 if i == 20 else 0.010 + 0.0001 * (i % 3) for i in range(40)],
     dict(window=32, threshold=5.0, min_samples=8), 1),
    ([0.010] * 16 + [0.5] + [0.010] * 4 + [0.5],
     dict(window=32, threshold=5.0, min_samples=8), 2),
    ([5.0, 2.0] + [0.01] * 13, dict(min_samples=16), 0),
    ([0.010] * 16 + [0.012, 0.10],
     dict(window=32, threshold=5.0, min_samples=8, rel_floor=0.05), 1),
    ([0.01] * 10 + [1.0], dict(window=32, min_samples=8), 1),
], ids=["single_spike", "not_admitted", "warmup", "rel_floor", "instant"])
def test_anomaly_detector_matches_jax(durations, kw, anomalies):
    t = _detector_run(tcompile, tmetrics, TTracer, durations, **kw)
    j = _detector_run(jxla, jmetrics, JTracer, durations, **kw)
    assert t == j
    assert t[2] == anomalies


def test_mfu_comparator_gauges_match_jax():
    out = []
    for mod, met in ((tcompile, tmetrics), (jxla, jmetrics)):
        reg = met.MetricsRegistry()
        cmp_ = mod.MfuComparator(reg, peak_flops_total=1e9)
        measured = cmp_.report(measured_flops_per_batch=1e6,
                               batches_per_second=100.0, analytic_mfu=0.1)
        out.append((measured, reg.gauge("measured_flops_per_sec").value,
                    reg.gauge("mfu_measured").value,
                    reg.counter("mfu_divergence_total").value))
    assert out[0] == out[1]
    assert out[0][0] == pytest.approx(0.1) and out[0][3] == 0


def test_mfu_divergence_counts_and_warn_is_rate_limited(caplog):
    counts = []
    for mod, met in ((tcompile, tmetrics), (jxla, jmetrics)):
        reg = met.MetricsRegistry()
        cmp_ = mod.MfuComparator(reg, peak_flops_total=1e9,
                                 warn_period_s=3600.0)
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=mod.__name__):
            for _ in range(5):
                cmp_.report(measured_flops_per_batch=2e6,
                            batches_per_second=100.0, analytic_mfu=0.1)
        counts.append((reg.counter("mfu_divergence_total").value,
                       len([r for r in caplog.records
                            if "diverge" in r.message])))
    assert counts[0] == counts[1] == (5, 1)


def test_new_families_round_trip_through_prometheus_text():
    reg, tr = tmetrics.MetricsRegistry(), TTracer()
    step = tcompile.capture_compile(lambda x: (x * 2.0).sum(),
                                    program="train_step", registry=reg)
    step(torch.ones(8))
    det = tcompile.StepTimeAnomalyDetector(reg, tracer=tr, window=32,
                                           min_samples=8)
    for _ in range(10):
        det.observe(0.01)
    det.observe(1.0)
    tcompile.MfuComparator(reg, peak_flops_total=1e9).report(
        measured_flops_per_batch=1e6, batches_per_second=10.0)
    by_name = {}
    for name, labels, value in tmetrics.parse_prometheus_text(
            reg.dump())["samples"]:
        by_name.setdefault(name, []).append((labels, value))
    for family in ("xla_compile_seconds", "xla_program_flops",
                   "step_time_anomalies_total", "measured_flops_per_sec",
                   "mfu_measured"):
        assert family in by_name, family
    labels, _ = by_name["xla_compile_seconds"][0]
    assert labels["program"] == "train_step"
    assert len(labels["fingerprint"]) == 16


# -- the compile capture (the stand-in for aot_compile) ----------------------

def test_capture_records_the_first_call_and_counts_its_flops():
    """The first call is measured into a CompileRecord, later calls pass
    through; FlopCounterMode's count of a ``[8, 16] @ [16, 4]`` product
    is XLA's cost analysis of the same product, 2·8·16·4."""
    calls = []

    def fn(a, b):
        calls.append(1)
        return a @ b

    reg = tmetrics.MetricsRegistry()
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    step = tcompile.capture_compile(fn, program="probe", registry=reg,
                                    identity={"k": 1})
    assert step.record is None
    assert torch.equal(step(a, b), a @ b)
    rec = step.record
    assert (rec.program, rec.lower_seconds) == ("probe", 0.0)
    assert rec.compile_seconds > 0 and len(rec.fingerprint) == 64
    assert rec.flops == 2 * 8 * 16 * 4
    _, jrec = jxla.aot_compile(jax.jit(lambda x, y: x @ y),
                               (jnp.ones((8, 16)), jnp.ones((16, 4))))
    assert rec.flops == jrec.flops
    step(a, b)
    assert step.record is rec and len(calls) == 2
    assert reg.gauge("xla_program_flops", labels={
        "program": "probe", "fingerprint": rec.fingerprint[:16]}).value == \
        rec.flops
    # the capture inside a dispatch does not count: wrap_jit does
    assert reg.counter("xla_compiles_total").value == 0
    assert set(rec.as_dict()) <= set(jrec.as_dict()) | {"collectives"}


def test_fingerprint_follows_the_step_identity():
    def fp(identity, program="train_step"):
        step = tcompile.capture_compile(lambda x: x + 1, program=program,
                                        identity=identity)
        step(torch.ones(2))
        return step.record.fingerprint

    a = {"hparams": {"d": 64}, "dtypes": ["torch.float32"]}
    assert fp(a) == fp(dict(a))
    assert fp(a) != fp({**a, "dtypes": ["torch.bfloat16"]})
    assert fp(a) != fp(a, program="eval")


def test_explicit_export_counts_and_spans_as_jax_does():
    reg, tr = tmetrics.MetricsRegistry(), TTracer()
    rec = tcompile.CompileRecord(program="train_step", fingerprint="f" * 64,
                                 lower_seconds=0.0, compile_seconds=0.5,
                                 flops=10.0)
    tcompile.export_compile_record(rec, registry=reg, tracer=tr, start=0.0)
    assert reg.counter("xla_compiles_total").value == 1
    (span,) = [e for e in tr.events() if e["name"] == "xla_compile"]
    assert span["args"]["explicit"] is True
    assert span["args"]["fingerprint"] == "f" * 16


def test_flash_flops_on_the_cpu_are_the_plain_version_s_products():
    """On the CPU the plain version runs, and FlopCounterMode counts its
    two products over every computed tile — with one 64-row block the
    whole square, 4·B·H·T²·D (its masking removes no product). On the
    card the kernel adds its causal pairs instead, 4·B·H·D·T(T+1)/2
    (``kernel_flops``); here no kernel launches, so nothing is added."""
    B, T, H, D = 1, 64, 2, 16
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, T, H, D, generator=gen) for _ in range(3))
    step = tcompile.capture_compile(
        lambda: flash_attention(q, k, v, block_q=64, block_k=64))
    step()
    assert step.record.flops == 4 * B * H * T * T * D
    assert kernel_flops(B, H, T, T, D, True) == 4 * B * H * D * T * (T + 1) / 2
    assert kernel_flops(B, H, T, T, D, False) == 4 * B * H * T * T * D


def test_add_flops_only_reaches_a_capture():
    tcompile.add_flops(1e9)   # no capture: nothing to add to
    step = tcompile.capture_compile(lambda: tcompile.add_flops(7.0))
    step()
    assert step.record.flops == 7.0


# -- FLOP helpers --------------------------------------------------------------

def test_dense_flops_match_jax():
    assert tflops.dense_train_flops_per_token(1234) == \
        jflops.dense_train_flops_per_token(1234)
    assert dataclasses.asdict(tflops.dense_train_step_flops(1234, 8, 64)) \
        == dataclasses.asdict(jflops.dense_train_step_flops(1234, 8, 64))


@pytest.mark.parametrize("platform,name,want", [
    ("gpu", "NVIDIA H100 80GB HBM3", (989e12, "gpu:h100")),
    ("gpu", "NVIDIA A100-SXM4-40GB", (989e12, "gpu:h100:assumed")),
    ("cpu", None, (jflops.CPU_PEAK_EST_FLOPS, "cpu:est")),
    (None, None, (jflops.CPU_PEAK_EST_FLOPS, "cpu:est")),
])
def test_peak_flops_estimate(platform, name, want):
    assert tflops.peak_flops_estimate(platform, name) == want


@pytest.mark.parametrize("platform,name,want", [
    ("gpu", "NVIDIA H100 80GB HBM3", (450e9, "gpu:h100:nvlink4")),
    ("gpu", "Other", (450e9, "gpu:h100:nvlink4:assumed")),
    ("cpu", None, jflops.interconnect_bandwidth_estimate("cpu")),
])
def test_interconnect_bandwidth_estimate(platform, name, want):
    assert tflops.interconnect_bandwidth_estimate(platform, name) == want


# -- wrap_jit -------------------------------------------------------------------

def test_wrap_jit_marks_the_first_call_compiled_inside_its_span():
    tel = Telemetry()
    seen = []
    step = tel.wrap_jit("train_dispatch", lambda x: x + 1,
                        sync=tdevice.block_until_ready, observe=seen.append)
    for _ in range(3):
        step(torch.ones(2))
    spans = [e for e in tel.tracer.events() if e["name"] == "train_dispatch"]
    assert [bool((e.get("args") or {}).get("compiled")) for e in spans] == [
        True, False, False]
    assert len(seen) == 2 and tel.compile_count() == 1
    assert [e["name"] for e in tel.tracer.events()].count("xla_compile") == 1
    cats = tel.goodput.snapshot()["categories"]
    assert cats["compile"] > 0 and cats["productive"] > 0


def test_disabled_telemetry_hands_back_the_callable():
    tel = Telemetry(enabled=False)
    fn = lambda x: x  # noqa: E731
    assert tel.wrap_jit("train_dispatch", fn) is fn
    feed = iter([])
    assert tel.wrap_feeder(feed) is feed and tel.goodput is None


# -- a tiny GPT trial through both trainers with telemetry on ----------------

GPT_HP = {"global_batch_size": 4, "vocab_size": 256, "n_layers": 2,
          "d_model": 64, "n_heads": 4, "d_ff": 128, "seq_len": 32,
          "remat": False, "attention_impl": "mha", "lr": 3e-3,
          "n_train_tokens": 3000}
TIMING = ("batches_per_second", "samples_per_second", "flops_per_sec",
          "mfu", "mfu_measured")
# spans of the consumer loop (the producer thread's vary with its timing)
CONSUMER = ("train_dispatch", "eval_dispatch", "validate", "host_sync",
            "checkpoint_save", "dataload_wait", "xla_compile")
# families only the JAX registry has: the executable's cost and memory
# analysis, which an eager step does not have
JAX_ONLY = {"xla_program_bytes_accessed", "xla_program_temp_bytes"}


def _jax_gpt_trial_cls():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "gpt_fsdp", "model_def.py")
    spec = importlib.util.spec_from_file_location("gpt_fsdp_model_def", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.GPTTrial


def _config(storage, telemetry=True):
    return {"searcher": {"name": "single", "metric": "loss",
                         "max_length": {"batches": 10}},
            "scheduling_unit": 5, "min_validation_period": {"batches": 5},
            "min_checkpoint_period": {"batches": 5},
            "checkpoint_storage": {"type": "shared_fs",
                                   "host_path": str(storage)},
            **({"observability": {"enabled": True}} if telemetry else {})}


@pytest.fixture(scope="module")
def jax_init():
    jcfg = jgpt.GPTConfig(vocab_size=256, n_layers=2, d_model=64, n_heads=4,
                          d_ff=128, max_seq_len=32, remat=False,
                          attention_impl="mha", compute_dtype=jnp.float32)
    key = jax.random.split(jax.random.PRNGKey(0))[0]
    return jax.device_get(jax.jit(jgpt.init, static_argnums=1)(key, jcfg))


def _fit(side, storage, init, telemetry=True):
    """One fit; returns (reports, telemetry, goodput snapshot)."""
    if side == "jax":
        base = _jax_gpt_trial_cls()

        class Trial(base):
            def __init__(self, context):
                super().__init__(context)
                self.cfg = dataclasses.replace(self.cfg,
                                               compute_dtype=jnp.float32)
    else:
        class Trial(tgpt_trial.GPTTrial):
            def __init__(self, context):
                super().__init__(context)
                self.cfg = dataclasses.replace(self.cfg,
                                               compute_dtype=torch.float32)

            def initial_params(self, gen):
                return convert.params_from_numpy(init, "cpu")

    raw = _config(storage, telemetry)
    cfg = (JConfig if side == "jax" else TConfig).from_dict(raw)
    mod = jcore if side == "jax" else tcore
    with mod.init(config=cfg, trial_id=1) as ctx:
        if side == "jax":
            tctx = JContext(config=cfg, hparams=GPT_HP, core=ctx,
                            mesh=make_mesh(MeshSpec(dp=1),
                                           jax.devices()[:1]))
            trainer = JTrainer(Trial(tctx))
        else:
            trainer = TTrainer(Trial(TContext(config=cfg, hparams=GPT_HP,
                                              core=ctx, device="cpu")))
        trainer.fit()
        tel = ctx.telemetry
        snap = tel.goodput.snapshot() if tel is not None else None
        records = list(ctx.train._backend.records)
    return records, tel, snap


@pytest.fixture(scope="module")
def runs(jax_init, tmp_path_factory):
    d = tmp_path_factory.mktemp("tel")
    return {"jax": _fit("jax", d / "j", jax_init),
            "port": _fit("port", d / "t", jax_init),
            "port_off": _fit("port", d / "o", jax_init, telemetry=False)}


def _spans(tel):
    return Counter(e["name"] for e in tel.tracer.events())


def test_trainers_span_the_same_names_and_counts(runs):
    (_, jt, _), (_, tt, _) = runs["jax"][:3], runs["port"][:3]
    js, ts = _spans(jt), _spans(tt)
    assert set(ts) == set(js)
    assert {n: ts[n] for n in CONSUMER} == {n: js[n] for n in CONSUMER}
    assert ts["train_dispatch"] == 10 and ts["xla_compile"] == 2
    # the port's first dispatch is its compile; JAX compiles ahead of it
    compiled = [e for e in tt.tracer.events() if e["name"] ==
                "train_dispatch" and (e.get("args") or {}).get("compiled")]
    assert len(compiled) == 1
    assert tt.compile_count() == jt.compile_count() == 2


def test_trainers_fill_the_same_registry_families(runs):
    def families(tel, mod):
        return {n.rsplit("_count", 1)[0].rsplit("_sum", 1)[0]
                for n, _, _ in mod.parse_prometheus_text(
                    tel.registry.dump())["samples"]}

    jf = families(runs["jax"][1], jmetrics)
    tf = families(runs["port"][1], tmetrics)
    # the JAX trial's analytic FLOPs are 1/seq_len of the real ones, so
    # its comparator counts a divergence; the port's agree (ROADMAP.md,
    # Queue 3, recorded departures)
    assert "mfu_divergence_total" in jf
    assert tf == jf - JAX_ONLY - {"mfu_divergence_total"}
    assert {"mfu", "mfu_measured", "mfu_peak_info", "goodput_fraction",
            "device_memory_peak_bytes", "preempt_poll_failures"} <= tf


def test_trainers_count_the_same_analytic_step_flops(runs):
    def step_flops(records):
        return [r["metrics"]["flops_per_sec"] /
                r["metrics"]["batches_per_second"]
                for r in records if r["group"] == "training"]

    j, t = step_flops(runs["jax"][0]), step_flops(runs["port"][0])
    # the port's GPT trial counts the GPT's analytic FLOPs over every
    # token (``train_step_flops``), equal to the JAX package's own
    # ``gpt_train_step_flops``; the JAX trial gives no count and its
    # trainer falls back to dense_6n over one token a sample (ROADMAP.md,
    # Queue 3, recorded departures)
    jcfg = jgpt.GPTConfig(vocab_size=256, n_layers=2, d_model=64, n_heads=4,
                          d_ff=128, max_seq_len=32)
    want = jflops.gpt_train_step_flops(jcfg, 4, GPT_HP["seq_len"]).total
    assert t == pytest.approx([want, want], rel=1e-12)
    n_params = sum(int(np.prod(np.shape(x)))
                   for x in jax.tree.leaves(runs["init"]))
    assert j == pytest.approx([6.0 * n_params * 4] * 2, rel=1e-12)


@pytest.fixture(scope="module", autouse=True)
def _init_in_runs(runs, jax_init):
    runs["init"] = jax_init


def test_peak_info_labels_the_cpu_estimate(runs):
    reg = runs["port"][1].registry
    text = reg.dump()
    assert 'mfu_peak_info{assumed="cpu:est",flops_source="analytic"} 1' in \
        text
    assert reg.gauge("mfu_peak_flops").value == tflops.CPU_PEAK_EST_FLOPS


def test_goodput_books_balance_in_both_trainers(runs):
    for side in ("jax", "port"):
        snap = runs[side][2]
        assert check_conservation(snap)["ok"], (side, snap)
        assert snap["categories"]["productive"] > 0
    cats = runs["port"][2]["categories"]
    assert cats["compile"] > 0 and cats["checkpoint_save"] > 0


def test_reports_equal_the_telemetry_off_run(runs):
    def reports(records):
        return [(r["group"], r["steps_completed"],
                 {k: v for k, v in r["metrics"].items() if k not in TIMING})
                for r in records]

    on, off = reports(runs["port"][0]), reports(runs["port_off"][0])
    assert on == off and len(on) == 5
    assert runs["port_off"][1] is None


def test_disabled_path_builds_no_wrapper(tmp_path, jax_init, monkeypatch):
    """Telemetry off: no capture, no traced feeder, no tracer in the
    feeders — the loop runs the steps and feeder it built."""
    def refuse(*a, **k):
        raise AssertionError("the disabled path built a wrapper")

    monkeypatch.setattr(ttrainer_mod, "capture_compile", refuse)
    monkeypatch.setattr(Telemetry, "wrap_jit", refuse)
    monkeypatch.setattr(Telemetry, "wrap_feeder", refuse)
    seen = []
    real = ttrainer_mod.make_device_feeder

    def spy(*a, **k):
        seen.append((k.get("tracer"), k.get("registry")))
        return real(*a, **k)

    monkeypatch.setattr(ttrainer_mod, "make_device_feeder", spy)
    records, tel, _ = _fit("port", tmp_path, jax_init, telemetry=False)
    assert tel is None and records
    assert seen and all(s == (None, None) for s in seen)


def test_no_prefetch_thread_survives(runs):
    alive = [t.name for t in threading.enumerate()
             if "prefetch" in t.name and t.is_alive()]
    assert alive == []


def test_chrome_trace_of_a_fit_validates(runs, tmp_path):
    from determined_clone_tpu_torch.telemetry import validate_chrome_trace

    path = runs["port"][1].export_chrome_trace(str(tmp_path / "trace.json"))
    import json

    with open(path) as f:
        assert validate_chrome_trace(json.load(f)) == []
