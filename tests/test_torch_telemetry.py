"""The port's own copies of the JAX package's pure-Python telemetry —
the metrics registry with its Prometheus text, the span tracer — and
the serving FLOP counts, held against the JAX package's modules.

Tolerance: none. The same scripted calls must give byte-equal
Prometheus text, equal parses, equal snapshots and span records (less
their clock readings), and FLOP counts equal as floats.
"""
import dataclasses

import pytest

from determined_clone_tpu.telemetry import flops as jflops
from determined_clone_tpu.telemetry import metrics as jmetrics
from determined_clone_tpu.telemetry import spans as jspans
from determined_clone_tpu_torch.models import gpt as tgpt
from determined_clone_tpu_torch.telemetry import flops as tflops
from determined_clone_tpu_torch.telemetry import metrics as tmetrics
from determined_clone_tpu_torch.telemetry import spans as tspans


def _script(mod):
    """One scripted series of counter, gauge and histogram calls."""
    reg = mod.MetricsRegistry(prefix="dct_")
    c = reg.counter("requests_total", "requests\nserved",
                    labels={"route": 'gen"erate'})
    c.inc()
    c.inc(2.5)
    g = reg.gauge("queue_depth", "waiting")
    g.set(7)
    g.inc(3)
    g.dec(0.5)
    h = reg.histogram("latency_seconds", "submit → done",
                      reservoir_size=16)
    for i in range(40):
        h.observe((i * 37 % 101) / 100.0,
                  exemplar=f"req-{i}" if i % 7 == 0 else None)
    reg.histogram("empty_seconds", "never observed")
    assert reg.counter("requests_total",
                       labels={"route": 'gen"erate'}) is c
    return reg, h


def test_prometheus_text_is_byte_equal_and_parses_alike():
    mine, mh = _script(tmetrics)
    ref, rh = _script(jmetrics)
    text = mine.dump()
    assert text == ref.dump()
    # compared as text: an empty histogram's quantiles are NaN, and
    # NaN != NaN
    assert repr(tmetrics.parse_prometheus_text(text)) == \
        repr(jmetrics.parse_prometheus_text(text))
    assert mine.snapshot() == ref.snapshot()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert mh.percentile(q) == rh.percentile(q)
    assert (mh.count, mh.sum) == (rh.count, rh.sum)
    assert mh.exemplars() == rh.exemplars()
    assert mh.max_exemplar() == rh.max_exemplar()
    samples = tmetrics.parse_prometheus_text(text)["samples"]
    assert ("dct_requests_total", {"route": 'gen"erate'}, 3.5) in samples


def test_registry_refuses_and_sanitises_as_jax():
    for mod in (tmetrics, jmetrics):
        reg = mod.MetricsRegistry()
        reg.counter("x_total")
        with pytest.raises(TypeError, match="already registered"):
            reg.gauge("x_total")
        with pytest.raises(ValueError, match="cannot decrease"):
            reg.counter("x_total").inc(-1)
        assert mod.Counter("9 bad-name").name == "_9_bad_name"


def _trace(mod):
    tr = mod.Tracer(max_events=4)
    with tr.span("outer", step=1):
        with tr.span("inner") as s:
            s.set(rows=3)
        tr.instant("marker", request_id="r1")
    tr.record_span("derived", 0.0, 0.25, tokens=8)
    tr.instant("dropped")
    off = mod.Tracer(enabled=False)
    with off.span("nothing"):
        off.instant("nothing")
    assert off.events() == []
    return tr


def test_tracer_records_as_jax():
    mine, ref = _trace(tspans), _trace(jspans)

    def strip(events):
        return [{k: v for k, v in e.items() if k not in ("ts_us", "tid")}
                | ({"dur_us": 0.0} if e["name"] != "derived" else {})
                for e in events]
    assert strip(mine.events()) == strip(ref.events())
    assert mine.dropped == ref.dropped == 1
    assert sorted(mine.span_summary()) == sorted(ref.span_summary())
    with tspans.null_span("x", a=1) as s:
        s.set(b=2)


@dataclasses.dataclass
class _Cfg:
    d_model: int = 4
    d_ff: int = 8
    n_layers: int = 2
    vocab_size: int = 16


@pytest.mark.parametrize("cfg", [_Cfg(), tgpt.GPTConfig(),
                                 tgpt.GPTConfig.tiny()])
def test_serving_flops_equal_jax(cfg):
    for p in (1, 10, 128, 1000):
        assert tflops.gpt_prefill_flops(cfg, p) == \
            jflops.gpt_prefill_flops(cfg, p)
        assert tflops.gpt_decode_flops_per_token(cfg, p) == \
            jflops.gpt_decode_flops_per_token(cfg, p)
        for n, skip in ((1, 0), (32, 0), (8, p // 2), (4, p + 5)):
            assert tflops.gpt_generation_flops(
                cfg, p, n, prefill_from=skip) == jflops.gpt_generation_flops(
                cfg, p, n, prefill_from=skip)
        for k in (1, 4):
            assert tflops.gpt_verify_flops(cfg, p, k) == \
                jflops.gpt_verify_flops(cfg, p, k)
            assert tflops.gpt_speculative_step_flops(cfg, _Cfg(), p, k) \
                == jflops.gpt_speculative_step_flops(cfg, _Cfg(), p, k)
    # the worked example: decode at context 10 and 11 costs 960 and 992
    if isinstance(cfg, _Cfg):
        assert tflops.gpt_verify_flops(cfg, 10, 1)["total"] == 1952
