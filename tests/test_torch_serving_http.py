"""The port's HTTP front-end and ``serve`` command on the CPU, held
against the JAX package's server: the same probes to both give the same
status codes, headers and JSON fields; the port's ``/metrics`` parses
and agrees with ``stats()``; ``serve --selftest --device cpu`` exits 0,
and without ``--device cpu`` it refuses to start where there is no card.

Tolerance: tokens compared exactly (fp32 on the same converted weights;
the frameworks differ only in summation order, far below the logit gaps
of these prompts).
"""
import dataclasses
import http.client
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from determined_clone_tpu.models import gpt as jgpt
from determined_clone_tpu.serving import bucketing as jbucket
from determined_clone_tpu.serving import engine as jengine
from determined_clone_tpu.serving import http as jhttp
from determined_clone_tpu.serving import kv_cache as jkv
from determined_clone_tpu_torch import convert
from determined_clone_tpu_torch.models import gpt as tgpt
from determined_clone_tpu_torch.serving import (
    BucketSpec,
    InferenceEngine,
    KVCacheConfig,
)
from determined_clone_tpu_torch.serving.http import (
    ServingHTTPServer,
    generate_over_http,
)
from determined_clone_tpu_torch.telemetry.metrics import parse_prometheus_text

torch.set_num_threads(1)
if torch.get_num_interop_threads() != 1:
    try:
        torch.set_num_interop_threads(1)
    except RuntimeError:  # already fixed once inter-op work has run here
        pass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = dataclasses.replace(jgpt.GPTConfig.tiny(), compute_dtype=jnp.float32,
                           attention_impl="mha", max_seq_len=48)
TCFG = dataclasses.replace(tgpt.GPTConfig.tiny(), compute_dtype=torch.float32,
                           attention_impl="mha", max_seq_len=48)
POOL = dict(num_blocks=16, block_size=8)
PROMPTS = [[5, 17, 3, 88, 41], [9] * 11, [1, 2, 3]]


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(jgpt.init, static_argnums=1)(jax.random.PRNGKey(0), JCFG)
    jp = jax.tree_util.tree_map(lambda x: x * 10.0, jp)  # not an echo model
    return jp, convert.params_from_numpy(jax.device_get(jp), "cpu")


def engines(params, **kw):
    jp, tp = params
    return (jengine.InferenceEngine(
                jp, JCFG, buckets=jbucket.BucketSpec.build(4, 16),
                cache=jkv.KVCacheConfig(**POOL), **kw),
            InferenceEngine(tp, TCFG, buckets=BucketSpec.build(4, 16),
                            cache=KVCacheConfig(**POOL), device="cpu", **kw))


TOO_LARGE = object()  # a body announced above the server's limit


def probe(url, path, body=None):
    """(status, headers, parsed JSON or text) of one request. TOO_LARGE
    announces a 2 MiB body and sends none: the server must refuse it on
    the header alone (sending it would race the server's early reply)."""
    host, port = url.rsplit("/", 1)[-1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        if body is None:
            conn.request("GET", path)
        elif body is TOO_LARGE:
            conn.putrequest("POST", path)
            conn.putheader("Content-Length", str(2 << 20))
            conn.endheaders()
        else:
            data = body if isinstance(body, bytes) \
                else json.dumps(body).encode()
            conn.request("POST", path, body=data,
                         headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        code, headers, raw = resp.status, resp.headers, resp.read()
    finally:
        conn.close()
    ctype = headers.get("Content-Type", "")
    return code, headers, (json.loads(raw) if "json" in ctype
                           else raw.decode())


def shape(obj):
    """Keys and value types, recursively — the fields, not the values."""
    if isinstance(obj, dict):
        return {k: shape(v) for k, v in obj.items()}
    return type(obj).__name__


def test_http_matches_jax_status_codes_and_fields(params):
    je, te = engines(params, prefix_cache=True)
    with je, te, jhttp.ServingHTTPServer(je) as js, \
            ServingHTTPServer(te) as ts:
        good = {"prompt": PROMPTS[1], "max_new_tokens": 5}
        cases = [("/v1/generate", good), ("/v1/generate", good),
                 ("/v1/generate", {"prompt": "nope"}),
                 ("/v1/generate", {"prompt": [1] * 40,
                                   "max_new_tokens": 20}),
                 ("/v1/generate", b"{not json"),
                 ("/v1/generate", TOO_LARGE),
                 ("/v1/other", good), ("/nope", None)]
        for path, body in cases:
            jc, _, jout = probe(js.url, path, body)
            tc, _, tout = probe(ts.url, path, body)
            assert tc == jc, (path, tc, jc)
            assert shape(tout) == shape(jout), path
            if tc == 200:
                assert tout["tokens"] == jout["tokens"]
                assert tout["latency"]["prefix_hit_blocks"] == \
                    jout["latency"]["prefix_hit_blocks"]
        assert [c for c, _, _ in (probe(ts.url, p, b) for p, b in
                                  cases[2:])] == [400, 400, 400, 413, 404,
                                                  404]
        jc, _, jh = probe(js.url, "/healthz")
        tc, _, th = probe(ts.url, "/healthz")
        assert tc == jc == 200 and th["ok"] and th["stats"]["completed"] == 2
        # the JAX stats add the KV tiers' counters, not ported yet
        assert set(th["stats"]) <= set(jh["stats"])


def test_http_generate_speed_fields_metrics_and_overload(params):
    """Three generations return their tokens with the latency.spec_*
    fields; /metrics parses and its counters agree with stats(); a full
    queue answers 429 with Retry-After."""
    _, tp = params
    with InferenceEngine(tp, TCFG, buckets=BucketSpec.build(4, 16),
                         cache=KVCacheConfig(**POOL), device="cpu",
                         speculative_k=2, draft_params=tp,
                         draft_cfg=TCFG) as te, ServingHTTPServer(te) as ts:
        outs = [generate_over_http(ts.url, p, max_new_tokens=4)
                for p in PROMPTS]
        for p, out in zip(PROMPTS, outs):
            assert len(out["tokens"]) == 4 and out["prompt_len"] == len(p)
            lat = out["latency"]
            assert lat["spec_proposed"] >= lat["spec_accepted"] >= 0
            assert lat["spec_acceptance"] == 1.0  # the draft is the target
        code, headers, text = probe(ts.url, "/metrics")
        stats = te.stats()
    assert code == 200 and headers["Content-Type"].startswith("text/plain")
    values = {name: v for name, labels, v in
              parse_prometheus_text(text)["samples"] if not labels}
    assert values["serving_requests_completed_total"] == stats.completed == 3
    assert values["serving_tokens_generated_total"] == \
        stats.tokens_generated == 12
    assert values["serving_spec_tokens_proposed_total"] == \
        stats.spec_tokens_proposed > 0
    assert values["serving_free_kv_blocks"] == stats.free_blocks

    with InferenceEngine(tp, TCFG, buckets=BucketSpec.build(4, 16),
                         cache=KVCacheConfig(**POOL), device="cpu",
                         max_queue_depth=0) as te, \
            ServingHTTPServer(te) as ts:
        code, headers, out = probe(ts.url, "/v1/generate",
                                   {"prompt": [1, 2], "max_new_tokens": 2})
        assert code == 429 and headers["Retry-After"] == "1"
        assert "queue full" in out["error"]
        assert te.stats().rejected == 1


def _serve(*args):
    # no card visible, whatever the machine has
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "determined_clone_tpu_torch.cli", "serve",
         *args], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)


def test_serve_selftest_on_the_cpu(tmp_path):
    cfg = tmp_path / "serve.yaml"
    cfg.write_text("serving:\n  max_batch: 4\n  max_prefill_len: 32\n"
                   "  prefix_cache: true\n  chunk_prefill_len: 16\n"
                   "  speculative: {enabled: true, k: 2}\n")
    run = _serve("--selftest", "--device", "cpu", "--config", str(cfg))
    assert run.returncode == 0, run.stderr
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["selftest"] == "ok" and out["device"] == "cpu"
    stats = out["stats"]
    assert stats["completed"] == 3 and stats["tokens_generated"] == 12
    assert stats["programs_compiled"] == stats["program_budget"]
    assert "warmup:" in run.stderr


def test_serve_needs_cuda_unless_cpu_is_asked():
    run = _serve("--selftest")
    assert run.returncode != 0
    assert "device='cpu'" in run.stderr
    run = _serve("--selftest", "--device", "cpu", "--model", "huge")
    assert run.returncode == 2
