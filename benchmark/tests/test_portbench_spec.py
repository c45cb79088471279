"""The benchmark's definition: BENCHMARK.json against its contract, the
discovery of pieces by name, the frozen counts, the seeded traffic and
the import guard."""
from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest

from benchmark import flops, hw, spec, weights
from benchmark.generators import open_loop_chat
from benchmark.generators.lm_train_stream import LmTrainStream
from benchmark.tests.conftest import REPO, TINY_MODEL

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BANNED = {"jax", "jaxlib", "flax", "determined_clone_tpu"}


def _bench():
    return spec.load_bench(REPO)


def test_benchmark_json_keeps_its_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    assert b["paths"] == ["benchmark"]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert (REPO / c["file"]).is_file()
    names = [c["name"] for c in b["configs"]]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (REPO / "benchmark" / "traffic"
                / f"{w['traffic']}.json").is_file()
        assert spec.limits(w["name"], REPO)
        reported = [m["name"] for m in spec.end_to_end(b, w["name"])]
        assert "setup_s" in reported and len(reported) >= 2
        layer = spec.per_layer(b, w["name"])
        assert layer
        for m in layer:
            assert spec.applies(e2e[m["moves"]], w["name"])
            assert (REPO / "benchmark" / "metrics"
                    / f"{m['name']}.py").is_file()
    assert len(json.dumps(b)) <= 64 * 1024


def test_config_files_state_their_source_and_cuts():
    for c in _bench()["configs"]:
        data = json.loads((REPO / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        for key in ("assumed", "departures", "deployment", "published"):
            assert data[key]


def test_pieces_added_as_files_are_found(tmp_path):
    """A new configuration, mix, metric and cell: files and entries only."""
    root = tmp_path
    (root / "benchmark" / "configs").mkdir(parents=True)
    (root / "benchmark" / "traffic").mkdir()
    (root / "benchmark" / "metrics").mkdir()
    (root / "benchmark" / "limits").mkdir()
    b = _bench()
    b["configs"].append({"name": "new-model", "source": "https://x.org/m",
                         "file": "benchmark/configs/new-model.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "new-cell", "config": "new-model",
                           "traffic": "new-mix", "chips": 1, "why": "t"})
    b["per_layer"].append({"name": "new_metric.x", "unit": "%",
                           "better": "higher", "source": "program_counter",
                           "layer": "device", "moves": "setup_s",
                           "workloads": ["new-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    (root / "benchmark/configs/new-model.json").write_text(
        json.dumps({"n_layers": 3}))
    (root / "benchmark/traffic/new-mix.json").write_text(
        json.dumps({"generator": "lm_train_stream", "driver": "trainer_fit"}))
    (root / "benchmark/limits/new-cell.json").write_text(
        json.dumps({"limits": {"loss_gap": 0.5}}))
    (root / "benchmark/metrics/new_metric.x.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench = spec.load_bench(root)
    cell = spec.cell(bench, "new-cell")
    assert spec.config(bench, cell["config"], root) == {"n_layers": 3}
    assert spec.mix(cell["traffic"], root)["driver"] == "trainer_fit"
    assert spec.limits("new-cell", root) == {"loss_gap": 0.5}
    assert [m["name"] for m in spec.per_layer(bench, "new-cell")] == [
        "new_metric.x"]
    assert spec.reader("new_metric.x", root)(None) == 42.0
    assert "new_metric.x" not in [
        m["name"] for m in spec.per_layer(bench, "train-gpt2xl-t1024")]
    assert spec.driver("trainer_fit").run


def test_frozen_counts_by_hand():
    cfg = dict(TINY_MODEL)            # L 2, d 64, f 128, V 256
    # per token: 2·(8·64² + 4·T·64) + 2·4·64·128 + 2·64·256
    per_tok_t32 = 2 * (8 * 4096 + 4 * 32 * 64) + 2 * 4 * 64 * 128 \
        + 2 * 64 * 256
    assert per_tok_t32 == 180_224
    assert flops.gpt_train_step_flops(cfg, 4, 32) == 3 * 180_224 * 4 * 32
    assert flops.gpt_prefill_flops(cfg, 32) == 180_224 * 32
    decode_c40 = 2 * (8 * 4096 + 4 * 40 * 64) + 2 * 4 * 64 * 128 \
        + 2 * 64 * 256
    assert flops.gpt_decode_flops(cfg, 40) == decode_c40
    assert flops.gpt_request_flops(cfg, 32, 3) == (
        180_224 * 32 + flops.gpt_decode_flops(cfg, 33)
        + flops.gpt_decode_flops(cfg, 34))
    fwd = flops.causal_attention_fwd(8, 25, 1024, 64, 2)
    assert fwd == {"flops": 2 * 8 * 25 * 1024 ** 2 * 64,
                   "bytes": 4 * 8 * 25 * 1024 * 64 * 2}
    bwd = flops.causal_attention_bwd(8, 25, 1024, 64, 2)
    assert bwd == {"flops": 2 * fwd["flops"], "bytes": 2 * fwd["bytes"]}
    kind = "NVIDIA H100 80GB HBM3"
    # the forward at GPT-2 XL's shapes is bound by its bytes: 31.3 µs
    assert hw.roofline_seconds(fwd["flops"], fwd["bytes"], kind) == \
        pytest.approx(104_857_600 / 3.35e12)
    full = json.loads((REPO / "benchmark/configs/gpt2-xl.json").read_text())
    n = sum(int(np.prod(s)) for _, s, _, _ in weights.leaf_specs(full))
    # 80,486,400 in the padded table, 30,740,800 a layer, 3,200 the norm
    assert n == 80_486_400 + 48 * 30_740_800 + 3_200 == 1_556_048_000


def test_traffic_is_seeded_and_the_same_work_for_every_seed():
    cfg = dict(TINY_MODEL)
    mix = json.loads((REPO / "benchmark/traffic/chat_open_loop.json")
                     .read_text())
    a = open_loop_chat.schedule(mix, cfg, 2 ** 31 + 9, 20.0)
    b = open_loop_chat.schedule(mix, cfg, 2 ** 31 + 9, 20.0)
    c = open_loop_chat.schedule(mix, cfg, 5, 20.0)
    assert a == b
    # another seed: other tokens, the same sizes at the same times
    assert [p for _, p, _ in a] != [p for _, p, _ in c]
    assert [(d, len(p), n) for d, p, n in a] == \
        [(d, len(p), n) for d, p, n in c]
    assert all(len(p) + n <= mix["max_total"] for _, p, n in a)
    assert a[-1][0] < 20.0 and len(a) == round(mix["rate_per_s"] * 20)
    tmix = json.loads((REPO / "benchmark/traffic/lm_b8_t1024.json")
                      .read_text())
    tmix.update(global_batch=4, seq_len=32)
    s1, s2 = LmTrainStream(tmix, cfg, 7), LmTrainStream(tmix, cfg, 7)
    assert np.array_equal(s1.batch(3), s2.batch(3))
    assert not np.array_equal(s1.batch(3), s1.batch(4))
    rows = s1.batch(0)
    assert rows.shape == (4, 33) and len({r.tobytes() for r in rows}) == 4
    assert rows.max() < cfg["token_vocab"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def test_no_jax_anywhere_and_nothing_of_the_port_in_the_reference():
    files = list((REPO / "benchmark").rglob("*.py"))
    assert files
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in BANNED, (f, mod)
    for f in (REPO / "benchmark" / "reference").rglob("*.py"):
        for mod in _imports(f):
            assert mod.split(".")[0] != "determined_clone_tpu_torch", (f, mod)
            if mod.startswith("benchmark"):
                assert mod in ("benchmark", "benchmark.weights"), (f, mod)
