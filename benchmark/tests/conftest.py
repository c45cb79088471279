"""Fixtures of the benchmark's CPU tests: a checkout root holding the
benchmark's files with the cells cut to a size a CPU runs in seconds.

Run from the root of the repository: ``python -m pytest benchmark/tests``.
Tests marked ``cuda`` need the card and skip without one.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]

TINY_MODEL = dict(n_layers=2, d_model=64, n_heads=4, head_dim=16, d_ff=128,
                  max_seq_len=128, vocab_size=256, token_vocab=250)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped where there is none")


def _edit(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    for key, value in changes.items():
        if isinstance(value, dict) and isinstance(data.get(key), dict):
            data[key].update(value)
        else:
            data[key] = value
    path.write_text(json.dumps(data))


def make_tiny_root(dest: Path, compute_dtype: str = "float32") -> Path:
    """A copy of the benchmark's data files under ``dest``, every
    configuration cut to a two-layer model of width 64 and every mix to
    a few short requests or batches."""
    bench = dest / "benchmark"
    bench.mkdir(parents=True)
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(REPO / "benchmark" / d, bench / d)
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    for cfg in (bench / "configs").glob("*.json"):
        _edit(cfg, compute_dtype=compute_dtype, **TINY_MODEL)
    for mix in (bench / "traffic").glob("*.json"):
        kind = json.loads(mix.read_text())["generator"]
        if kind == "lm_train_stream":
            _edit(mix, global_batch=4, seq_len=32)
        elif kind == "open_loop_chat":
            _edit(mix, rate_per_s=20.0, prompt_median=20, prompt_min=4,
                  prompt_max=60, output_median=8, output_min=2,
                  output_max=16, max_total=128, check_min_tokens=40,
                  trace_extra_s=1.0,
                  serving={"max_batch": 4, "max_prefill_len": 32,
                           "chunk_prefill_len": 32, "kv_blocks": 64})
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    torch.set_num_threads(2)
    return make_tiny_root(tmp_path / "checkout")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.device("cuda", 0)
