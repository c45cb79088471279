"""The port's mesh telemetry held against the JAX package's on the CPU:
the cross-device straggler detector, per-device Chrome lanes, the
MULTICHIP artifact schema and the collective summary on the same
inputs; then, on two gloo ranks, the recorder that stands in for the
HLO parser inside ``Trainer.fit`` (its counts and bytes against what the
gradient tree and the per-layer FSDP gathers predict), and the scaling
bench, whose artifact both packages' ``validate_multichip`` accept.

Tolerance: detector decisions, events and gauges, lane records, stitched
traces, validation messages, rendered text, summaries, fingerprints and
the comm/compute fraction compare exactly (the same float arithmetic).
The recorder's counts and bytes are exact.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from determined_clone_tpu_torch import core as tcore  # noqa: E402
from determined_clone_tpu_torch.config import (  # noqa: E402
    ExperimentConfig as TConfig,
)
from determined_clone_tpu_torch.examples import gpt_fsdp  # noqa: E402
from determined_clone_tpu_torch.exec import launch  # noqa: E402
from determined_clone_tpu_torch.models import gpt as tgpt  # noqa: E402
from determined_clone_tpu_torch.telemetry import collectives as tcoll  # noqa: E402
from determined_clone_tpu_torch.telemetry import flops as tflops  # noqa: E402
from determined_clone_tpu_torch.telemetry import mesh as tmesh  # noqa: E402
from determined_clone_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402
from determined_clone_tpu_torch.telemetry.chrome_trace import (  # noqa: E402
    stitch_chrome_trace as t_stitch,
)
from determined_clone_tpu_torch.training import Trainer as TTrainer  # noqa: E402
from determined_clone_tpu_torch.training import (  # noqa: E402
    TrialContext as TContext,
)
from determined_clone_tpu_torch.training import optim  # noqa: E402

if __name__ != "__main__":  # the ranks never import JAX
    from determined_clone_tpu.telemetry import collectives as jcoll
    from determined_clone_tpu.telemetry import mesh as jmesh
    from determined_clone_tpu.telemetry import metrics as jmetrics
    from determined_clone_tpu.telemetry.chrome_trace import (
        stitch_chrome_trace as j_stitch,
        validate_chrome_trace as j_validate,
    )

    from tests.test_torch_parallel import launch_ranks

torch.set_num_threads(1)

HP = {"global_batch_size": 4, "vocab_size": 256, "n_layers": 2,
      "d_model": 64, "n_heads": 4, "d_ff": 128, "seq_len": 32,
      "remat": True, "attention_impl": "mha", "lr": 1e-4,
      "n_train_tokens": 3000}


# -- the straggler detector (tests/test_mesh_observability.py's cases) ------

def _straggler_run(mod, met, windows, **kw):
    reg = met.MetricsRegistry()
    det = mod.MeshStragglerDetector(reg, **kw)
    flagged = [det.observe(w) for w in windows]
    return (flagged, det.stragglers, det.windows, det.by_device,
            det.summary(), reg.dump())


def _cpu(n, v=0.10, **over):
    return {**{f"cpu:{i}": v for i in range(n)}, **over}


STRAGGLER_CASES = {
    "uniform": [{f"cpu:{i}": 0.10 + 0.001 * i for i in range(8)}] * 5,
    "one_slow": [_cpu(8), _cpu(8, **{"cpu:5": 0.50})],
    "slowest_of_two": [_cpu(8, **{"cpu:2": 0.40, "cpu:6": 0.60})],
    "globally_slow": [_cpu(8), _cpu(8, 0.50)],
    "min_devices": [{"cpu:0": 9.0}],
    "summary": [_cpu(4), _cpu(4, **{"cpu:1": 1.0})],
}
STRAGGLER_WANT = {"uniform": 0, "one_slow": 1, "slowest_of_two": 1,
                  "globally_slow": 0, "min_devices": 0, "summary": 1}


def test_straggler_detector_matches_jax():
    for name, windows in STRAGGLER_CASES.items():
        t = _straggler_run(tmesh, tmetrics, windows)
        j = _straggler_run(jmesh, jmetrics, windows)
        assert t == j, name
        assert t[1] == STRAGGLER_WANT[name], name
    t = _straggler_run(tmesh, tmetrics, STRAGGLER_CASES["one_slow"])
    assert t[0] == [None, "cpu:5"] and t[3] == {"cpu:5": 1}
    assert 'mesh_straggler_events_total{device="cpu:5"} 1' in t[5]


def test_straggler_detector_on_rank_keys():
    """The port's keys are ``gpu:{rank}``; a straggling rank is flagged
    under its key exactly as JAX flags a device."""
    windows = [{f"gpu:{r}": 0.2 for r in range(4)},
               {**{f"gpu:{r}": 0.2 for r in range(4)}, "gpu:3": 0.9}]
    t = _straggler_run(tmesh, tmetrics, windows)
    assert t == _straggler_run(jmesh, jmetrics, windows)
    assert t[0] == [None, "gpu:3"]


# -- per-device lanes -------------------------------------------------------

def test_device_lane_records_and_stitched_trace_match_jax():
    durations = {f"gpu:{i}": 0.01 * (i + 1) for i in range(4)}
    recs = tmesh.device_lane_records(durations, start_s=0.0,
                                     wall_epoch=100.0, step_index=3)
    assert recs == jmesh.device_lane_records(durations, start_s=0.0,
                                             wall_epoch=100.0, step_index=3)
    trace = t_stitch(recs)
    assert trace == j_stitch(recs) and j_validate(trace) == []
    procs = {e["args"]["name"] for e in trace["traceEvents"]
             if e.get("name") == "process_name"}
    assert procs == {f"device:gpu:{i}" for i in range(4)}


def test_device_key_fallback_without_process_label():
    recs = tmesh.device_lane_records({"gpu:0": 0.1, "gpu:1": 0.1},
                                     start_s=0.0)
    for r in recs:
        r.pop("process")
    trace = t_stitch(recs)
    assert trace == j_stitch(recs)
    assert {e["args"]["name"] for e in trace["traceEvents"]
            if e.get("name") == "process_name"} == {"device:gpu:0",
                                                    "device:gpu:1"}


class _FakeDist:
    """``DistributedContext.allgather`` of a world whose other ranks
    reported ``others``."""

    def __init__(self, others):
        self.others = others

    def allgather(self, obj):
        return [obj] + self.others


def test_rank_step_timer_and_gather_on_the_cpu():
    timer = tmesh.RankStepTimer("cpu")
    for _ in range(3):
        timer.start()
        torch.ones(64, 64) @ torch.ones(64, 64)
        timer.stop()
    mine = timer.take()
    assert len(mine) == 3 and all(s >= 0 for s in mine)
    assert timer.take() == []
    windows = tmesh.rank_step_seconds(_FakeDist([[0.5, 0.5, 0.5]]), mine,
                                      "cpu")
    assert [sorted(w) for w in windows] == [["cpu:0", "cpu:1"]] * 3
    assert [w["cpu:1"] for w in windows] == [0.5] * 3


# -- the MULTICHIP artifact schema ------------------------------------------

def _artifact():
    return {
        "schema_version": tmesh.MULTICHIP_SCHEMA_VERSION,
        "n_devices": 4, "platform": "gpu",
        "baseline": {"throughput_samples_per_sec": 80.0,
                     "mfu_measured": 0.06, "mfu_analytic": 0.08},
        "meshes": {"dp": {
            "mesh_shape": {"dp": 4, "tp": 1}, "scaling_efficiency": 0.15,
            "throughput_samples_per_sec": 95.0, "mfu_measured": 0.009,
            "mfu_analytic": 0.011, "program_fingerprint": "aaaa",
            "comm_compute_fraction": 0.01,
            "straggler": {"windows": 2, "stragglers": 1,
                          "by_device": {"gpu:2": 1}},
            "collectives": {"fingerprint": "ffff", "ops": {"all-reduce": {
                "dp": {"count": 17, "bytes": 1.0}}}}}},
        "per_device_peak_bytes": {f"gpu:{i}": 1000.0 for i in range(4)},
    }


def _broken(edit):
    art = _artifact()
    edit(art)
    return art


@pytest.fixture(params=range(6), ids=["valid", "not_object", "version",
                                      "no_meshes", "efficiency", "peaks"])
def artifact(request):
    return [_artifact(), [],
            _broken(lambda a: a.update(schema_version=99)),
            _broken(lambda a: a.update(meshes={})),
            _broken(lambda a: a["meshes"]["dp"].update(
                scaling_efficiency="fast")),
            _broken(lambda a: a.update(
                per_device_peak_bytes={"gpu:0": "big"}))][request.param]


def test_validate_multichip_matches_jax(artifact):
    errors = tmesh.validate_multichip(artifact)
    assert errors == jmesh.validate_multichip(artifact)
    assert (errors == []) == (artifact == _artifact())


def test_format_multichip_matches_jax():
    text = tmesh.format_multichip(_artifact())
    assert text == jmesh.format_multichip(_artifact())
    assert "4 x gpu devices" in text and "all-reduce[dp]=17" in text
    assert "stragglers: 1 over 2 windows" in text


def test_bench_gate_reads_a_port_artifact():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        from bench_gate import gate
    finally:
        sys.path.pop(0)
    mc = {"runs": {"4": _artifact()}}
    base = {"metric": "m", "value": 1.0,
            "detail": {"platform": "gpu", "mfu": 0.1, "multichip": mc}}
    worse = json.loads(json.dumps(base))
    worse["detail"]["multichip"]["runs"]["4"]["meshes"]["dp"][
        "scaling_efficiency"] = 0.05
    ok, report = gate(base, worse)
    assert not ok and any("FAIL: multichip" in ln for ln in report)
    assert gate(base, json.loads(json.dumps(base)))[0]


# -- the collective summary ---------------------------------------------------

OPS = [("all-reduce", "dp", 512.0), ("all-reduce", "dp", 4.0),
       ("all-gather", "fsdp", 4096.0), ("all-to-all", "sp", 64.0),
       ("collective-permute", "pp", 256.0), ("all-reduce", "dp+fsdp", 4.0)]


def _summary(mod, ops=OPS, n=8):
    s = mod.CollectiveSummary(n_partitions=n)
    for kind, axis, b in ops:
        s.add(kind, axis, b)
    return s


def test_collective_summary_matches_jax():
    t, j = _summary(tcoll), _summary(jcoll)
    assert t.as_dict() == j.as_dict()
    assert t.fingerprint() == j.fingerprint()
    assert (t.total_ops, t.total_bytes) == (j.total_ops, j.total_bytes) == (
        6, 4936.0)
    for kind, axis, _ in OPS:
        assert t.count(kind, axis) == j.count(kind, axis)
        assert t.bytes(kind) == j.bytes(kind)
    assert _summary(tcoll, OPS[:-1]).fingerprint() != t.fingerprint()
    assert tcoll.COLLECTIVE_KINDS == jcoll.COLLECTIVE_KINDS
    assert tcoll.mesh_axis_sizes({"dp": 2, "tp": "4"}) == \
        jcoll.mesh_axis_sizes({"dp": 2, "tp": "4"})


def test_comm_compute_fraction_and_export_match_jax():
    kw = dict(interconnect_bytes_per_s=450e9, peak_flops_per_s=989e12)
    t, j = _summary(tcoll), _summary(jcoll)
    for flops in (None, 0.0, 1e6, 3.3e12):
        assert tcoll.comm_compute_fraction(t, flops, **kw) == \
            jcoll.comm_compute_fraction(j, flops, **kw)
    frac = tcoll.comm_compute_fraction(t, 1e6, **kw)
    assert 0.0 < frac < 1.0
    dumps = []
    for mod, met, s in ((tcoll, tmetrics, t), (jcoll, jmetrics, j)):
        reg = met.MetricsRegistry()
        mod.export_collectives(s, reg, program="train_step",
                               fingerprint="abcd", comm_fraction=frac)
        dumps.append(reg.dump())
    assert dumps[0] == dumps[1]


def test_recorder_is_idle_outside_a_capture():
    tcoll.note("all-reduce", None, 1e9)   # nothing records it
    assert tcoll._ACTIVE is None


# -- two gloo ranks: the recorder inside Trainer.fit, and the bench ----------

def _fit_config(storage, mesh):
    return {"searcher": {"name": "single", "metric": "loss",
                         "max_length": {"batches": 2}},
            "scheduling_unit": 2, "checkpoint_policy": "none",
            "checkpoint_storage": {"type": "shared_fs",
                                   "host_path": str(storage)},
            "resources": {"slots_per_trial": 2},
            "observability": {"enabled": True},
            "hyperparameters": {**HP, "mesh": mesh}}


class _Fp32Trial(gpt_fsdp.GPTTrial):
    def __init__(self, context):
        import dataclasses

        super().__init__(context)
        self.cfg = dataclasses.replace(self.cfg, compute_dtype=torch.float32)


def worker_fit(d):
    """On each rank: the GPT trial through ``Trainer.fit`` with telemetry
    on {dp: 2} and on {fsdp: 2}; rank 0 writes its registries."""
    dist = launch.init_from_env("cpu")
    out = {}
    for name, mesh in (("dp", {"dp": 2}), ("fsdp", {"fsdp": 2})):
        raw = _fit_config(os.path.join(d, name), mesh)
        cfg = TConfig.from_dict(raw)
        with tcore.init(config=cfg, distributed=dist, trial_id=1) as ctx:
            trial = _Fp32Trial(TContext(config=cfg,
                                        hparams=raw["hyperparameters"],
                                        core=ctx, device="cpu"))
            TTrainer(trial).fit()
            out[name] = ctx.telemetry.registry.dump()
    if dist.is_chief:
        with open(os.path.join(d, "out.json"), "w") as f:
            json.dump(out, f)
    launch.shutdown()


def _gauges(text, family):
    return {(lb["kind"], lb["axis"]): v for n, lb, v in
            tmetrics.parse_prometheus_text(text)["samples"] if n == family}


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_fit")
    launch_ranks(2, "fit", d, script=__file__)
    with open(d / "out.json") as f:
        return json.load(f)


def _tree():
    cfg = tgpt.GPTConfig(vocab_size=HP["vocab_size"],
                         n_layers=HP["n_layers"], d_model=HP["d_model"],
                         n_heads=HP["n_heads"], d_ff=HP["d_ff"],
                         max_seq_len=HP["seq_len"])
    return cfg, tgpt.init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")


def test_dp_all_reduces_are_the_gradient_tree(fits):
    """Over {dp: 2} every gradient leaf is summed once in fp32, and three
    scalars are reduced over the world: the loss (over the batch axes),
    the reported gradient norm and the clip's norm."""
    cfg, params = _tree()
    leaves = optim.leaves(params)
    ops = _gauges(fits["dp"], "xla_collective_ops_total")
    byts = _gauges(fits["dp"], "xla_collective_bytes")
    assert set(ops) == {("all-reduce", "dp")}
    assert ops[("all-reduce", "dp")] == len(leaves) + 3
    assert byts[("all-reduce", "dp")] == 4 * (
        sum(t.numel() for t in leaves) + 3)


def test_fsdp_gathers_are_each_layer_s_parameters(fits):
    """Over {fsdp: 2} (remat on) each block's four fsdp-sharded kernels
    are gathered per layer in the forward and again in the recompute,
    and the tied embedding twice (the embedding and the logits): each
    gather's result is the whole fp32 slice."""
    cfg, params = _tree()
    kernels = sum(params["blocks"][n]["kernel"].numel()
                  for n in ("attn_qkv", "attn_out", "mlp_up", "mlp_down"))
    table = params["embed"]["table"].numel()
    ops = _gauges(fits["fsdp"], "xla_collective_ops_total")
    byts = _gauges(fits["fsdp"], "xla_collective_bytes")
    assert ops[("all-gather", "fsdp")] == 2 * 4 * cfg.n_layers + 2
    assert byts[("all-gather", "fsdp")] == 4 * (2 * kernels + 2 * table)
    assert set(a for _, a in ops) == {"fsdp"}


def test_comm_fraction_of_a_fit_is_jax_s_on_its_totals(fits):
    """The exported fraction is ``comm_compute_fraction`` of the
    recorded bytes and the counted FLOPs against the CPU estimates;
    JAX's function gives the same number on the same totals."""
    for name in ("dp", "fsdp"):
        samples = tmetrics.parse_prometheus_text(fits[name])["samples"]
        (frac,) = [v for n, _, v in samples
                   if n == "xla_comm_compute_fraction"]
        (flops,) = [v for n, lb, v in samples if n == "xla_program_flops"
                    and lb["program"] == "train_step"]
        s = jcoll.CollectiveSummary(n_partitions=2)
        for (kind, axis), b in _gauges(fits[name],
                                       "xla_collective_bytes").items():
            s.add(kind, axis, b)
        want = jcoll.comm_compute_fraction(
            s, flops, interconnect_bytes_per_s=10e9,
            peak_flops_per_s=tflops.CPU_PEAK_EST_FLOPS)
        assert math.isclose(frac, want, rel_tol=1e-12)
        assert 0.0 < frac < 1.0
        # the MFU denominator is the mesh's two ranks of peak
        (peak,) = [v for n, _, v in samples if n == "mfu_peak_flops"]
        assert peak == 2 * tflops.CPU_PEAK_EST_FLOPS


def test_scaling_bench_on_two_gloo_ranks_validates_in_both():
    proc = subprocess.run(
        [sys.executable, "-m", "determined_clone_tpu_torch.parallel."
         "scaling_bench", "--devices", "2", "--device", "cpu", "--json",
         "--steps", "2", "--timeout", "240"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    art = json.loads(proc.stdout.strip().splitlines()[-1])
    assert tmesh.validate_multichip(art) == []
    assert jmesh.validate_multichip(art) == []
    assert tmesh.format_multichip(art) == jmesh.format_multichip(art)
    assert set(art["meshes"]) == {"dp", "fsdp", "tp"}
    assert art["n_devices"] == 2 and art["platform"] == "cpu"
    dp = art["meshes"]["dp"]
    assert dp["collectives"]["ops"]["all-reduce"]["dp"]["count"] > 0
    assert dp["straggler"]["windows"] == 2
    assert set(art["per_device_peak_bytes"]) == {"cpu:0", "cpu:1"}
    assert art["baseline"]["collectives"]["total_ops"] == 0
    for run in art["meshes"].values():
        assert run["scaling_efficiency"] > 0
        assert run["peak_flops_provenance"] == "cpu:est"
        assert np.isfinite(run["mfu_measured"])


WORKERS = {"fit": worker_fit}

if __name__ == "__main__":
    WORKERS[sys.argv[1]](sys.argv[2])
