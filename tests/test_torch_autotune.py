"""The port's autotune (``autotune/core.py``, a copy of the framework-free
JAX module, and ``autotune/gpt_bench.py``'s ``make_gpt_measure`` over the
port's mesh and train step) held against the JAX package's, as
``tests/test_autotune.py`` drives it.

Exact: the candidate lists, the search's results and order under one
deterministic ``measure`` (feasible, infeasible and early-stopped
alike), and the generated grid experiment (its dict and both packages'
parse of it). The real measure: the JAX bench's small GPT at its own
defaults, every candidate feasible with a positive rate, on one gloo
rank in this process and on two gloo ranks launched by
``exec/launch.py`` (the script's ``tune`` worker, which imports no JAX)
where the JAX side runs its virtual CPU devices; the ranks must agree
on every rate, so they take the same decisions.
"""
import dataclasses
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from determined_clone_tpu_torch import autotune as tauto  # noqa: E402
from determined_clone_tpu_torch.autotune import gpt_bench as tbench  # noqa: E402,E501
from determined_clone_tpu_torch.exec import launch  # noqa: E402

if __name__ != "__main__":  # the ranks never import JAX
    import jax
    import pytest

    from determined_clone_tpu import autotune as jauto
    from determined_clone_tpu.autotune import gpt_bench as jbench
    from determined_clone_tpu.config import ExperimentConfig as JConfig
    from determined_clone_tpu_torch.config import ExperimentConfig as TConfig
    from tests.test_torch_parallel import launch_ranks

    SIDES = {"jax": jauto, "port": tauto}

    @pytest.mark.parametrize("n,axes,cap", [
        (8, ("dp", "fsdp", "tp"), 64), (8, ("dp", "tp"), 2),
        (12, ("dp", "fsdp", "tp", "sp"), 64), (1, ("dp", "fsdp", "tp"), 64),
        (6, ("dp", "tp"), 3)])
    def test_mesh_candidates_as_jax(n, axes, cap):
        t = tauto.mesh_candidates(n, axes, max_candidates=cap)
        assert t == jauto.mesh_candidates(n, axes, max_candidates=cap)
        assert all(int(torch.tensor(list(c.values())).prod()) == n
                   for c in t)

    def scripted_measure(seed):
        """A deterministic measure: rates from a seed, some candidates
        infeasible (tp 4), remat slower."""
        def measure(mesh, remat, batch):
            if mesh.get("tp", 1) == 4:
                raise RuntimeError("OOM: tp=4 infeasible")
            key = json.dumps([sorted(mesh.items()), remat, batch])
            h = (sum(map(ord, key)) * 2654435761 + seed) % 997
            return (1.0 + h) * (0.9 if remat else 1.0) * batch
        return measure

    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("kwargs", [
        dict(n_devices=4, remat_options=(False,), max_trials=32,
             early_stop_after=32),
        dict(n_devices=8, remat_options=(True, False), batch_options=(2, 8),
             max_trials=16, early_stop_after=4),
        dict(n_devices=8, axes=("dp", "tp"), max_trials=100,
             early_stop_after=2)], ids=["all", "early", "two_axes"])
    def test_autotune_results_as_jax(kwargs, seed):
        out = {}
        for name, mod in SIDES.items():
            calls = []
            measure = scripted_measure(seed)

            def counted(mesh, remat, batch):
                calls.append((sorted(mesh.items()), remat, batch))
                return measure(mesh, remat, batch)

            res = mod.autotune(counted, **kwargs)
            out[name] = ([dataclasses.asdict(r) | {"feasible": r.feasible}
                          for r in res], calls)
        assert out["port"] == out["jax"]
        feas = [r["samples_per_sec"] for r in out["port"][0]
                if r["feasible"]]
        assert feas == sorted(feas, reverse=True)  # best first

    def test_autotune_early_stop_as_jax():
        counts = {}
        for name, mod in SIDES.items():
            n = [0]

            def measure(mesh, remat, batch):
                n[0] += 1
                return 1.0  # never improves after the first

            mod.autotune(measure, 8, remat_options=(False,),
                         max_trials=100, early_stop_after=3)
            counts[name] = n[0]
        assert counts == {"jax": 4, "port": 4}

    BASE = {"name": "gpt-run", "entrypoint": "model_def:Trial",
            "searcher": {"name": "single", "metric": "loss",
                         "max_length": {"batches": 100}},
            "hyperparameters": {"lr": 0.001}}

    @pytest.mark.parametrize("n,kw", [
        (8, dict(axes=("dp", "fsdp", "tp"), max_candidates=6)),
        (4, dict(remat_options=(True, False), max_length_batches=5)),
        (1, {})])
    def test_experiment_config_as_jax(n, kw):
        t = tauto.make_autotune_experiment_config(BASE, n, **kw)
        assert t == jauto.make_autotune_experiment_config(BASE, n, **kw)
        assert BASE["searcher"]["name"] == "single"  # base untouched
        assert TConfig.from_dict(t).to_dict() == \
            JConfig.from_dict(t).to_dict()
        assert t["resources"]["slots_per_trial"] == n

    @pytest.fixture()
    def one_rank_world():
        dist = launch.init_rank(0, 1, device="cpu")
        yield dist
        launch.shutdown()

    def test_gpt_measure_on_one_rank(one_rank_world):
        """mesh_candidates(1) × remat at the bench's own config, on one
        rank as on the one card: every candidate measured, feasible,
        best first; a mesh bigger than the world is infeasible."""
        measure = tbench.make_gpt_measure(seq_len=32, warmup=1, steps=2,
                                          device="cpu")
        res = tauto.autotune(measure, 1, remat_options=(True, False),
                             batch_options=(2,))
        assert [(r.mesh, r.remat) for r in res if r.feasible] and \
            sorted((json.dumps(r.mesh), r.remat) for r in res) == sorted(
                (json.dumps(m), rm) for m in tauto.mesh_candidates(1)
                for rm in (True, False))
        assert all(r.feasible and r.samples_per_sec > 0 for r in res)
        rates = [r.samples_per_sec for r in res]
        assert rates == sorted(rates, reverse=True)
        bad = tauto.autotune(measure, 2, axes=("dp",), remat_options=(True,),
                             batch_options=(2,))
        assert not bad[0].feasible and "2 ranks" in bad[0].error

    def test_gpt_measure_needs_a_world():
        measure = tbench.make_gpt_measure(device="cpu")
        with pytest.raises(RuntimeError, match="torch.distributed world"):
            measure({"dp": 1}, True, 2)

    def test_gpt_measure_on_two_ranks_as_jax(tmp_path):
        """Both measures over ("dp", "tp") on two devices: the same
        candidates, each feasible with a positive rate; the two port
        ranks return the same rates."""
        if len(jax.devices()) < 2:
            pytest.skip("needs the virtual CPU devices")
        jres = jauto.autotune(jbench.make_gpt_measure(seq_len=32, warmup=1,
                                                      steps=2),
                              2, axes=("dp", "tp"), remat_options=(True,),
                              batch_options=(2,), max_trials=4)
        launch_ranks(2, "tune", str(tmp_path), script=__file__)
        outs = [json.loads((tmp_path / f"rank{r}.json").read_text())
                for r in range(2)]
        assert outs[0] == outs[1]
        tres = outs[0]
        assert sorted(json.dumps(r["mesh"]) for r in tres) == sorted(
            json.dumps(r.mesh) for r in jres)
        assert all(r.feasible for r in jres)
        assert all(r["samples_per_sec"] > 0 for r in tres)


# -- the ranks ----------------------------------------------------------------

def worker_tune(d):
    torch.set_num_threads(1)
    dist = launch.init_from_env("cpu")
    measure = tbench.make_gpt_measure(seq_len=32, warmup=1, steps=2,
                                      device="cpu")
    res = tauto.autotune(measure, 2, axes=("dp", "tp"),
                         remat_options=(True,), batch_options=(2,),
                         max_trials=4)
    with open(os.path.join(d, f"rank{dist.rank}.json"), "w") as f:
        json.dump([dataclasses.asdict(r) for r in res], f)
    launch.shutdown()


WORKERS = {"tune": worker_tune}

if __name__ == "__main__":
    WORKERS[sys.argv[1]](sys.argv[2])
