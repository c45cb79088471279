"""The port's experiment config, schema, v0 shims and hyperparameter space
held against the JAX package on the CPU.

Both packages parse the same raw configs: the cases of
``tests/test_config.py`` and ``tests/test_config_schema.py`` and the
port's ``GOOD_CONFIGS``/``BAD_CONFIGS`` (``tests/test_torch_core.py``).
Everything is compared exactly: the parsed fields, ``to_dict``, the
shimmed ``raw``, ``deprecations``, the schema's error lists, error
messages, ``merge_configs``, hparam draws for five seeds (the same
``random.Random`` in both) and the ``grid()`` order. The one departure:
a valid cloud or content-addressed ``checkpoint_storage`` raises
``NotImplementedError`` in the port, naming its ``ROADMAP.md`` item.
"""
import dataclasses
import enum
import random

import pytest
import torch

from determined_clone_tpu import config as jconfig
from determined_clone_tpu.config import schema as jschema
from determined_clone_tpu.config import shims as jshims
from determined_clone_tpu_torch import config as tconfig
from determined_clone_tpu_torch.config import schema as tschema
from determined_clone_tpu_torch.config import shims as tshims
from tests.test_torch_core import BAD_CONFIGS, GOOD_CONFIGS

torch.set_num_threads(1)

SCHEMA_GOOD = {
    "name": "exp",
    "entrypoint": "m:T",
    "searcher": {"name": "single", "metric": "loss",
                 "max_length": {"batches": 10}},
    "resources": {"slots_per_trial": 8, "topology": "v5e-8"},
    "checkpoint_storage": {"type": "gcs", "bucket": "b"},
}

# every config case of tests/test_config.py and tests/test_config_schema.py
CASES = {
    "minimal": {},
    "full": {
        "name": "mnist-tpu",
        "entrypoint": "model_def:MnistTrial",
        "searcher": {"name": "random", "metric": "accuracy",
                     "smaller_is_better": False, "max_trials": 8,
                     "max_length": {"epochs": 2}},
        "resources": {"slots_per_trial": 8, "topology": "v5e-8"},
        "hyperparameters": {"lr": {"type": "log", "minval": -4,
                                   "maxval": -2}},
        "checkpoint_storage": {"type": "shared_fs", "host_path": "/tmp/ckpt"},
        "records_per_epoch": 60000,
        "reproducibility": {"experiment_seed": 42},
        "log_policies": [{"pattern": "XlaRuntimeError",
                          "action": "exclude_node"}],
    },
    "multislice": {"resources": {"slots_per_trial": 16,
                                 "topology": {"slices": 2,
                                              "slice_shape": "v5e-8"}}},
    "multislice_indivisible": {"resources": {"slots_per_trial": 9,
                                             "topology": {"slices": 2}}},
    "bad_policy": {"checkpoint_policy": "sometimes"},
    "negative_restarts": {"max_restarts": -1},
    "priority": {"resources": {"priority": 1000}},
    "gcs_no_bucket": {"checkpoint_storage": {"type": "gcs"}},
    "yaml_grid": {"name": "yaml-exp",
                  "searcher": {"name": "grid", "metric": "loss"},
                  "hyperparameters": {"depth": {"type": "categorical",
                                                "vals": [2, 4]}}},
    "schema_good": SCHEMA_GOOD,
    "unknown_top": {**SCHEMA_GOOD, "slotz": 3},
    "scheduler_unit": {**SCHEMA_GOOD, "scheduler_unit": 3},
    "restarts_string": {**SCHEMA_GOOD, "max_restarts": "five"},
    "restarts_bool": {**SCHEMA_GOOD, "max_restarts": True},
    "searcher_mystery": {**SCHEMA_GOOD,
                         "searcher": {"name": "mystery", "metric": "loss"}},
    "shared_fs_no_path": {**SCHEMA_GOOD,
                          "checkpoint_storage": {"type": "shared_fs"}},
    "policy_explode": {**SCHEMA_GOOD, "log_policies": [
        {"pattern": "x", "action": "explode"}]},
    "policy_cancel": {**SCHEMA_GOOD, "log_policies": [
        {"pattern": "x", "action": "cancel_retries"}]},
    "policy_object": {**SCHEMA_GOOD, "log_policies": [
        {"pattern": "x", "action": {"type": "exclude_node"}}]},
    "policy_object_bad": {**SCHEMA_GOOD, "log_policies": [
        {"pattern": "x", "action": {"type": "explode"}}]},
    "enum": {**SCHEMA_GOOD, "checkpoint_policy": "some"},
    "resources_type": {**SCHEMA_GOOD, "resources": {"type": "x"}},
    "top_type": {**SCHEMA_GOOD, "type": "bogus"},
    "three_errors": {**SCHEMA_GOOD, "max_restarts": "x",
                     "checkpoint_policy": "y", "bogus": 1},
    "v0_adaptive": {"entrypoint": "m:T",
                    "searcher": {"name": "adaptive", "metric": "loss",
                                 "max_steps": 64},
                    "slots": 2},
    "v1_refuses_v0": {"config_version": 1, "entrypoint": "m:T",
                      "searcher": {"name": "adaptive", "metric": "loss"}},
    "v0_lengths": {"searcher": {"name": "single", "metric": "loss",
                                "max_length": 100},
                   "min_validation_period": 50},
    "v0_slots_steps_opts": {"slots": 8, "batches_per_step": 200,
                            "optimizations": {"aggregation": 2}},
    "v0_telemetry": {"telemetry": {"enabled": True, "max_events": 10}},
    "v0_both_telemetry": {"telemetry": {}, "observability": {}},
    "v0_slots_conflict": {"slots": 8, "resources": {"slots_per_trial": 4}},
    "v0_cas_flat": {"checkpoint_storage": {"type": "cas",
                                           "host_path": "/c"}},
    "adaptive_full": {
        "searcher": {"name": "adaptive_asha", "metric": "accuracy",
                     "smaller_is_better": False, "max_trials": 16,
                     "max_length": {"batches": 1000}, "mode": "aggressive",
                     "bracket_rungs": [3, 2], "max_concurrent_trials": 4,
                     "divisor": 3, "num_rungs": 3, "stop_once": True,
                     "custom_key": 1},
        "hyperparameters": {"opt": {"lr": {"type": "double", "minval": 0.1,
                                           "maxval": 0.2},
                                    "name": "adam"}},
        "perform_initial_validation": True, "max_restarts": 2,
        "labels": ["a", "b"], "workspace": "w", "project": "p",
        "profiling": {"enabled": True}, "environment": {"image": "x"},
        "data": {"url": "u"}},
    "asha_bad_divisor": {"searcher": {"name": "asha", "divisor": 1,
                                      "max_trials": 4}},
    "asha_no_rungs": {"searcher": {"name": "asha", "num_rungs": 0,
                                   "max_trials": 4}},
    "random_no_trials": {"searcher": {"name": "random", "max_trials": 0}},
    "adaptive_bad_mode": {"searcher": {"name": "adaptive_asha",
                                       "mode": "reckless"}},
    "hparam_dot": {"hyperparameters": {"a.b": 1}},
    "serving": {"serving": {"max_batch": 4, "speculative": {"k": 3}}},
    "serving_bad": {"serving": {"max_batch": 3}},
    "faults_bad_exc": {"faults": {"rules": [{"point": "p", "exc": "x"}]}},
    "observability_rules": {"observability": {"enabled": True, "rules": [
        {"name": "r", "kind": "threshold", "series": "s", "value": 1.0}]}},
    "observability_bad_rule": {"observability": {"rules": [
        {"name": "r", "kind": "absence", "series": "s"}]}},
    "not_a_mapping": ["a"],
}
for i, raw in enumerate(GOOD_CONFIGS):
    CASES[f"core_good_{i}"] = raw
for i, raw in enumerate(BAD_CONFIGS):
    CASES[f"core_bad_{i}"] = raw


def _plain(x):
    """A parsed config as plain data: dataclasses as dicts, enums as their
    values, a hyperparameter space as its raw form and flat leaves."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (jconfig.HyperparameterSpace,
                      tconfig.HyperparameterSpace)):
        return {"raw": x.raw,
                "flat": {k: hp.to_dict() for k, hp in x.flat.items()}}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _outcome(parse, raw):
    try:
        return "ok", parse(raw)
    except NotImplementedError as e:
        return "not_ported", str(e)
    except (ValueError, TypeError) as e:   # ConfigError is a ValueError
        return type(e).__name__, str(e)


@pytest.mark.parametrize("name", list(CASES))
def test_experiment_config_as_jax(name):
    """Fields, ``to_dict``, ``raw`` and ``deprecations`` of a valid config;
    the error's type and message of an invalid one."""
    raw = CASES[name]
    jkind, j = _outcome(jconfig.ExperimentConfig.from_dict, raw)
    tkind, t = _outcome(tconfig.ExperimentConfig.from_dict, raw)
    if jkind == "ok" and tkind == "not_ported":
        assert raw["checkpoint_storage"]["type"] in ("gcs", "s3", "azure",
                                                     "cas")
        assert "ROADMAP.md" in t and "the cloud storage managers" in t
        return
    assert tkind == jkind, (t, j)
    if jkind != "ok":
        assert t == j
        return
    assert _plain(t) == _plain(j)
    assert t.to_dict() == j.to_dict()
    assert t.deprecations == j.deprecations
    again = tconfig.ExperimentConfig.from_dict(t.to_dict())
    assert again.to_dict() == t.to_dict()


@pytest.mark.parametrize("name", list(CASES))
def test_schema_errors_as_jax(name):
    """The schema's error list for the raw config and for its shimmed
    form, and the shim's output and notes (or its ValueError)."""
    raw = CASES[name]
    assert tschema.validate(raw) == jschema.validate(raw)
    if not isinstance(raw, dict):
        return
    jkind, j = _outcome(jshims.shim, raw)
    tkind, t = _outcome(tshims.shim, raw)
    assert (tkind, t) == (jkind, j)
    if jkind == "ok":
        assert tschema.validate(t[0]) == jschema.validate(j[0])
        if not jschema.validate(j[0]):
            assert tschema.check(t[0]) is None


def test_schema_check_raises_as_jax():
    raw = CASES["three_errors"]
    with pytest.raises(jschema.SchemaError) as je:
        jschema.check(raw)
    with pytest.raises(tschema.SchemaError) as te:
        tschema.check(raw)
    assert str(te.value) == str(je.value)


def test_shim_leaves_current_version_and_input_alone():
    raw = {"config_version": 1, "searcher": {"name": "single",
                                             "max_length": 100}}
    cfg, notes = tshims.shim(raw)
    assert cfg is raw and notes == []
    legacy = {"slots": 4}
    assert tshims.shim(legacy)[0] == jshims.shim(legacy)[0]
    assert legacy == {"slots": 4}


SEARCHERS = {
    "default": {},
    "bayesian": {"name": "bayesian"},
    "asha_divisor": {"name": "asha", "divisor": 1, "max_trials": 4},
    "adaptive_roundtrip": {"name": "adaptive_asha", "metric": "accuracy",
                           "smaller_is_better": False, "max_trials": 16,
                           "max_length": {"batches": 1000},
                           "mode": "aggressive"},
    "asha_full": {"name": "asha", "max_trials": 9, "num_rungs": 3,
                  "divisor": 3, "max_time": 27, "stop_once": True,
                  "max_length": {"records": 640}, "extra_key": [1]},
    "custom": {"name": "custom", "metric": "m", "unit": "batches"},
    "not_a_mapping": "asha",
}


@pytest.mark.parametrize("name", list(SEARCHERS))
def test_searcher_config_as_jax(name):
    raw = SEARCHERS[name]
    jkind, j = _outcome(jconfig.SearcherConfig.from_dict, raw)
    tkind, t = _outcome(tconfig.SearcherConfig.from_dict, raw)
    assert tkind == jkind
    if jkind != "ok":
        assert t == j
        return
    assert _plain(t) == _plain(j)
    assert t.to_dict() == j.to_dict()
    assert _plain(tconfig.SearcherConfig.from_dict(t.to_dict())) == \
        _plain(jconfig.SearcherConfig.from_dict(j.to_dict()))


SPACES = {
    "implicit_const": {"lr": 0.1, "layers": [1, 2]},
    "ranges": {"lr": {"type": "log", "minval": -4, "maxval": -1},
               "width": {"type": "int", "minval": 8, "maxval": 64},
               "act": {"type": "categorical", "vals": ["relu", "gelu"]},
               "drop": {"type": "double", "minval": 0.0, "maxval": 0.5}},
    "nested": {"optimizer": {"lr": {"type": "double", "minval": 0.1,
                                    "maxval": 0.1, "count": 1},
                             "name": "adam"}},
    "grid": {"a": {"type": "categorical", "vals": [1, 2, 3]},
             "b": {"type": "double", "minval": 0.0, "maxval": 1.0,
                   "count": 2},
             "c": {"type": "log", "minval": -3, "maxval": -1, "base": 2,
                   "count": 3},
             "n": {"type": "int", "minval": 2, "maxval": 5}},
    "int_count": {"n": {"type": "int", "minval": 0, "maxval": 10,
                        "count": 4},
                  "k": {"type": "const", "val": 7}},
    "double_no_count": {"b": {"type": "double", "minval": 0, "maxval": 1}},
    "gpt_lr": {"lr": {"type": "log", "base": 10, "minval": -4.5,
                      "maxval": -3.0}, "global_batch_size": 8},
}


def _grid(space):
    try:
        return "ok", list(space.grid()), space.grid_size()
    except ValueError as e:
        return "ValueError", str(e)


@pytest.mark.parametrize("name", list(SPACES))
def test_hyperparameter_draws_and_grid_as_jax(name):
    """Five seeds draw the same hparams in both packages; the grid comes
    in the same order (or fails with the same message)."""
    raw = SPACES[name]
    j, t = jconfig.HyperparameterSpace(raw), tconfig.HyperparameterSpace(raw)
    assert {k: hp.to_dict() for k, hp in t.flat.items()} == \
        {k: hp.to_dict() for k, hp in j.flat.items()}
    for seed in range(5):
        jr, tr = random.Random(seed), random.Random(seed)
        assert [t.sample(tr) for _ in range(3)] == \
            [j.sample(jr) for _ in range(3)]
    assert _grid(t) == _grid(j)


@pytest.mark.parametrize("leaf", [
    {"type": "int", "minval": 5, "maxval": 1},
    {"type": "double", "minval": 2.0, "maxval": 1.0},
    {"type": "log", "minval": -1, "maxval": -2},
    {"type": "log", "minval": -2, "maxval": -1, "base": 0},
    {"type": "categorical", "vals": []},
])
def test_hyperparameter_errors_as_jax(leaf):
    with pytest.raises(ValueError) as je:
        jconfig.HyperparameterSpace({"x": leaf})
    with pytest.raises(ValueError) as te:
        tconfig.HyperparameterSpace({"x": leaf})
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("base,override", [
    ({"resources": {"slots_per_trial": 1, "resource_pool": "default"},
      "labels": ["a"]},
     {"resources": {"slots_per_trial": 8}, "labels": ["b"]}),
    ({"searcher": {"name": "asha", "max_length": {"batches": 4}},
      "hyperparameters": {"lr": 0.1}},
     {"searcher": {"max_length": {"epochs": 1}}, "hyperparameters": 3}),
])
def test_merge_configs_as_jax(base, override):
    assert tconfig.merge_configs(base, override) == \
        jconfig.merge_configs(base, override)
