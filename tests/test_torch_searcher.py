"""The port's searchers held against the JAX package on the CPU.

Every built-in method (single, random, grid, ASHA promote-based and
stopping-based, adaptive ASHA in its three modes) and a custom
``SearchMethod`` is driven in each package by one event script: the
operations are answered in queue order, each validation's metric is
drawn from one numpy seed, and every fifth validation is answered with
``trial_exited_early`` instead. Required exactly: the operation streams,
``snapshot()`` JSON after every event, a snapshot of either package
restored in the other continuing the same stream, and ``simulate``'s
results. ``RemoteSearchRunner`` of each package is driven by one
scripted session (fixed searcher events, every POST recorded): the POST
bodies must be equal. No framework is involved, so nothing here has a
tolerance.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from determined_clone_tpu import searcher as jsearch
from determined_clone_tpu.config import HyperparameterSpace as JSpace
from determined_clone_tpu.config import SearcherConfig as JSearcherConfig
from determined_clone_tpu_torch import searcher as tsearch
from determined_clone_tpu_torch.config import HyperparameterSpace as TSpace
from determined_clone_tpu_torch.config import (
    SearcherConfig as TSearcherConfig,
)

torch.set_num_threads(1)

SPACE = {"lr": {"type": "log", "minval": -4, "maxval": -1, "count": 3},
         "width": {"type": "int", "minval": 8, "maxval": 64, "count": 3},
         "act": {"type": "categorical", "vals": ["relu", "gelu"]},
         "drop": {"type": "double", "minval": 0.0, "maxval": 0.5,
                  "count": 3},
         "depth": {"type": "categorical", "vals": [2, 4]}}
LEN = {"batches": 64}
METHODS = {
    "single": {"name": "single", "max_length": LEN},
    "random": {"name": "random", "max_trials": 7,
               "max_concurrent_trials": 3, "max_length": LEN},
    "grid": {"name": "grid", "max_trials": 9, "max_concurrent_trials": 4,
             "max_length": LEN},
    "asha": {"name": "asha", "max_trials": 12, "num_rungs": 3,
             "divisor": 2, "max_concurrent_trials": 4, "max_length": LEN},
    "asha_stop_once": {"name": "asha", "max_trials": 10, "num_rungs": 3,
                       "divisor": 3, "stop_once": True,
                       "smaller_is_better": False, "max_length": LEN},
    "adaptive_aggressive": {"name": "adaptive_asha", "max_trials": 9,
                            "mode": "aggressive", "num_rungs": 3,
                            "max_length": LEN},
    "adaptive_standard": {"name": "adaptive_asha", "max_trials": 14,
                          "mode": "standard", "num_rungs": 4, "divisor": 3,
                          "max_concurrent_trials": 5, "max_length": LEN},
    "adaptive_conservative": {"name": "adaptive_asha", "max_trials": 11,
                              "mode": "conservative", "num_rungs": 3,
                              "max_time": 27, "max_length": LEN},
}
PKGS = {"jax": (jsearch, JSearcherConfig, JSpace),
        "port": (tsearch, TSearcherConfig, TSpace)}


def _custom_method(S):
    """A user's search method for package ``S``: three trials of a drawn
    ``x``, each doubling its length while its metric stays below 0.6."""

    class Doubling(S.SearchMethod):
        def __init__(self, seed=0):
            super().__init__(seed=seed)
            self.done = 0

        def initial_operations(self):
            return [S.Create(-1, {"x": self.rng.uniform(0.0, 1.0)})
                    for _ in range(3)]

        def on_trial_created(self, request_id):
            return [S.ValidateAfter(request_id, 2)]

        def on_validation_completed(self, request_id, metric, units):
            if units < 16 and metric < 0.6:
                return [S.ValidateAfter(request_id, units * 2)]
            self.done += 1
            return [S.Close(request_id)] + self._maybe_end()

        def on_trial_exited_early(self, request_id, reason):
            self.done += 1
            return self._maybe_end()

        def _maybe_end(self):
            return [S.Shutdown()] if self.done == 3 else []

        def progress(self):
            return self.done / 3

        def snapshot(self):
            return {**super().snapshot(), "done": self.done}

        def restore(self, snap):
            super().restore(snap)
            self.done = snap["done"]

    return Doubling(seed=5)


def _method(pkg, name, seed=3):
    S, Config, Space = PKGS[pkg]
    if name == "custom":
        return _custom_method(S)
    return S.build_method(Config.from_dict(METHODS[name]), Space(SPACE),
                          seed=seed)


def _ops_from_json(S, items):
    ops = []
    for d in items:
        kind = d["type"]
        if kind == "create":
            ops.append(S.Create(d["request_id"], d["hparams"]))
        elif kind == "validate_after":
            ops.append(S.ValidateAfter(d["request_id"], d["units"]))
        elif kind == "close":
            ops.append(S.Close(d["request_id"]))
        else:
            ops.append(S.Shutdown(cancel=d["cancel"], failure=d["failure"]))
    return ops


class Script:
    """One package's searcher answered by the event script."""

    def __init__(self, S, method, seed, *, state=None):
        self.S = S
        self.engine = S.Searcher(method)
        self.rng = np.random.RandomState(seed)
        self.stream, self.snapshots = [], []
        self.validations, self.ended = 0, set()
        if state is None:
            self.queue = self.engine.initial_operations()
            self.stream.append(("initial", self.S.custom.ops_to_json(self.queue)))
        else:   # resume another package's run from its state
            self.engine.restore(json.loads(state["snapshot"]))
            self.queue = _ops_from_json(S, state["queue"])
            self.rng.set_state(state["rng"])
            self.validations, self.ended = state["validations"], set(
                state["ended"])

    def state(self):
        return {"snapshot": json.dumps(self.engine.snapshot()),
                "queue": self.S.custom.ops_to_json(self.queue),
                "rng": self.rng.get_state(), "validations": self.validations,
                "ended": sorted(self.ended)}

    def step(self):
        """Answer the next operation; False once there is none left."""
        S, engine = self.S, self.engine
        if not self.queue:
            return False
        op = self.queue.pop(0)
        if isinstance(op, S.Shutdown):
            self.stream.append(("shutdown", self.S.custom.ops_to_json([op])))
            self.queue = []
            return False
        if isinstance(op, S.Create):
            event, new = ("created", op.request_id), engine.trial_created(
                op.request_id)
        elif isinstance(op, S.ValidateAfter):
            if op.request_id in self.ended:
                return True
            self.validations += 1
            metric = float(self.rng.uniform())
            if self.validations % 5 == 0:
                self.ended.add(op.request_id)
                event = ("exited_early", op.request_id)
                new = engine.trial_exited_early(op.request_id, "errored")
            else:
                event = ("validated", op.request_id, metric, op.length)
                new = engine.validation_completed(op.request_id, metric,
                                                  op.length)
        else:
            self.ended.add(op.request_id)
            event, new = ("closed", op.request_id), engine.trial_closed(
                op.request_id)
        self.stream.append((event, self.S.custom.ops_to_json(new),
                            engine.progress()))
        self.snapshots.append(json.dumps(engine.snapshot(), sort_keys=True))
        self.queue.extend(new)
        return True

    def run(self, limit=10_000):
        n = 0
        while n < limit and self.step():
            n += 1
        return self


NAMES = list(METHODS) + ["custom"]


@pytest.mark.parametrize("name", NAMES)
def test_operation_streams_and_snapshots_match_jax(name):
    j = Script(jsearch, _method("jax", name), seed=11).run()
    t = Script(tsearch, _method("port", name), seed=11).run()
    assert t.stream == j.stream
    assert t.snapshots == j.snapshots
    assert t.stream[-1][0] == "shutdown"
    if name != "single":   # one validation: no fifth to exit early
        assert any(e[0][0] == "exited_early" for e in t.stream[1:-1])
    assert t.engine.shutdown and j.engine.shutdown


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("name", NAMES)
def test_snapshot_restores_in_the_other_package(name, direction):
    """Half-way through, one package's snapshot (and the pending
    operations) go to a fresh searcher of the other package, which must
    finish as a fresh searcher of the snapshot's own package does, and as
    the unbroken run. The JAX ``SingleSearch`` leaves its done flag out of
    its snapshot, so a restored single search reports progress 0 until
    its trial validates; the port keeps that, and for ``single`` only the
    operations are held to the unbroken run."""
    whole = Script(tsearch, _method("port", name), seed=13).run()
    half = max(1, (len(whole.stream) - 1) // 2)
    src, dst = (("jax", "port") if direction == "jax_to_port"
                else ("port", "jax"))
    S_src, S_dst = PKGS[src][0], PKGS[dst][0]
    first = Script(S_src, _method(src, name), seed=13).run(limit=half)
    second = Script(S_dst, _method(dst, name), seed=13,
                    state=first.state()).run()
    same = Script(S_src, _method(src, name), seed=13,
                  state=first.state()).run()
    assert second.stream == same.stream
    assert second.snapshots == same.snapshots
    if name == "single":
        assert [e[:2] for e in first.stream + second.stream] == \
            [e[:2] for e in whole.stream]
    else:
        assert first.stream + second.stream == whole.stream
        assert second.snapshots == whole.snapshots[len(first.snapshots):]


def _landscape(hparams, units):
    """A deterministic metric with trial-to-trial spread."""
    lr = hparams.get("lr", hparams.get("x", 0.5))
    return float(np.log10(lr) ** 2 / (1 + units) + 0.01 * hparams.get(
        "width", 1) / 64)


@pytest.mark.parametrize("name", NAMES)
def test_simulate_matches_jax(name):
    j = jsearch.simulate(_method("jax", name), _landscape)
    t = tsearch.simulate(_method("port", name), _landscape)
    assert (t.shutdown, t.events, t.max_concurrent_seen, t.n_trials) == \
        (j.shutdown, j.events, j.max_concurrent_seen, j.n_trials)
    assert {k: dataclasses.asdict(v) for k, v in t.trials.items()} == \
        {k: dataclasses.asdict(v) for k, v in j.trials.items()}
    assert t.units_by_trial() == j.units_by_trial()


def test_build_method_refuses_custom_as_jax():
    raw = {"name": "custom", "metric": "m"}
    with pytest.raises(ValueError) as je:
        jsearch.build_method(JSearcherConfig.from_dict(raw), JSpace({}))
    with pytest.raises(ValueError) as te:
        tsearch.build_method(TSearcherConfig.from_dict(raw), TSpace({}))
    assert str(te.value) == str(je.value)


class ScriptedSession:
    """A master's custom-search queue, scripted: each GET returns the next
    fixed batch of searcher events (the last batch ends the experiment),
    and every POST is recorded."""

    def __init__(self, batches):
        self.batches = list(batches)
        self.posts = []

    def create_experiment(self, config, context=None):
        self.posts.append(("create", config, context))
        return {"id": 7}

    def request(self, method, path, body=None):
        if method == "POST":
            self.posts.append((path, json.loads(json.dumps(body))))
            return {}
        batch = self.batches.pop(0)
        return {"events": batch,
                "state": "ACTIVE" if self.batches else "COMPLETED"}


EVENTS = [
    [{"id": 1, "type": "initial_operations"}],
    [{"id": 2, "type": "trial_created", "request_id": 0},
     {"id": 3, "type": "trial_created", "request_id": 1},
     {"id": 4, "type": "trial_created", "request_id": 2}],
    [],
    [{"id": 5, "type": "validation_completed", "request_id": 0,
      "metric": 0.7, "units": 2},
     {"id": 6, "type": "validation_completed", "request_id": 1,
      "metric": 0.2, "units": 2},
     {"id": 7, "type": "trial_exited_early", "request_id": 2},
     {"id": 8, "type": "some_future_event"}],
    [{"id": 9, "type": "trial_closed", "request_id": 0},
     {"id": 10, "type": "validation_completed", "request_id": 1,
      "metric": 0.9, "units": 4}],
]


@pytest.mark.parametrize("trim", [False, True])
@pytest.mark.parametrize("name", ["custom", "asha"])
def test_remote_search_runner_posts_as_jax(name, trim):
    """Both packages' ``RemoteSearchRunner`` against one scripted
    session: the same POST bodies (operations, progress, acks), the same
    terminal state and experiment id."""
    results = {}
    for pkg, (S, _c, _s) in PKGS.items():
        session = ScriptedSession(EVENTS)
        runner = S.RemoteSearchRunner(_method(pkg, name), session,
                                      poll_interval=0.0, trim_events=trim)
        exp_id = runner.run({"searcher": {"name": "custom"}})
        results[pkg] = (exp_id, session.posts)
    assert results["port"] == results["jax"]
    posts = results["port"][1]
    assert posts[0][0] == "create" and len(posts) >= 4


def test_remote_search_runner_refuses_a_builtin_name_as_jax():
    errors = []
    for pkg, (S, _c, _s) in PKGS.items():
        runner = S.RemoteSearchRunner(_method(pkg, "custom"),
                                      ScriptedSession([]))
        with pytest.raises(ValueError) as e:
            runner.run({"searcher": {"name": "asha"}})
        errors.append(str(e.value))
    assert errors[0] == errors[1]
