"""The port's batch inference (``torch_batch_process``) held against the
JAX package's ``jax_batch_process``, case for case as
``tests/test_batch_inference.py`` drives it.

Each scenario runs once through each package on its own storage, over
the same seeded numpy dataset, with a processor that records every
(batch index, items) it is given. Exact: the batches each rank
processes, their order, the summaries (storage ids aside), the merged
progress metadata, the dropped-example counts and the errors. A
preemption is deterministic here: a stand-in for ``ctx.preempt`` that
answers yes at its n-th question. Progress checkpoints cross packages:
a run preempted in one package resumes in the other.
"""
import contextlib
import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from determined_clone_tpu import batch_inference as jbi
from determined_clone_tpu import core as jcore
from determined_clone_tpu_torch import batch_inference as tbi
from determined_clone_tpu_torch import core as tcore

SIDES = {"jax": (jcore, jbi, jbi.jax_batch_process),
         "port": (tcore, tbi, tbi.torch_batch_process)}


def dataset(seed, n):
    return np.random.RandomState(seed).randint(0, 1000, size=n)


def collector(pkg, seen):
    class P(pkg.BatchProcessor):
        def process_batch(self, batch, batch_idx):
            seen.append((batch_idx, [int(x) for x in batch]))

        def on_checkpoint_start(self):
            seen.append(("ckpt", None))

        def on_finish(self):
            seen.append(("finish", None))

    return P


class PreemptAt:
    """ctx.preempt stand-in: yes from its n-th question on."""

    def __init__(self, n):
        self.n, self.asked = n, 0

    def should_preempt(self):
        self.asked += 1
        return self.asked >= self.n

    def close(self):
        pass


@contextlib.contextmanager
def context(mod, storage, preempt_at=None, distributed=None):
    with mod.init(storage_path=str(storage),
                  **({"distributed": distributed} if distributed else {})
                  ) as ctx:
        if preempt_at is not None:
            real, ctx.preempt = ctx.preempt, PreemptAt(preempt_at)
            real.close()
        yield ctx


def summary(result):
    return {k: v for k, v in result.items() if k != "storage_id"}


CASES = {
    # name: (n examples, batch_size, checkpoint_interval, max_batches)
    "ragged_tail": (10, 3, 2, None),
    "even": (12, 4, 1, None),
    "max_batches": (100, 10, 100, 3),
    "interval_gt_batches": (9, 3, 100, None),
}


def single(side, tmp, name, seed):
    mod, pkg, run = SIDES[side]
    n, bs, interval, max_batches = CASES[name]
    seen = []
    with context(mod, tmp) as ctx:
        result = run(collector(pkg, seen), dataset(seed, n), batch_size=bs,
                     checkpoint_interval=interval, core_context=ctx,
                     max_batches=max_batches)
        meta = ctx.checkpoint.get_metadata(result["storage_id"])
    return summary(result), seen, {k: v for k, v in meta.items()
                                   if k != "trial_id"}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", list(CASES))
def test_single_rank_as_jax(name, seed, tmp_path):
    j = single("jax", tmp_path / "j", name, seed)
    t = single("port", tmp_path / "t", name, seed)
    assert t == j
    n, bs, _, max_batches = CASES[name]
    assert t[0]["examples_dropped"] == (n - max_batches * bs
                                        if max_batches else 0)


def multi(side, tmp, world, n, bs, interval):
    mod, pkg, run = SIDES[side]
    seen = []
    dists = mod.DistributedContext.make_local_group(world)

    def rank(dist):
        with context(mod, tmp, distributed=dist) as ctx:
            return run(collector(pkg, seen), dataset(5, n), batch_size=bs,
                       checkpoint_interval=interval, core_context=ctx)

    with ThreadPoolExecutor(max_workers=world) as pool:
        results = list(pool.map(rank, dists))
    with context(mod, tmp) as ctx:
        meta = ctx.checkpoint.get_metadata(results[0]["storage_id"])
    batches = sorted(b for b in seen if b[0] not in ("ckpt", "finish"))
    return ([summary(r) for r in results], batches,
            {k: v for k, v in meta.items() if k != "trial_id"},
            sum(1 for b in seen if b[0] == "finish"))


@pytest.mark.parametrize("world,n,bs,interval", [(3, 14, 2, 3),
                                                 (2, 9, 1, 2)])
def test_multi_rank_sharding_as_jax(world, n, bs, interval, tmp_path):
    j = multi("jax", tmp_path / "j", world, n, bs, interval)
    t = multi("port", tmp_path / "t", world, n, bs, interval)
    assert t == j
    assert [b[0] for b in t[1]] == list(range(-(-n // bs)))
    assert t[3] == world


def preempt_then_resume(first, second, tmp, preempt_at):
    """A run preempted in package ``first``, resumed in ``second`` from
    its progress checkpoint."""
    data = dataset(7, 12)
    mod, pkg, run = SIDES[first]
    seen1 = []
    with context(mod, tmp, preempt_at=preempt_at) as ctx:
        r1 = run(collector(pkg, seen1), data, batch_size=2,
                 checkpoint_interval=100, core_context=ctx)
    mod, pkg, run = SIDES[second]
    seen2 = []
    with context(mod, tmp) as ctx:
        r2 = run(collector(pkg, seen2), data, batch_size=2,
                 checkpoint_interval=100, core_context=ctx,
                 latest_checkpoint=r1["storage_id"])
    return summary(r1), seen1, summary(r2), seen2


@pytest.mark.parametrize("preempt_at", [1, 3])
@pytest.mark.parametrize("first,second", [("jax", "jax"), ("port", "port"),
                                          ("jax", "port"), ("port", "jax")])
def test_preemption_and_resume_across_packages(first, second, preempt_at,
                                               tmp_path):
    out = preempt_then_resume(first, second, tmp_path / "s", preempt_at)
    ref = preempt_then_resume("jax", "jax", tmp_path / "ref", preempt_at)
    assert out == ref
    s1, seen1, s2, seen2 = out
    assert s1["preempted"] and s1["batches_processed"] == preempt_at
    assert ("finish", None) not in seen1
    done1 = {b for b, _ in seen1 if b not in ("ckpt", "finish")}
    done2 = {b for b, _ in seen2 if b not in ("ckpt", "finish")}
    assert not done1 & done2 and done1 | done2 == set(range(6))
    assert s2["batches_processed"] == 6 and ("finish", None) in seen2


def dropped(side, tmp, caplog):
    mod, pkg, run = SIDES[side]
    pkg._dropped_warned = False
    seen = []
    with context(mod, tmp) as ctx:
        with caplog.at_level(logging.WARNING, logger=pkg.__name__):
            caplog.clear()
            results = [summary(run(
                collector(pkg, seen), dataset(1, 100), batch_size=10,
                checkpoint_interval=100, core_context=ctx, max_batches=3))
                for _ in range(2)]
            warnings = [r.getMessage() for r in caplog.records
                        if "dropped 70 examples" in r.getMessage()]
        # a resume whose plan shrank drops the difference, counted
        first = run(collector(pkg, []), dataset(2, 12), batch_size=2,
                    checkpoint_interval=100, core_context=ctx)
        shrunk = run(collector(pkg, []), dataset(2, 12), batch_size=2,
                     checkpoint_interval=100, core_context=ctx,
                     max_batches=4, latest_checkpoint=first["storage_id"])
    return results, warnings, summary(shrunk)


def test_dropped_examples_counted_and_warned_once_as_jax(tmp_path, caplog):
    j = dropped("jax", tmp_path / "j", caplog)
    t = dropped("port", tmp_path / "t", caplog)
    assert t == j
    assert [r["examples_dropped"] for r in t[0]] == [70, 70]
    assert len(t[1]) == 1  # warn once per process
    assert t[2]["examples_dropped"] == 4


@pytest.mark.parametrize("change", ["batch_size", "world_size"])
def test_resume_refuses_a_changed_layout_as_jax(change, tmp_path):
    """A progress checkpoint of one package resumed by the other with
    another batch size or gang size: the same ValueError."""
    messages = {}
    for writer, reader in (("jax", "port"), ("port", "jax")):
        mod, pkg, run = SIDES[writer]
        with context(mod, tmp_path / writer) as ctx:
            r = run(collector(pkg, []), dataset(4, 8), batch_size=2,
                    checkpoint_interval=1, core_context=ctx, max_batches=2)
        mod, pkg, run = SIDES[reader]
        dists = (mod.DistributedContext.make_local_group(2)
                 if change == "world_size" else [None])

        def attempt(dist):
            with context(mod, tmp_path / writer, distributed=dist) as ctx:
                with pytest.raises(ValueError) as e:
                    run(collector(pkg, []), dataset(4, 8),
                        batch_size=4 if change == "batch_size" else 2,
                        checkpoint_interval=1, core_context=ctx,
                        latest_checkpoint=r["storage_id"])
                return str(e.value)

        with ThreadPoolExecutor(max_workers=len(dists)) as pool:
            messages[reader] = sorted(set(pool.map(attempt, dists)))
    assert messages["port"] == messages["jax"]
    assert change.split("_")[0] in messages["port"][0]
