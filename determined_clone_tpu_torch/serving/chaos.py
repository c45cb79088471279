"""Chaos conductor: seeded, scripted multi-fault scenarios for the fleet —
the port of ``determined_clone_tpu/serving/chaos.py``.

Each scenario (the catalog in docs/serving.md "Self-healing") builds a
fresh 1-3 replica :class:`ServingFleet`, records a *reference* run of a
deterministic workload with no faults active, then re-runs the same
workload under a seeded :class:`FaultPlan` while a
:class:`FleetSupervisor` heals the fleet — and asserts the self-healing
invariants afterwards:

- **zero lost accepted requests** — every ledger entry settled, and
  every request the scenario didn't deliberately doom completed;
- **bit-identical recovered outputs** — a request that failed over to a
  surviving replica emits exactly the reference tokens (greedy decode is
  deterministic, so exactly-once requeue is provable, not hoped);
- **zero leaked KV blocks** — :meth:`BlockAllocator.assert_balanced`
  on every surviving replica once idle, plus the per-incident
  ``leaked_blocks`` count from the crash teardown audit;
- **bounded MTTR** — every incident's ``recovery_s`` within budget and
  the fleet back at full healthy strength.

Determinism: prompts derive from the scenario seed, fault rules use
exact point names scoped to deterministic replica ids (``chaos-1`` is
always the first replica up) or request ids, and every rule here fires
with probability 1 at an exact hit count — so a scenario either passes
always or fails always for a given seed.

The JAX catalog's ``torn_warmstart`` tears the XLA executable cache's
blobs during a warm start; it waits with that cache (``ROADMAP.md``).
:func:`chaos_params` draws the weights with the port's ``gpt.init`` from
a seeded ``torch.Generator``. The fleets run on ``device`` (the card by
default); the scenarios' own configuration is small either way.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from determined_clone_tpu_torch import faults
from determined_clone_tpu_torch.device import DeviceLike, resolve_device
from determined_clone_tpu_torch.models import gpt
from determined_clone_tpu_torch.serving.bucketing import BucketSpec
from determined_clone_tpu_torch.serving.fleet import (
    PoisonPillRequest,
    ServingFleet,
)
from determined_clone_tpu_torch.serving.kv_cache import KVCacheConfig
from determined_clone_tpu_torch.serving.kv_store import KVBlockStore

# The standard chaos model: small enough that a scenario runs in seconds,
# big enough to exercise the real bucket ladder.
# Unlike the JAX catalog's, it computes in fp32: its bit-identical checks
# compare runs that batch differently, and bf16 sums on the card depend on
# the batch shape.
CHAOS_CFG = gpt.GPTConfig(vocab_size=97, n_layers=2, d_model=32, n_heads=4,
                          d_ff=64, max_seq_len=48, remat=False,
                          attention_impl="mha", compute_dtype=torch.float32)
CHAOS_BUCKETS = BucketSpec.build(2, 8)
CHAOS_CACHE = KVCacheConfig(num_blocks=16, block_size=8)


def chaos_params(seed: int = 0, device: DeviceLike = "cuda") -> gpt.Params:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return gpt.init(gen, CHAOS_CFG, device=dev)


@dataclasses.dataclass
class Check:
    """One audited invariant: name, verdict, and why."""
    name: str
    ok: bool
    detail: str = ""


@dataclasses.dataclass
class ScenarioResult:
    scenario: str
    seed: int
    passed: bool
    duration_s: float
    checks: List[Check]
    incidents: List[Dict[str, Any]]
    mttr_max_s: float

    def to_dict(self) -> Dict[str, Any]:
        return {
            "scenario": self.scenario,
            "seed": self.seed,
            "passed": self.passed,
            "duration_s": round(self.duration_s, 3),
            "mttr_max_s": round(self.mttr_max_s, 3),
            "checks": [dataclasses.asdict(c) for c in self.checks],
            "incidents": self.incidents,
        }


class ChaosRunner:
    """Builds fleets, drives workloads, injects faults, audits invariants.

    One runner = one (params, seed, budget) tuple; each scenario gets a
    fresh fleet named ``chaos`` so replica ids are always ``chaos-1``,
    ``chaos-2``, ... and fault rules can target them by exact name.
    """

    def __init__(self, params: Optional[gpt.Params] = None, *,
                 seed: int = 0, mttr_budget_s: float = 30.0,
                 requests: int = 6, max_new_tokens: int = 8,
                 device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        self.params = (params if params is not None
                       else chaos_params(seed, self.device))
        self.seed = int(seed)
        self.mttr_budget_s = float(mttr_budget_s)
        self.requests = int(requests)
        self.max_new = int(max_new_tokens)

    # -- fleet / workload plumbing ----------------------------------------

    def _fleet(self, **kw: Any) -> ServingFleet:
        kw.setdefault("name", "chaos")
        kw.setdefault("buckets", CHAOS_BUCKETS)
        kw.setdefault("cache", CHAOS_CACHE)
        kw.setdefault("warmup", False)
        kw.setdefault("tracing", False)
        # prefix_cache off so the post-scenario balance audit expects
        # exactly zero outstanding blocks
        kw.setdefault("prefix_cache", False)
        return ServingFleet(self.params, CHAOS_CFG, device=self.device, **kw)

    def _prompts(self, n: int) -> List[List[int]]:
        rng = random.Random(self.seed * 7919 + 13)
        return [[1 + rng.randrange(CHAOS_CFG.vocab_size - 7)
                 for _ in range(2 + (i % 3))] for i in range(n)]

    def _reference(self, fleet: ServingFleet,
                   prompts: Sequence[Sequence[int]]) -> List[List[int]]:
        """The unfaulted run every recovered output must match."""
        out = []
        for i, p in enumerate(prompts):
            res, _ = fleet.handle_request(p, self.max_new,
                                          request_id=f"ref-{i}",
                                          timeout=60.0)
            out.append(list(res.tokens))
        return out

    def _run_workload(self, fleet: ServingFleet,
                      prompts: Sequence[Sequence[int]], *,
                      deadlines: Optional[Dict[int, float]] = None,
                      request_ids: Optional[Dict[int, str]] = None,
                      timeout: float = 60.0) -> Dict[str, Tuple[str, Any]]:
        """Concurrent front-door workload. Returns request_id ->
        ("completed", tokens) or (ExceptionTypeName, message)."""
        results: Dict[str, Tuple[str, Any]] = {}

        def worker(i: int, prompt: Sequence[int]) -> None:
            rid = (request_ids or {}).get(i, f"req-{i}")
            try:
                res, _ = fleet.handle_request(
                    prompt, self.max_new, request_id=rid, timeout=timeout,
                    deadline_s=(deadlines or {}).get(i))
                results[rid] = ("completed", list(res.tokens))
            except Exception as exc:
                results[rid] = (type(exc).__name__, str(exc))

        threads = [threading.Thread(target=worker, args=(i, p),
                                    name=f"chaos-req-{i}", daemon=True)
                   for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout + 30.0)
        return results

    @staticmethod
    def _wait(pred: Callable[[], bool], timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if pred():
                return True
            time.sleep(0.02)
        return pred()

    # -- shared invariant audit -------------------------------------------

    def _audit(self, fleet: ServingFleet, checks: List[Check],
               ref: Sequence[Sequence[int]],
               results: Dict[str, Tuple[str, Any]], *,
               expected_failures: Optional[Dict[str, str]] = None,
               expect_replicas: int = 2,
               expect_min_incidents: int = 0) -> None:
        expected_failures = expected_failures or {}

        # recovery restored the fleet to full strength: the supervisor
        # must have replaced every scripted victim (incident count) and
        # the survivors must be LIVE — a dead replica keeps its HEALTHY
        # lifecycle state until the supervisor acts, so state alone
        # can't tell recovered from not-yet-noticed
        def _live() -> int:
            n = 0
            for rep in fleet.replicas():
                if not rep.admitting():
                    continue
                live = rep.engine.liveness()
                if live["thread_alive"] and live["fatal"] is None:
                    n += 1
            return n

        restored = self._wait(
            lambda: (len(fleet.incidents()) >= expect_min_incidents
                     and _live() >= expect_replicas), 30.0)
        checks.append(Check(
            "fleet_restored", restored,
            f"live={_live()} want>={expect_replicas} "
            f"incidents={len(fleet.incidents())} "
            f"want>={expect_min_incidents}"))

        # zero lost accepted requests: every ledger entry settled
        open_reqs = fleet.ledger.open_requests()
        checks.append(Check("no_open_ledger_entries", not open_reqs,
                            f"open={sorted(open_reqs)[:8]}"))

        # every request either completed bit-identical or failed the way
        # the scenario scripted it to
        bad: List[str] = []
        for rid, (outcome, payload) in sorted(results.items()):
            want = expected_failures.get(rid)
            if want is not None:
                if outcome != want:
                    bad.append(f"{rid}: {outcome} (scripted {want})")
            elif outcome != "completed":
                bad.append(f"{rid}: {outcome}: {payload}")
            else:
                i = int(rid.rsplit("-", 1)[1])
                if list(payload) != list(ref[i]):
                    bad.append(f"{rid}: tokens {payload} != ref {ref[i]}")
        checks.append(Check("exactly_once_bit_identical", not bad,
                            "; ".join(bad[:4])))

        # zero leaked KV blocks: surviving replicas drain to balance,
        # and every crash teardown audited clean
        leak = ""
        try:
            for rep in fleet.replicas():
                rep.engine.wait_idle(15.0)
                rep.engine.assert_kv_balanced(0)
        except (AssertionError, TimeoutError, RuntimeError) as exc:
            leak = repr(exc)
        incidents = fleet.incidents()
        leaked_n = sum(int(i.get("leaked_blocks") or 0) for i in incidents)
        checks.append(Check("zero_leaked_blocks",
                            not leak and leaked_n == 0,
                            leak or f"incident leaks={leaked_n}"))

        # bounded MTTR
        mttr = max((float(i.get("recovery_s", 0.0)) for i in incidents),
                   default=0.0)
        checks.append(Check(
            "mttr_bounded",
            len(incidents) >= expect_min_incidents
            and mttr <= self.mttr_budget_s,
            f"incidents={len(incidents)} (want>={expect_min_incidents}) "
            f"mttr_max={mttr:.3f}s budget={self.mttr_budget_s}s"))

    def _finish(self, name: str, t0: float, checks: List[Check],
                fleet: ServingFleet) -> ScenarioResult:
        incidents = fleet.incidents()
        mttr = max((float(i.get("recovery_s", 0.0)) for i in incidents),
                   default=0.0)
        return ScenarioResult(
            scenario=name, seed=self.seed,
            passed=all(c.ok for c in checks),
            duration_s=time.monotonic() - t0,
            checks=checks, incidents=incidents, mttr_max_s=mttr)

    # -- scenarios ---------------------------------------------------------

    def kill_replica_mid_decode(self) -> ScenarioResult:
        """kill -9 a replica mid-decode at 2 replicas (the acceptance
        scenario): ``chaos-1``'s scheduler thread dies on its second
        pass — requests it held fail over to ``chaos-2`` and the
        supervisor warm-starts a replacement."""
        t0 = time.monotonic()
        checks: List[Check] = []
        fleet = self._fleet()
        plan = None
        try:
            fleet.scale_up(2)
            prompts = self._prompts(self.requests)
            ref = self._reference(fleet, prompts)
            fleet.start_supervisor(interval_s=0.05, stale_after_s=2.0)
            plan = faults.activate(faults.plan_from_dict({
                "seed": self.seed,
                "rules": [{"point": "engine.step.chaos-1",
                           "action": "error", "nth": 2, "times": 1}],
            }), fleet.registry)
            results = self._run_workload(fleet, prompts)
            self._audit(fleet, checks, ref, results,
                        expect_replicas=2, expect_min_incidents=1)
            dead = [i for i in fleet.incidents()
                    if i.get("replica") == "chaos-1"]
            checks.append(Check("victim_replaced", bool(dead),
                                f"incidents={fleet.incidents()!r:.200}"))
        finally:
            faults.deactivate(plan)
            fleet.close()
        return self._finish("kill_replica_mid_decode", t0, checks, fleet)

    def wedged_scheduler(self) -> ScenarioResult:
        """A replica's scheduler thread stalls (blocked device call)
        with work pending: the heartbeat watermark goes stale, the
        supervisor condemns it — waiters requeue immediately instead of
        waiting out the stall — and a replacement comes up."""
        t0 = time.monotonic()
        checks: List[Check] = []
        fleet = self._fleet()
        plan = None
        try:
            fleet.scale_up(2)
            prompts = self._prompts(self.requests)
            ref = self._reference(fleet, prompts)
            fleet.start_supervisor(interval_s=0.05, stale_after_s=0.4)
            plan = faults.activate(faults.plan_from_dict({
                "seed": self.seed,
                "rules": [{"point": "engine.step.chaos-1",
                           "action": "delay", "delay_s": 1.5,
                           "nth": 2, "times": 1}],
            }), fleet.registry)
            results = self._run_workload(fleet, prompts)
            self._audit(fleet, checks, ref, results,
                        expect_replicas=2, expect_min_incidents=1)
            wedged = [i for i in fleet.incidents()
                      if i.get("reason") == "wedged"]
            checks.append(Check("wedge_detected", bool(wedged),
                                f"reasons={[i.get('reason') for i in fleet.incidents()]}"))
        finally:
            faults.deactivate(plan)
            fleet.close()
        return self._finish("wedged_scheduler", t0, checks, fleet)

    def double_fault(self) -> ScenarioResult:
        """Supervisor + replica double fault: the probe pass itself
        raises (twice) while a replica is dead. Supervision absorbs its
        own failures (``supervisor_probe_failures_total``) and the third
        pass still recovers the fleet."""
        t0 = time.monotonic()
        checks: List[Check] = []
        fleet = self._fleet()
        plan = None
        try:
            fleet.scale_up(2)
            prompts = self._prompts(self.requests)
            ref = self._reference(fleet, prompts)
            fleet.start_supervisor(interval_s=0.05, stale_after_s=2.0)
            plan = faults.activate(faults.plan_from_dict({
                "seed": self.seed,
                "rules": [{"point": "engine.step.chaos-1",
                           "action": "error", "nth": 2, "times": 1},
                          {"point": "supervisor.probe",
                           "action": "error", "nth": 1, "times": 2}],
            }), fleet.registry)
            results = self._run_workload(fleet, prompts)
            self._audit(fleet, checks, ref, results,
                        expect_replicas=2, expect_min_incidents=1)
            probe_rule = plan.rules[1]
            checks.append(Check("probe_faults_absorbed",
                                probe_rule.fires == 2,
                                f"probe faults fired={probe_rule.fires}"))
        finally:
            faults.deactivate(plan)
            fleet.close()
        return self._finish("double_fault", t0, checks, fleet)

    def poison_pill(self) -> ScenarioResult:
        """One request deterministically kills every replica that admits
        it. After ``max_request_crashes`` strikes it is quarantined
        (4xx, never another crash); the fleet heals and serves everyone
        else bit-identically."""
        t0 = time.monotonic()
        checks: List[Check] = []
        fleet = self._fleet(max_request_crashes=2)
        plan = None
        try:
            fleet.scale_up(2)
            prompts = self._prompts(self.requests)
            ref = self._reference(fleet, prompts)
            fleet.start_supervisor(interval_s=0.05, stale_after_s=2.0)
            plan = faults.activate(faults.plan_from_dict({
                "seed": self.seed,
                "rules": [{"point": "engine.admit.req-poison",
                           "action": "error", "times": 0}],
            }), fleet.registry)
            # the pill runs alone (any co-scheduled request would share
            # its crashes); the bystander workload runs after quarantine
            poison = self._run_workload(
                fleet, [prompts[0]], request_ids={0: "req-poison"},
                timeout=90.0)
            # both struck replicas must be replaced before the bystander
            # workload (healthy_count alone would count the corpses)
            self._wait(lambda: len(fleet.incidents()) >= 2, 30.0)
            results = self._run_workload(fleet, prompts)
            results.update(poison)
            self._audit(fleet, checks, ref, results,
                        expected_failures={
                            "req-poison": "PoisonPillRequest"},
                        expect_replicas=2, expect_min_incidents=2)
            # quarantine is sticky: the retry is refused without
            # touching (or crashing) another replica
            incidents_before = len(fleet.incidents())
            try:
                fleet.handle_request(prompts[0], self.max_new,
                                     request_id="req-poison", timeout=10.0)
                sticky = False
            except PoisonPillRequest:
                sticky = len(fleet.incidents()) == incidents_before
            checks.append(Check("quarantine_sticky", sticky,
                                f"incidents={len(fleet.incidents())} "
                                f"was={incidents_before}"))
        finally:
            faults.deactivate(plan)
            fleet.close()
        return self._finish("poison_pill", t0, checks, fleet)

    def kv_warm_failover(self) -> ScenarioResult:
        """Replica restarted mid-burst warms the shared prefix from the
        KV tier (docs/serving.md "KV memory hierarchy"): every request
        opens with the same full KV block of system prompt; after half
        the burst, ``chaos-1`` is condemned through the self-healing
        path (its resident blocks flush to the fleet-shared
        :class:`KVBlockStore`) and ``chaos-2`` leaves via the drain
        protocol, so the replacement serves the rest of the burst alone
        — promoting the shared block from the tier instead of
        re-prefilling it (``kv_tier_miss_blocks == 0`` is the pin),
        bit-identical, with zero leaked blocks."""
        t0 = time.monotonic()
        checks: List[Check] = []
        store = KVBlockStore(budget_bytes=32 << 20)
        # wider prefill ladder than the default chaos fleet: the shared
        # system prefix must be a FULL block (block_size 8) plus a tail
        fleet = self._fleet(prefix_cache=True, kv_store=store,
                            buckets=BucketSpec.build(2, 16))
        try:
            fleet.scale_up(2)
            system = [5, 9, 2, 7, 4, 8, 3, 6]  # one full KV block
            rng = random.Random(self.seed * 104729 + 7)
            prompts = [system
                       + [1 + rng.randrange(CHAOS_CFG.vocab_size - 7)
                          for _ in range(2 + (i % 3))]
                       for i in range(self.requests)]
            ref = self._reference(fleet, prompts)
            half = max(1, len(prompts) // 2)
            results = self._run_workload(
                fleet, prompts[:half],
                request_ids={i: f"req-{i}" for i in range(half)})
            # mid-burst restart: the self-healing path records the
            # incident and flushes chaos-1's resident blocks to the tier.
            # Settle the victim first — replace_replica only flushes a
            # flushable engine (pending=False), and the scheduler's
            # _busy window can outlive the last front-door handle.
            for rep in fleet.replicas():
                if rep.replica_id == "chaos-1":
                    rep.engine.wait_idle(15.0)
            replacement = fleet.replace_replica("chaos-1",
                                                reason="kv_restart")
            fleet.stop_replica("chaos-2")
            results.update(self._run_workload(
                fleet, prompts[half:],
                request_ids={i: f"req-{half + i}"
                             for i in range(len(prompts) - half)}))
            warm = {}
            for rep in fleet.replicas():
                if rep.replica_id in replacement:
                    st = rep.engine.stats()
                    warm = {"promoted": st.kv_promoted_blocks,
                            "host_hits": st.kv_host_hit_blocks,
                            "cas_hits": st.kv_cas_hit_blocks,
                            "misses": st.kv_miss_blocks}
            checks.append(Check(
                "replacement_warmed_from_tier",
                bool(warm) and warm.get("promoted", 0) >= 1
                and warm.get("misses", 1) == 0,
                f"replacement={replacement} kv={warm}"))
            # >= 1, not >= 2: prefix-affinity routing concentrates the
            # shared-prefix traffic on one replica, so the drained peer
            # may have nothing resident to contribute
            checks.append(Check(
                "tier_captured_flushes",
                store.stats()["puts"] + store.stats()["duplicate_puts"]
                >= 1,
                f"store={store.stats()!r:.200}"))
            # release the survivors' resident prefix blocks before the
            # balance audit: spill to tier, then a same-params hot_swap
            # (the scheduler-synchronized prefix flush)
            for rep in fleet.replicas():
                rep.engine.wait_idle(15.0)
                rep.engine.flush_kv_to_tier()
                rep.engine.hot_swap(self.params)
            self._wait(lambda: all(r.engine.kv_outstanding() == 0
                                   for r in fleet.replicas()), 10.0)
            self._audit(fleet, checks, ref, results,
                        expect_replicas=1, expect_min_incidents=1)
        finally:
            fleet.close()
        return self._finish("kv_warm_failover", t0, checks, fleet)

    def deadline_storm(self) -> ScenarioResult:
        """Deadline propagation under stall: an already-expired request
        504s without touching a replica; a request whose deadline lapses
        mid-decode (injected scheduler stall) is aborted with its blocks
        freed; undeadlined traffic completes bit-identically."""
        t0 = time.monotonic()
        checks: List[Check] = []
        fleet = self._fleet()
        plan = None
        try:
            fleet.scale_up(1)
            prompts = self._prompts(self.requests)
            ref = self._reference(fleet, prompts)
            plan = faults.activate(faults.plan_from_dict({
                "seed": self.seed,
                "rules": [{"point": "engine.step.chaos-1",
                           "action": "delay", "delay_s": 0.5,
                           "nth": 2, "times": 1}],
            }), fleet.registry)
            results = self._run_workload(
                fleet, prompts,
                deadlines={0: 0.0, 1: 0.25},
                request_ids={i: f"req-{i}" for i in range(len(prompts))})
            self._audit(fleet, checks, ref, results,
                        expected_failures={"req-0": "TimeoutError",
                                           "req-1": "TimeoutError"},
                        expect_replicas=1, expect_min_incidents=0)
            pre = results.get("req-0", ("", ""))
            checks.append(Check(
                "expired_before_dispatch_untouched",
                "expired before dispatch" in str(pre[1]),
                f"req-0={pre!r:.120}"))
        finally:
            faults.deactivate(plan)
            fleet.close()
        return self._finish("deadline_storm", t0, checks, fleet)


#: name -> unbound runner method; the catalog order is the docs order.
SCENARIOS: Dict[str, Callable[[ChaosRunner], ScenarioResult]] = {
    "kill_replica_mid_decode": ChaosRunner.kill_replica_mid_decode,
    "wedged_scheduler": ChaosRunner.wedged_scheduler,
    "double_fault": ChaosRunner.double_fault,
    "poison_pill": ChaosRunner.poison_pill,
    "kv_warm_failover": ChaosRunner.kv_warm_failover,
    "deadline_storm": ChaosRunner.deadline_storm,
}


def run_scenarios(names: Optional[Sequence[str]] = None, *, seed: int = 0,
                  mttr_budget_s: float = 30.0, requests: int = 6,
                  params: Optional[gpt.Params] = None,
                  device: DeviceLike = "cuda") -> List[ScenarioResult]:
    """Run the named scenarios (all, by default) on one runner."""
    runner = ChaosRunner(params, seed=seed, mttr_budget_s=mttr_budget_s,
                         requests=requests, device=device)
    picked = list(names) if names else list(SCENARIOS)
    unknown = [n for n in picked if n not in SCENARIOS]
    if unknown:
        raise KeyError(f"unknown chaos scenario(s) {unknown}; "
                       f"known: {sorted(SCENARIOS)}")
    return [SCENARIOS[n](runner) for n in picked]
