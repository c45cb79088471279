"""Goodput ledger: attribute every second of trial wall-clock — the
port's copy of ``determined_clone_tpu/telemetry/goodput.py`` (pure Python
there too), held to the same results on the same spans and journals.

All wall-clock since the ledger was born is attributed to **exclusive**
categories, with an explicit ``unattributed`` remainder so the books
always balance.

Categories (:data:`CATEGORIES`):

- ``productive`` — steady-state ``train_dispatch`` time (device compute
  under the per-step sync of the telemetry branch: each span waits for
  the step's output on its stream);
- ``compile`` — in the port, a step program's first call (the lazy
  ``nvcc`` build, cuBLAS and cuDNN setup, allocator growth), which
  ``Telemetry.wrap_jit`` marks ``compiled``, plus any explicit capture
  outside a dispatch (an ``xla_compile`` span with ``explicit=True``);
- ``data_wait`` — consumer-visible input stall (``dataload_wait``);
- ``host_sync`` — chunk-boundary metric fetches;
- ``validation`` — the whole validation pass (its nested
  ``eval_dispatch`` spans are *not* double-counted);
- ``checkpoint_save`` / ``restore_replay`` — checkpoint store, and
  restore + the batch replay that fast-forwards the data iterator;
- ``restart_backoff`` — runner backoff sleeps plus, in the merged
  trial-lifetime view, the dead time between restart legs;
- ``queue_wait`` — scheduler queue wait for this leg, handed to the
  trial via the ``DCT_QUEUE_WAIT_S`` environment variable;
- ``anomaly_overhang`` — straggler overhang: for each step the step-time
  detector flags, the excess over the rolling median is moved out of
  ``productive``;
- ``unattributed`` — everything else (startup, Python glue between
  spans). Explicit, so conservation is checkable.

**Conservation invariant**: the categories (including ``unattributed``)
sum to the ledger's wall-clock. ``unattributed`` is computed as the
remainder, so the only way to violate the invariant is *over*-counting
(double-attributed time); :func:`check_conservation` flags any overcount
beyond tolerance (default 1%). Only depth-0 consumer-loop spans are
bucketed (nested spans and producer-thread lanes are ignored), and the
``xla_compile`` span ``wrap_jit`` records *over the same interval* as a
``compiled=True`` dispatch span is skipped.

**Durability**: attach a journal directory and every publish appends a
cumulative snapshot line to a per-leg JSONL file, line-buffered — a
``kill -9`` loses at most the interval since the last chunk boundary.
Restart legs open new files (``goodput-trial00007-leg00002.jsonl``) next
to the dead leg's; :func:`merge_goodput` folds all legs of a trial into
one trial-lifetime account, attributing the wall-clock gap *between*
legs to ``restart_backoff``. The journal format is the JAX package's, so
either package reads and merges the other's legs.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from determined_clone_tpu_torch import faults

#: Exclusive wall-clock categories, in display order. ``unattributed``
#: is always last and always the computed remainder.
CATEGORIES = (
    "productive",
    "compile",
    "data_wait",
    "host_sync",
    "validation",
    "checkpoint_save",
    "restore_replay",
    "restart_backoff",
    "queue_wait",
    "anomaly_overhang",
    "unattributed",
)

#: Badput categories that came out of fault handling — the merge test
#: compares these against an uninterrupted run's (expected) zeros.
RESTART_CATEGORIES = ("restart_backoff", "restore_replay")

# Depth-0 consumer-loop span names → category. Producer-thread spans
# (produce_batch / dataload_next / device_put) overlap consumer compute
# and are deliberately absent; nested spans (eval_dispatch inside
# validate, storage spans inside checkpoint_save) are excluded by the
# depth filter.
SPAN_CATEGORIES: Dict[str, str] = {
    "train_dispatch": "productive",
    "dataload_wait": "data_wait",
    "host_sync": "host_sync",
    "validate": "validation",
    "checkpoint_save": "checkpoint_save",
    "checkpoint_restore": "restore_replay",
    "restore_replay": "restore_replay",
}

GOODPUT_RE = re.compile(r"goodput-trial(\d+)-leg(\d+)\.jsonl$")


class GoodputLedger:
    """Attributes wall-clock since construction into exclusive buckets.

    Wired as a tracer sink (:meth:`observe_span` sees every finished
    span record); non-span time arrives via :meth:`note`. Thread-safe:
    spans finish on the consumer thread, notes can come from anywhere.
    """

    def __init__(self, *, registry: Optional[Any] = None,
                 trial_id: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        # epoch anchor for cross-leg merge only — never used for interval
        # arithmetic inside a process (perf_counter owns that)
        self._wall_epoch_start = time.time()
        # time attributed from *before* this ledger existed (scheduler
        # queue wait): it extends the accountable wall-clock, otherwise
        # booking it would overflow the perf_counter-measured wall
        self._pre_wall_s = 0.0
        self._seconds: Dict[str, float] = {
            c: 0.0 for c in CATEGORIES if c != "unattributed"}
        self.trial_id = trial_id
        self.trace_id: Optional[str] = None
        self._registry = registry
        self._journal: Optional[GoodputJournal] = None

    # -- identity / attachment ---------------------------------------------

    def set_identity(self, *, trial_id: Optional[int] = None,
                     trace_id: Optional[str] = None) -> None:
        """Late-bind identity (core.init learns the trial id after the
        telemetry object exists). Must land before the first journal
        write — the journal file is named by trial id."""
        with self._lock:
            if trial_id is not None:
                self.trial_id = int(trial_id)
            if trace_id is not None:
                self.trace_id = trace_id

    def attach_journal(self, directory: str) -> None:
        """Durable per-leg JSONL journal (flight-recorder durability:
        line-buffered writes survive kill -9). Opens lazily on the first
        write so the trial id set by core.init names the file."""
        self._journal = GoodputJournal(directory, registry=self._registry)

    @property
    def journal(self) -> Optional["GoodputJournal"]:
        return self._journal

    # -- attribution --------------------------------------------------------

    def observe_span(self, rec: Dict[str, Any]) -> None:
        """Tracer sink: bucket one finished span record.

        Only depth-0 records with a mapped name contribute; everything
        else (producer lanes, nested spans, unknown names) is ignored —
        missing a span leaves honest ``unattributed`` time, while a
        mis-bucketed one would break exclusivity.
        """
        name = rec.get("name")
        args = rec.get("args") or {}
        if rec.get("ph") == "i":
            if name == "step_time_anomaly":
                self._note_anomaly(args)
            return
        if name == "xla_compile":
            # wrap_jit synthesizes this over the SAME interval as the
            # compiled=True dispatch span it rode in — counting both
            # would double-book; only the explicit AOT capture (which
            # runs outside any dispatch span) counts directly.
            if args.get("explicit"):
                self._add("compile", float(rec.get("dur_us", 0)) / 1e6)
            return
        if rec.get("depth", 0) != 0:
            return
        category = SPAN_CATEGORIES.get(str(name))
        if category is None:
            return
        if category == "productive" and args.get("compiled"):
            category = "compile"
        self._add(category, float(rec.get("dur_us", 0)) / 1e6)

    def _note_anomaly(self, args: Dict[str, Any]) -> None:
        """Move a flagged step's overhang from productive to
        anomaly_overhang (the dispatch span itself already landed in
        productive — the detector's instant event arrives right after)."""
        try:
            overhang = float(args["duration_s"]) - float(args["median_s"])
        except (KeyError, TypeError, ValueError):
            return
        if overhang <= 0:
            return
        with self._lock:
            moved = min(overhang, self._seconds["productive"])
            self._seconds["productive"] -= moved
            self._seconds["anomaly_overhang"] += moved

    def note(self, category: str, seconds: float, *,
             pre_wall: bool = False) -> None:
        """Explicit attribution for un-spanned time: the runner's restart
        backoff sleep, the scheduler queue wait from the master's lifecycle
        timestamps (``DCT_QUEUE_WAIT_S``).

        ``pre_wall=True`` marks time spent *before* this ledger existed
        (queue wait predates the process): it is added to the accountable
        wall-clock too, so conservation still balances.
        """
        if category not in self._seconds:
            raise ValueError(f"unknown goodput category {category!r} "
                             f"(want one of {CATEGORIES})")
        seconds = float(seconds)
        if pre_wall and seconds > 0:
            with self._lock:
                self._pre_wall_s += seconds
                self._wall_epoch_start -= seconds
        self._add(category, seconds)

    def _add(self, category: str, seconds: float) -> None:
        if seconds <= 0:
            return
        with self._lock:
            self._seconds[category] += seconds

    # -- accounting ---------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Cumulative account since construction. ``unattributed`` is the
        remainder; ``overcount_s`` is how far attribution exceeds
        wall-clock (0.0 on a healthy ledger — any positive value means
        double-counted time and is what conservation checks police)."""
        with self._lock:
            wall = time.perf_counter() - self._t0 + self._pre_wall_s
            seconds = dict(self._seconds)
        attributed = sum(seconds.values())
        remainder = wall - attributed
        categories = dict(seconds)
        categories["unattributed"] = max(0.0, remainder)
        productive = categories["productive"]
        return {
            "trial_id": self.trial_id,
            "trace_id": self.trace_id,
            "wall_s": wall,
            "wall_epoch_start": self._wall_epoch_start,
            "categories": categories,
            "overcount_s": max(0.0, -remainder),
            "goodput_fraction": (productive / wall) if wall > 0 else None,
        }

    # -- export -------------------------------------------------------------

    def publish_metrics(self, registry: Optional[Any] = None
                        ) -> Dict[str, Any]:
        """Land the account in the metrics registry (per-category labeled
        gauge + wall + fraction) so the normal snapshot-shipping path
        carries it to the aggregator; journal a durable line if a journal
        is attached. Called from ``Telemetry.publish`` at every chunk
        boundary. Returns the snapshot it published."""
        snap = self.snapshot()
        reg = registry if registry is not None else self._registry
        if reg is not None:
            for cat, secs in snap["categories"].items():
                reg.gauge(
                    "goodput_seconds_total",
                    "cumulative wall-clock attributed per goodput "
                    "category (exclusive; sums to goodput_wall_seconds)",
                    labels={"category": cat}).set(secs)
            reg.gauge(
                "goodput_wall_seconds",
                "wall-clock this ledger has been accounting").set(
                snap["wall_s"])
            if snap["goodput_fraction"] is not None:
                reg.gauge(
                    "goodput_fraction",
                    "productive seconds / wall seconds for this leg").set(
                    snap["goodput_fraction"])
        if self._journal is not None:
            self._journal.write(snap)
        return snap

    def close(self) -> None:
        """Final durable line + fsync on clean shutdown (a crash skips
        this — the line-buffered journal is already on disk)."""
        if self._journal is not None:
            self._journal.write(self.snapshot())
            self._journal.close()


def check_conservation(snapshot: Dict[str, Any],
                       tolerance: float = 0.01) -> Dict[str, Any]:
    """The hard invariant: categories sum to wall-clock within
    ``tolerance`` (relative). Returns ``{"ok", "wall_s", "sum_s",
    "error_s", "error_fraction"}`` — callers assert ``ok``.

    By construction the sum equals wall exactly while attribution fits
    inside wall; the failure mode this catches is *over*-attribution
    (the same second booked twice), which shows up as sum > wall.
    """
    wall = float(snapshot["wall_s"])
    total = float(sum(snapshot["categories"].values()))
    err = abs(total - wall)
    denom = max(wall, 1e-9)
    return {
        "ok": err <= tolerance * denom + 1e-6,
        "wall_s": wall,
        "sum_s": total,
        "error_s": err,
        "error_fraction": err / denom,
    }


class GoodputJournal:
    """Per-leg durable JSONL journal of cumulative ledger snapshots.

    Flight-recorder durability model (telemetry/flight.py): every line
    goes through a line-buffered file straight to the kernel, so a
    kill -9 keeps everything already written; close() fsyncs. One file
    per leg; a restart leg opens the next ``legNNNNN`` file instead of
    clobbering the dead leg's evidence. Readers take the *last* parseable
    line per file (snapshots are cumulative), tolerating a torn final
    line from a mid-write crash.

    Failure policy: write errors (disk full, the injected
    ``goodput.write`` fault point) drop the line and count it — the
    ledger observes training and must never take it down.
    """

    def __init__(self, directory: str, *,
                 registry: Optional[Any] = None) -> None:
        self.directory = directory
        self._lock = threading.Lock()
        self._file: Optional[Any] = None
        self._leg: Optional[int] = None
        self._dropped = (registry.counter(
            "goodput_records_dropped",
            "goodput journal lines lost to write errors")
            if registry is not None else None)
        self._dropped_total = 0
        os.makedirs(directory, exist_ok=True)

    @property
    def leg(self) -> Optional[int]:
        return self._leg

    @property
    def records_dropped(self) -> int:
        return self._dropped_total

    def _open(self, trial_id: int) -> None:
        # resume past existing legs for this trial — restart legs append
        # new files (the flight-recorder segment-resume idiom)
        prev = 0
        for path in _journal_paths(self.directory):
            m = GOODPUT_RE.search(path)
            if m and int(m.group(1)) == trial_id:
                prev = max(prev, int(m.group(2)))
        self._leg = prev + 1
        path = os.path.join(
            self.directory,
            f"goodput-trial{trial_id:05d}-leg{self._leg:05d}.jsonl")
        # buffering=1: line-buffered — the kill -9 durability level
        self._file = open(path, "w", buffering=1)
        meta = {"kind": "meta", "trial_id": trial_id, "leg": self._leg,
                "pid": os.getpid(), "wall_epoch_write": time.time()}
        self._file.write(json.dumps(meta, default=str) + "\n")

    def write(self, snapshot: Dict[str, Any]) -> None:
        entry = {"kind": "goodput", "wall_epoch": time.time(), **snapshot}
        try:
            line = json.dumps(entry, default=str)
        except (TypeError, ValueError):
            self._drop()
            return
        # fault point outside the lock (CONC003/4 lock hierarchy): a
        # delay-action fault stalls this writer only, not every thread
        # serializing on _lock; raise-action still counts as a drop
        try:
            faults.point("goodput.write")
        except Exception:  # noqa: BLE001 - observer, never a dependency
            self._drop()
            return
        with self._lock:
            try:
                if self._file is None:
                    self._open(int(snapshot.get("trial_id") or 0))
                self._file.write(line + "\n")
            except Exception:  # noqa: BLE001 - observer, never a dependency
                self._drop()

    def _drop(self) -> None:
        self._dropped_total += 1
        if self._dropped is not None:
            self._dropped.inc()

    def close(self) -> None:
        with self._lock:
            f, self._file = self._file, None
        if f is not None:
            try:
                f.flush()
                os.fsync(f.fileno())
                f.close()
            except OSError:
                self._drop()


# -- reading / merging ------------------------------------------------------


def _journal_paths(directory: str) -> List[str]:
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return [os.path.join(directory, n)
            for n in sorted(names) if GOODPUT_RE.search(n)]


def read_goodput(directory: str) -> Iterator[Dict[str, Any]]:
    """Yield one record per journal file: the file's last parseable
    cumulative snapshot, annotated with ``trial_id``/``leg`` from the
    filename (authoritative — a torn write can't lie about identity)."""
    for path in _journal_paths(directory):
        m = GOODPUT_RE.search(path)
        if m is None:
            continue
        last: Optional[Dict[str, Any]] = None
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn final line at the crash point
                    if isinstance(rec, dict) and rec.get("kind") == "goodput":
                        last = rec
        except OSError:
            continue
        if last is not None:
            last["trial_id"] = int(m.group(1))
            last["leg"] = int(m.group(2))
            yield last


def merge_goodput(directory: str) -> Dict[int, Dict[str, Any]]:
    """Fold every leg in a journal directory into per-trial lifetime
    accounts, keyed by trial id.

    The gap between consecutive legs (previous leg's last journaled
    instant → next leg's start epoch) is *dead* restart time — backoff
    sleep, process re-spawn, re-import — and is attributed to
    ``restart_backoff``: an injected kill -9 must show up as restart
    badput, never as missing time. Epochs come from the journal lines
    (wall clock is the only clock comparable across processes).
    """
    legs_by_trial: Dict[int, List[Dict[str, Any]]] = {}
    for rec in read_goodput(directory):
        legs_by_trial.setdefault(int(rec["trial_id"]), []).append(rec)

    merged: Dict[int, Dict[str, Any]] = {}
    for trial_id, legs in legs_by_trial.items():
        legs.sort(key=lambda r: int(r["leg"]))
        categories = {c: 0.0 for c in CATEGORIES}
        wall = 0.0
        conservation_ok = True
        prev_end: Optional[float] = None
        for leg in legs:
            cats = leg.get("categories") or {}
            for c in CATEGORIES:
                categories[c] += float(cats.get(c, 0.0))
            leg_wall = float(leg.get("wall_s", 0.0))
            wall += leg_wall
            conservation_ok = (conservation_ok
                               and check_conservation(leg)["ok"])
            start = leg.get("wall_epoch_start")
            end = (float(start) + leg_wall if start is not None
                   else leg.get("wall_epoch"))
            if prev_end is not None and start is not None:
                gap = max(0.0, float(start) - float(prev_end))
                categories["restart_backoff"] += gap
                wall += gap
            if end is not None:
                prev_end = float(end)
        productive = categories["productive"]
        merged[trial_id] = {
            "trial_id": trial_id,
            "legs": len(legs),
            "wall_s": wall,
            "categories": categories,
            "goodput_fraction": (productive / wall) if wall > 0 else None,
            "conservation_ok": conservation_ok,
        }
    return merged


def format_goodput(accounts: Dict[int, Dict[str, Any]]) -> str:
    """Human-readable per-trial goodput table for ``dct goodput``."""
    out: List[str] = []
    for trial_id in sorted(accounts):
        acct = accounts[trial_id]
        frac = acct.get("goodput_fraction")
        frac_s = f"{frac:.1%}" if frac is not None else "n/a"
        out.append(
            f"trial {trial_id}: goodput {frac_s} over "
            f"{acct['wall_s']:.2f}s wall ({acct.get('legs', 1)} leg(s))"
            + ("" if acct.get("conservation_ok", True)
               else "  [CONSERVATION VIOLATED]"))
        cats = acct.get("categories") or {}
        wall = max(float(acct.get("wall_s") or 0.0), 1e-9)
        for cat in CATEGORIES:
            secs = float(cats.get(cat, 0.0))
            if secs <= 0:
                continue
            out.append(f"  {cat:<18} {secs:>9.3f}s  {secs / wall:6.1%}")
    if not out:
        out.append("no goodput accounts found")
    return "\n".join(out)


__all__ = [
    "CATEGORIES",
    "RESTART_CATEGORIES",
    "SPAN_CATEGORIES",
    "GoodputJournal",
    "GoodputLedger",
    "check_conservation",
    "format_goodput",
    "merge_goodput",
    "read_goodput",
]
