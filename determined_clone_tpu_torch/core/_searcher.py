"""SearcherContext — the trial side of hyperparameter search; the port's
copy of ``determined_clone_tpu/core/_searcher.py``.

Equivalent of the reference's _searcher.py:35-365: the trial iterates
``SearcherOperation``s (train-to-length directives from the search method),
reports progress, and completes each op with the searcher metric. Off-cluster
the source is a single synthetic op covering max_length (like the reference's
dummy context); on-cluster ops stream from the master.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional


class SearcherOperation:
    """``length`` is a config Length (records/batches/epochs) or an int
    (batches); the trainer resolves it with its global batch size."""

    def __init__(self, length: Any, *, is_chief: bool,
                 complete_cb: Optional[Callable[[float], None]] = None,
                 progress_cb: Optional[Callable[[float], None]] = None) -> None:
        self.length = length  # cumulative training target
        self._is_chief = is_chief
        self._completed = False
        self._complete_cb = complete_cb
        self._progress_cb = progress_cb

    @property
    def completed(self) -> bool:
        return self._completed

    def report_progress(self, units_completed: float) -> None:
        if self._is_chief and self._progress_cb:
            self._progress_cb(units_completed)

    def complete(self, searcher_metric: float) -> None:
        if self._completed:
            raise RuntimeError("searcher operation already completed")
        self._completed = True
        if self._is_chief and self._complete_cb:
            self._complete_cb(searcher_metric)


class SearcherOperationSource:
    def operations(self, is_chief: bool) -> Iterator[SearcherOperation]:
        raise NotImplementedError


class LocalSearcherSource(SearcherOperationSource):
    """One op to max_length — off-cluster single-searcher behavior."""

    def __init__(self, max_length: Any) -> None:
        self.max_length = max_length
        self.completed_metrics: List[float] = []

    def operations(self, is_chief: bool) -> Iterator[SearcherOperation]:
        yield SearcherOperation(
            self.max_length,
            is_chief=is_chief,
            complete_cb=self.completed_metrics.append,
        )


class SearcherContext:
    def __init__(self, source: SearcherOperationSource, *, is_chief: bool) -> None:
        self._source = source
        self._is_chief = is_chief

    def operations(self) -> Iterator[SearcherOperation]:
        yield from self._source.operations(self._is_chief)
