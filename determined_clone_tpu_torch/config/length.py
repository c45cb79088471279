"""Training-length units — the port's copy of
``determined_clone_tpu/config/length.py``.

Equivalent of the reference's ``expconf.Length`` (master/pkg/schemas/expconf/length.go):
a quantity of training expressed in records, batches, or epochs. The trainer
resolves everything to batches given ``global_batch_size`` and
``records_per_epoch``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Union


class Unit(str, enum.Enum):
    RECORDS = "records"
    BATCHES = "batches"
    EPOCHS = "epochs"


@dataclasses.dataclass(frozen=True)
class Length:
    unit: Unit
    value: int

    def __post_init__(self) -> None:
        if self.value < 0:
            raise ValueError(f"Length value must be >= 0, got {self.value}")

    @staticmethod
    def records(value: int) -> "Length":
        return Length(Unit.RECORDS, value)

    @staticmethod
    def batches(value: int) -> "Length":
        return Length(Unit.BATCHES, value)

    @staticmethod
    def epochs(value: int) -> "Length":
        return Length(Unit.EPOCHS, value)

    @staticmethod
    def from_dict(d: Union[int, Dict[str, Any]]) -> "Length":
        """Parse ``{"batches": 100}`` / ``{"epochs": 2}`` / ``{"records": 5000}``.

        A bare int means batches (the reference's default ``scheduling_unit``
        semantics).
        """
        if isinstance(d, int):
            return Length.batches(d)
        if not isinstance(d, dict) or len(d) != 1:
            raise ValueError(
                f"a length must be an int or a single-key dict of "
                f"records/batches/epochs, got {d!r}"
            )
        (key, value), = d.items()
        try:
            unit = Unit(key)
        except ValueError:
            raise ValueError(f"unknown length unit {key!r}") from None
        if not isinstance(value, int):
            raise ValueError(f"length value must be an int, got {value!r}")
        return Length(unit, value)

    def to_dict(self) -> Dict[str, int]:
        return {self.unit.value: self.value}

    def to_batches(self, global_batch_size: int, records_per_epoch: int = 0) -> int:
        """Resolve to a batch count."""
        if self.unit == Unit.BATCHES:
            return self.value
        if self.unit == Unit.RECORDS:
            if global_batch_size <= 0:
                raise ValueError("global_batch_size must be positive to convert records")
            return max(1, self.value // global_batch_size)
        # epochs
        if records_per_epoch <= 0:
            raise ValueError(
                "records_per_epoch must be set in the experiment config to use "
                "epoch-based lengths"
            )
        if global_batch_size <= 0:
            raise ValueError("global_batch_size must be positive to convert epochs")
        return max(1, (self.value * records_per_epoch) // global_batch_size)

    def __str__(self) -> str:
        return f"{self.value} {self.unit.value}"
