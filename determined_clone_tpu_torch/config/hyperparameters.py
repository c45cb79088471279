"""Hyperparameter space definitions — the port's copy of
``determined_clone_tpu/config/hyperparameters.py`` (the same ``random.Random``
draws, so one seed draws the same hparams in either package).

Equivalent of the reference expconf hyperparameter union types
(master/pkg/schemas/expconf/hparam.go and schemas/expconf/v0/hyperparameter-*.json):
const / int / double / log / categorical, plus arbitrarily nested dicts.

A hyperparameter space is a nested dict whose leaves are either plain JSON
values (implicit const) or ``{"type": ...}`` dicts. ``sample()`` draws a
concrete assignment; ``grid_points()`` enumerates the grid for the grid
searcher (reference: master/pkg/searcher/grid.go).
"""
from __future__ import annotations

import abc
import dataclasses
import math
import random
from typing import Any, Dict, Iterator, List, Optional, Sequence


class Hyperparameter(abc.ABC):
    @abc.abstractmethod
    def sample(self, rng: random.Random) -> Any:
        ...

    @abc.abstractmethod
    def grid_points(self) -> List[Any]:
        """Values this hparam contributes to a grid search."""
        ...

    @abc.abstractmethod
    def to_dict(self) -> Dict[str, Any]:
        ...


@dataclasses.dataclass(frozen=True)
class Const(Hyperparameter):
    value: Any

    def sample(self, rng: random.Random) -> Any:
        return self.value

    def grid_points(self) -> List[Any]:
        return [self.value]

    def to_dict(self) -> Dict[str, Any]:
        return {"type": "const", "val": self.value}


@dataclasses.dataclass(frozen=True)
class Int(Hyperparameter):
    minval: int
    maxval: int
    count: Optional[int] = None  # for grid search

    def __post_init__(self) -> None:
        if self.minval > self.maxval:
            raise ValueError(f"int hparam: minval {self.minval} > maxval {self.maxval}")

    def sample(self, rng: random.Random) -> int:
        return rng.randint(self.minval, self.maxval)

    def grid_points(self) -> List[int]:
        n = self.count if self.count else (self.maxval - self.minval + 1)
        n = min(n, self.maxval - self.minval + 1)
        if n == 1:
            return [self.minval]
        step = (self.maxval - self.minval) / (n - 1)
        return [round(self.minval + i * step) for i in range(n)]

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"type": "int", "minval": self.minval, "maxval": self.maxval}
        if self.count is not None:
            d["count"] = self.count
        return d


@dataclasses.dataclass(frozen=True)
class Double(Hyperparameter):
    minval: float
    maxval: float
    count: Optional[int] = None

    def __post_init__(self) -> None:
        if self.minval > self.maxval:
            raise ValueError(f"double hparam: minval {self.minval} > maxval {self.maxval}")

    def sample(self, rng: random.Random) -> float:
        return rng.uniform(self.minval, self.maxval)

    def grid_points(self) -> List[float]:
        if not self.count:
            raise ValueError("double hparam requires `count` for grid search")
        if self.count == 1:
            return [self.minval]
        step = (self.maxval - self.minval) / (self.count - 1)
        return [self.minval + i * step for i in range(self.count)]

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"type": "double", "minval": self.minval, "maxval": self.maxval}
        if self.count is not None:
            d["count"] = self.count
        return d


@dataclasses.dataclass(frozen=True)
class Log(Hyperparameter):
    """Log-uniform over [base**minval, base**maxval]."""

    minval: float
    maxval: float
    base: float = 10.0
    count: Optional[int] = None

    def __post_init__(self) -> None:
        if self.minval > self.maxval:
            raise ValueError(f"log hparam: minval {self.minval} > maxval {self.maxval}")
        if self.base <= 0:
            raise ValueError("log hparam: base must be positive")

    def sample(self, rng: random.Random) -> float:
        return self.base ** rng.uniform(self.minval, self.maxval)

    def grid_points(self) -> List[float]:
        if not self.count:
            raise ValueError("log hparam requires `count` for grid search")
        if self.count == 1:
            return [self.base**self.minval]
        step = (self.maxval - self.minval) / (self.count - 1)
        return [self.base ** (self.minval + i * step) for i in range(self.count)]

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "type": "log", "minval": self.minval, "maxval": self.maxval, "base": self.base,
        }
        if self.count is not None:
            d["count"] = self.count
        return d


@dataclasses.dataclass(frozen=True)
class Categorical(Hyperparameter):
    vals: Sequence[Any]

    def __post_init__(self) -> None:
        if not self.vals:
            raise ValueError("categorical hparam needs at least one value")

    def sample(self, rng: random.Random) -> Any:
        return rng.choice(list(self.vals))

    def grid_points(self) -> List[Any]:
        return list(self.vals)

    def to_dict(self) -> Dict[str, Any]:
        return {"type": "categorical", "vals": list(self.vals)}


_HP_TYPES = {"const", "int", "double", "log", "categorical"}


def parse_hyperparameter(raw: Any) -> Hyperparameter:
    """Parse one leaf of the hparam space. Non-dict (or dict without a known
    "type") values are implicit consts, matching the reference's behavior."""
    if isinstance(raw, dict) and raw.get("type") in _HP_TYPES:
        t = raw["type"]
        if t == "const":
            return Const(raw.get("val"))
        if t == "int":
            return Int(int(raw["minval"]), int(raw["maxval"]), raw.get("count"))
        if t == "double":
            return Double(float(raw["minval"]), float(raw["maxval"]), raw.get("count"))
        if t == "log":
            return Log(
                float(raw["minval"]), float(raw["maxval"]),
                float(raw.get("base", 10.0)), raw.get("count"),
            )
        if t == "categorical":
            return Categorical(list(raw["vals"]))
    return Const(raw)


class HyperparameterSpace:
    """A nested hparam space; leaves are Hyperparameter objects."""

    def __init__(self, raw: Optional[Dict[str, Any]] = None) -> None:
        self.raw = raw or {}
        self._flat: Dict[str, Hyperparameter] = {}
        self._flatten("", self.raw)

    def _flatten(self, prefix: str, node: Any) -> None:
        if isinstance(node, dict) and not (node.get("type") in _HP_TYPES):
            for k, v in node.items():
                if "." in str(k):
                    raise ValueError(
                        f"hyperparameter name {k!r} may not contain '.' "
                        f"(reserved as the nesting separator)"
                    )
                self._flatten(f"{prefix}{k}.", v)
        else:
            self._flat[prefix[:-1] if prefix.endswith(".") else prefix] = (
                parse_hyperparameter(node)
            )

    @property
    def flat(self) -> Dict[str, Hyperparameter]:
        return dict(self._flat)

    def sample(self, rng: random.Random) -> Dict[str, Any]:
        """Draw one concrete (nested) assignment."""
        return self._unflatten({k: hp.sample(rng) for k, hp in self._flat.items()})

    def grid(self) -> Iterator[Dict[str, Any]]:
        """Enumerate the full cartesian grid (reference grid.go semantics)."""
        keys = sorted(self._flat)
        axes = [self._flat[k].grid_points() for k in keys]
        total = math.prod(len(a) for a in axes) if axes else 0
        if total == 0:
            yield {}
            return
        idx = [0] * len(axes)
        for _ in range(total):
            yield self._unflatten({k: axes[i][idx[i]] for i, k in enumerate(keys)})
            for i in reversed(range(len(axes))):
                idx[i] += 1
                if idx[i] < len(axes[i]):
                    break
                idx[i] = 0

    def grid_size(self) -> int:
        # empty product = 1, matching grid()'s single empty config
        return math.prod(len(hp.grid_points()) for hp in self._flat.values())

    @staticmethod
    def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key, val in flat.items():
            parts = key.split(".")
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = val
        return out
