"""Hyperparameter search engine (≈ master/pkg/searcher — SURVEY.md §2.1):
the port's copy of ``determined_clone_tpu/searcher``. It imports no
framework; the same events give the same operations and the same
snapshots in either package, and each restores the other's snapshot."""
from determined_clone_tpu_torch.config.experiment import SearcherConfig
from determined_clone_tpu_torch.config.hyperparameters import (
    HyperparameterSpace,
)
from determined_clone_tpu_torch.searcher.adaptive import AdaptiveASHASearch
from determined_clone_tpu_torch.searcher.asha import ASHASearch
from determined_clone_tpu_torch.searcher.base import (
    Close,
    Create,
    Operation,
    Searcher,
    SearchMethod,
    Shutdown,
    ValidateAfter,
)
from determined_clone_tpu_torch.searcher.custom import (
    LocalSearchRunner,
    RemoteSearchRunner,
)
from determined_clone_tpu_torch.searcher.methods import (
    GridSearch,
    RandomSearch,
    SingleSearch,
)
from determined_clone_tpu_torch.searcher.simulate import (
    SimResult,
    SimTrial,
    simulate,
)


def build_method(config: SearcherConfig, space: HyperparameterSpace,
                 seed: int = 0) -> SearchMethod:
    """Factory over the searcher union (≈ expconf searcher_config.go:16-28)."""
    if config.name == "single":
        return SingleSearch(config, space, seed)
    if config.name == "random":
        return RandomSearch(config, space, seed)
    if config.name == "grid":
        return GridSearch(config, space, seed)
    if config.name == "asha":
        return ASHASearch(config, space, seed)
    if config.name == "adaptive_asha":
        return AdaptiveASHASearch(config, space, seed)
    raise ValueError(
        f"searcher {config.name!r} has no built-in method — custom searchers "
        f"pass their SearchMethod to searcher.RemoteSearchRunner (cluster, "
        f"via the master's event queue) or searcher.LocalSearchRunner"
    )


__all__ = [
    "AdaptiveASHASearch",
    "ASHASearch",
    "Close",
    "Create",
    "GridSearch",
    "LocalSearchRunner",
    "RemoteSearchRunner",
    "Operation",
    "RandomSearch",
    "Searcher",
    "SearchMethod",
    "Shutdown",
    "SimResult",
    "SimTrial",
    "SingleSearch",
    "ValidateAfter",
    "build_method",
    "simulate",
]
