"""Language-model training batches: the port's GPT trial stream (a bigram
chain in which each token has ``branching`` likely successors, drawn from
a table fixed by ``transition_seed``), frozen here and drawn from the
run's seed.

Every row of every batch is a chain of its own, started at a random
token, so no two rows agree. Batch ``i`` depends only on the seed and
``i``: the reference draws the same batches again.
"""
from __future__ import annotations

import numpy as np


class LmTrainStream:
    def __init__(self, mix: dict, cfg: dict, seed: int) -> None:
        self.B = int(mix["global_batch"])
        self.T = int(mix["seq_len"])
        self.vocab = int(cfg.get("token_vocab", cfg["vocab_size"]))
        self.seed = int(seed)
        table_rng = np.random.RandomState(int(mix.get("transition_seed",
                                                      1234)))
        self.successors = table_rng.randint(
            0, self.vocab, size=(self.vocab, int(mix.get("branching", 4))))

    def batch(self, i: int) -> np.ndarray:
        """Batch ``i``: int32 [B, T + 1] (inputs and shifted targets)."""
        rng = np.random.default_rng([self.seed, 11, int(i)])
        out = np.empty((self.B, self.T + 1), np.int32)
        out[:, 0] = rng.integers(0, self.vocab, self.B)
        choice = rng.integers(0, self.successors.shape[1],
                              (self.B, self.T + 1))
        rows = np.arange(self.B)
        for t in range(1, self.T + 1):
            out[:, t] = self.successors[out[:, t - 1], choice[rows, t]]
        return out

    def __iter__(self):
        i = 0
        while True:
            yield self.batch(i)
            i += 1
