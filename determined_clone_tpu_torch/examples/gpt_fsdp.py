"""GPT trial — the port of ``examples/gpt_fsdp/model_def.py`` (GPTTrial),
with the same hyperparameter names and defaults (``fsdp.yaml`` sets
GPT-2 small: 12 layers, d 768, 12 heads, d_ff 3072, vocab 50304, seq
1024, batch 8, lr 3e-4, weight decay 0.1, remat on).

The optimizer is the JAX trial's: ``chain(clip_by_global_norm(1.0),
adamw(lr, b1=0.9, b2=0.95, weight_decay))``. ``attention_impl: auto``
runs the CUDA flash-attention kernel on the card. The ``mesh`` hparam
picks the layout, as in the JAX trial: ``fsdp.yaml``'s ``{fsdp: 8}`` with
``slots_per_trial: 8`` runs on 8 ranks started by ``exec/launch.py``,
placed by ``GPT_SHARDING_RULES``.

Data: deterministic synthetic token streams with bigram structure (each
token's successor is drawn from a per-token distribution), generated as
the JAX trial generates them, so both trials see the same batches.
"""
from __future__ import annotations

import numpy as np

from determined_clone_tpu_torch.models import gpt
from determined_clone_tpu_torch.telemetry import flops
from determined_clone_tpu_torch.training import TorchTrial
from determined_clone_tpu_torch.training import optim


def _bigram_stream(n_tokens, vocab_size, seed=0, branching=4):
    """Markov-1 token stream: each token has `branching` likely successors."""
    rng = np.random.RandomState(1234)  # transition table fixed across trials
    successors = rng.randint(0, vocab_size, size=(vocab_size, branching))
    sample = np.random.RandomState(seed)
    out = np.empty(n_tokens, np.int32)
    out[0] = sample.randint(vocab_size)
    choices = sample.randint(0, branching, size=n_tokens)
    for i in range(1, n_tokens):
        out[i] = successors[out[i - 1], choices[i]]
    return out


class GPTTrial(TorchTrial):
    def __init__(self, context):
        super().__init__(context)
        get = context.get_hparam
        self.cfg = gpt.GPTConfig(
            vocab_size=int(get("vocab_size", 50304)),
            n_layers=int(get("n_layers", 12)),
            d_model=int(get("d_model", 768)),
            n_heads=int(get("n_heads", 12)),
            d_ff=int(get("d_ff", 3072)),
            max_seq_len=int(get("seq_len", 1024)),
            remat=bool(get("remat", True)),
            attention_impl=str(get("attention_impl", "auto")),
        )
        self.seq_len = int(get("seq_len", 1024))

    def initial_params(self, gen):
        return gpt.init(gen, self.cfg, device=self.context.device)

    def optimizer(self):
        get = self.context.get_hparam
        return optim.chain(
            optim.clip_by_global_norm(1.0),
            optim.adamw(float(get("lr", 3e-4)), b1=0.9, b2=0.95,
                        weight_decay=float(get("weight_decay", 0.1))),
        )

    def train_step_flops(self):
        """The GPT's analytic FLOPs for one step over the global batch
        (``telemetry.flops.gpt_train_step_flops``: every token of every
        sample, attention included). The JAX trial gives no count, and
        its trainer falls back to ``dense_6n`` over one token a sample,
        1/``seq_len`` of the real figure."""
        return flops.gpt_train_step_flops(self.cfg, self.global_batch_size,
                                          self.seq_len)

    def loss(self, params, batch, seed):
        return gpt.loss_fn(params, self.cfg, batch[:, :-1], batch[:, 1:]), {}

    def sharding_rules(self):
        return gpt.GPT_SHARDING_RULES

    def training_data(self):
        bs, T = self.global_batch_size, self.seq_len
        stream = _bigram_stream(
            int(self.context.get_hparam("n_train_tokens", 2_000_000)),
            self.cfg.vocab_size)
        n_seqs = len(stream) // (T + 1)
        seqs = stream[: n_seqs * (T + 1)].reshape(n_seqs, T + 1)
        i = 0
        while True:
            sel = np.arange(i, i + bs) % n_seqs
            yield seqs[sel]
            i += bs

    def validation_data(self):
        bs, T = self.global_batch_size, self.seq_len
        stream = _bigram_stream(bs * (T + 1), self.cfg.vocab_size, seed=9)
        return [stream.reshape(bs, T + 1)]
