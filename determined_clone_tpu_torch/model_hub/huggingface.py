"""HuggingFace transformers adapter — causal-LM trials, the port of
``determined_clone_tpu/model_hub/huggingface.py`` over transformers'
PyTorch models.

The model is ``AutoModelForCausalLM.from_config(model_config())``, a
random init in this process; the trial's parameters are its named
tensors, and the loss calls the module through
``torch.func.functional_call`` with them, so the Trainer owns the
weights as it owns any trial's. Where the JAX trial can also load
``from_pretrained`` weights, the port builds from the config only: no
download, no hub cache. ``transformers`` is imported when the model is
built, so the package imports without it.

Usage::

    from transformers import GPT2Config

    class MyTrial(HFCausalLMTrial):
        def model_config(self):
            return GPT2Config(n_layer=4, n_embd=256, n_head=8)

        def training_data(self):
            yield from lm_batches(token_array, self.global_batch_size,
                                  seq_len=128)
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from determined_clone_tpu_torch.ops.layers import softmax_cross_entropy
from determined_clone_tpu_torch.training import optim
from determined_clone_tpu_torch.training.trial import TorchTrial


def lm_batches(tokens: np.ndarray, batch_size: int,
               seq_len: int) -> Iterator[np.ndarray]:
    """Chop a flat token array into (batch, seq_len+1) LM batches (the +1
    feeds the shifted-label loss). A ragged tail that cannot fill a whole
    batch is dropped, as in the JAX package."""
    window = seq_len + 1
    n = (len(tokens) - 1) // (batch_size * seq_len)
    for i in range(n):
        rows = []
        for b in range(batch_size):
            lo = (i * batch_size + b) * seq_len
            chunk = tokens[lo:lo + window]
            if len(chunk) < window:
                break
            rows.append(chunk)
        if len(rows) == batch_size:
            yield np.stack(rows).astype(np.int32)


class HFCausalLMTrial(TorchTrial):
    """Train (or fine-tune) an HF PyTorch causal-LM. Subclasses override
    ``model_config()``; hparams understood: learning_rate, weight_decay,
    warmup_steps, adam_beta1/2 (the JAX trial's names and defaults)."""

    # -- model construction -------------------------------------------------

    def model_config(self) -> Any:
        """Return a transformers PretrainedConfig."""
        raise NotImplementedError("override model_config()")

    def build_model(self, seed: int = 0) -> Any:
        """The module, initialised from ``model_config()`` with torch's
        generator seeded by ``seed`` (the global one is left as it was)."""
        from transformers import AutoModelForCausalLM

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = AutoModelForCausalLM.from_config(self.model_config())
        return model.to(self.context.device)

    @property
    def model(self) -> Any:
        """The module (built once). Its parameters are the ones
        ``initial_params`` hands the Trainer, not a second copy."""
        if not hasattr(self, "_model"):
            self._model = self.build_model()
        return self._model

    # -- TorchTrial surface -------------------------------------------------

    def initial_params(self, gen: torch.Generator) -> Any:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                 device=gen.device))
        self._model = self.build_model(seed)
        # the tensors themselves, detached: the Trainer's updates land in
        # the module's storage, so the weights are held once
        return {name: p.detach()
                for name, p in self._model.named_parameters()}

    def optimizer(self) -> optim.Optimizer:
        get = self.context.get_hparam
        lr = float(get("learning_rate", 5e-5))
        warmup = int(get("warmup_steps", 0))
        schedule: Any = lr
        if warmup > 0:
            schedule = optim.linear_schedule(0.0, lr, warmup)
        return optim.adamw(
            schedule,
            b1=float(get("adam_beta1", 0.9)),
            b2=float(get("adam_beta2", 0.999)),
            weight_decay=float(get("weight_decay", 0.01)),
        )

    def _lm_loss(self, params: Any, batch: Any, *, train: bool,
                 seed: Optional[int] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        batch = torch.as_tensor(batch, device=self.context.device).long()
        inputs, labels = batch[:, :-1], batch[:, 1:]
        model = self.model
        model.train(train)
        device = self.context.device
        with torch.random.fork_rng(
                devices=[device] if device.type == "cuda" else []):
            if train and seed is not None:
                # dropout draws from torch's generator: the step's seed
                torch.manual_seed(int(seed))
            logits = torch.func.functional_call(
                model, params, (inputs,)).logits
        loss = softmax_cross_entropy(logits, labels).mean()
        return loss, {"perplexity": torch.exp(loss.detach())}

    def loss(self, params: Any, batch: Any, seed: int
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross entropy over a (batch, seq+1) int array;
        dropout on (train mode), seeded by the step."""
        return self._lm_loss(params, batch, train=True, seed=seed)

    def eval_metrics(self, params: Any, batch: Any,
                     seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Validation in eval mode — dropout off."""
        loss, metrics = self._lm_loss(params, batch, train=False)
        return {"loss": loss.detach(), **metrics}

    def training_data(self) -> Iterable[Any]:
        raise NotImplementedError("provide training_data()")
