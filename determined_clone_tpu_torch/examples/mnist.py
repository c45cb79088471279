"""MNIST trial — the port of ``examples/mnist/model_def.py`` (MnistTrial,
BASELINE config #1), with the same hyperparameter names and defaults
(``const.yaml``: batch 64, lr 1e-3, filters 32/64, dropouts 0.25/0.5).

The optimizer is the JAX trial's ``adamw(lr)``, whose weight decay
defaults to 1e-4 as optax's does. Data: scikit-learn's handwritten-digit
scans by default (``dataset: digits``, read from the copy the port keeps,
``utils/data.py``), real MNIST IDX files with ``dataset: mnist`` and
``data_dir``.

On a mesh (``distributed.yaml``'s ``dp: 8``, BASELINE #2) the trial keeps
the default ``ShardingRules()`` and runs its model through
``parallel.spmd.replicated_program``: weights whole in the forward, the
batch split over ``dp`` × ``fsdp``, dropout masks drawn at the global
batch's shape, losses and metrics the global batch's.
"""
from __future__ import annotations

from determined_clone_tpu_torch.models import mnist_cnn
from determined_clone_tpu_torch.ops.layers import (
    accuracy,
    softmax_cross_entropy,
)
from determined_clone_tpu_torch.parallel.spmd import replicated_program
from determined_clone_tpu_torch.training import TorchTrial
from determined_clone_tpu_torch.training import optim
from determined_clone_tpu_torch.utils.data import (
    batch_iterator,
    digits_dataset,
    mnist_dataset,
)


class MnistTrial(TorchTrial):
    def __init__(self, context):
        super().__init__(context)
        get = context.get_hparam
        self.cfg = mnist_cnn.MnistCNNConfig(
            n_filters_1=int(get("n_filters_1", 32)),
            n_filters_2=int(get("n_filters_2", 64)),
            dropout_1=float(get("dropout_1", 0.25)),
            dropout_2=float(get("dropout_2", 0.5)),
        )
        if get("dataset", "digits") == "digits":
            self.train_set = digits_dataset("train", image=True)
            self.val_set = digits_dataset("test", image=True)
        else:
            data_dir = get("data_dir")
            self.train_set = mnist_dataset(data_dir, "train", image=True)
            self.val_set = mnist_dataset(data_dir, "test", image=True)

    def initial_params(self, gen):
        return mnist_cnn.init(gen, self.cfg, device=self.context.device)

    def optimizer(self):
        return optim.adamw(float(self.context.get_hparam("lr", 1e-3)))

    def loss(self, params, batch, seed):
        x, y = batch
        return replicated_program(
            lambda p, x, y, rows: mnist_cnn.loss_fn(
                p, self.cfg, x, y, training=True, dropout_seed=seed,
                rows=rows), params, x, y), {}

    def eval_metrics(self, params, batch):
        def metrics(p, x, y, rows):
            logits = mnist_cnn.apply(p, self.cfg, x)
            return {"loss": softmax_cross_entropy(logits, y).mean(),
                    "accuracy": accuracy(logits, y)}

        x, y = batch
        return replicated_program(metrics, params, x, y)

    def training_data(self):
        epoch = 0
        while True:  # searcher max_length bounds consumption
            yield from batch_iterator(*self.train_set, self.global_batch_size,
                                      seed=7, epoch=epoch)
            epoch += 1

    def validation_data(self):
        return batch_iterator(*self.val_set, self.global_batch_size,
                              shuffle=False, drop_remainder=True)
