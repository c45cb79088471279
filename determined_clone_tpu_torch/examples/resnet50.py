"""ResNet-50 image classification — the port of
``examples/resnet50/model_def.py`` (ResNetTrial, BASELINE config #3),
with the same hyperparameter names and defaults, the same optimizer
(``chain(clip_by_global_norm(1.0), adamw(lr))``) and the same synthetic
data, so both trials see the same batches.

The port trains on one card: a ``mesh`` hparam whose axes multiply to
more than 1 (``distributed.yaml``'s dp 4 × fsdp 2) raises, since sharded
training comes with the parallelism slice (``ROADMAP.md``).

Data: deterministic synthetic imagenet-shaped batches (class prototypes
plus noise — learnable, so a falling loss is a real signal).
"""
from __future__ import annotations

import math

import numpy as np

from determined_clone_tpu_torch.models import resnet
from determined_clone_tpu_torch.training import TorchTrial
from determined_clone_tpu_torch.training import optim


def _synthetic_images(n, image_size, n_classes, channels=3, seed=0):
    """Class-prototype images + gaussian noise, fixed across epochs."""
    rng = np.random.RandomState(1234)  # prototypes shared train/val
    protos = rng.randn(n_classes, image_size, image_size, channels).astype(
        np.float32)
    sample_rng = np.random.RandomState(seed)
    labels = sample_rng.randint(0, n_classes, size=n).astype(np.int32)
    x = protos[labels] + 0.8 * sample_rng.randn(
        n, image_size, image_size, channels).astype(np.float32)
    return x, labels


class ResNetTrial(TorchTrial):
    def __init__(self, context):
        super().__init__(context)
        get = context.get_hparam
        mesh = get("mesh") or {}
        if math.prod(int(v) for v in mesh.values()) > 1:
            raise NotImplementedError(
                f"mesh {mesh}: sharded training is not ported yet "
                f"(ROADMAP.md, Queue 1: parallelism); drop the mesh hparam "
                f"to train on one card")
        self.cfg = resnet.ResNetConfig(
            depth=int(get("depth", 50)),
            n_classes=int(get("n_classes", 1000)),
            width=int(get("width", 64)),
        )
        self.image_size = int(get("image_size", 224))
        self.n_train = int(get("n_train", 4096))

    def initial_params(self, gen):
        return resnet.init(gen, self.cfg, device=self.context.device)

    def optimizer(self):
        lr = float(self.context.get_hparam("lr", 1e-3))
        return optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(lr))

    def loss(self, params, batch, seed):
        x, y = batch
        return resnet.loss_fn(params, self.cfg, x, y), {}

    def training_data(self):
        bs = self.global_batch_size
        x, y = _synthetic_images(self.n_train, self.image_size,
                                 self.cfg.n_classes)
        i = 0
        while True:
            sel = np.arange(i, i + bs) % len(x)
            yield x[sel], y[sel]
            i += bs

    def validation_data(self):
        bs = self.global_batch_size
        x, y = _synthetic_images(max(bs, 256) // bs * bs, self.image_size,
                                 self.cfg.n_classes, seed=1)
        return [(x[i:i + bs], y[i:i + bs]) for i in range(0, len(x), bs)]
