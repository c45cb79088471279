"""Vision model hub — the port of ``determined_clone_tpu/model_hub/
vision.py``: ready-made classification and detection trials (the role of
the reference's mmdetection adapters). A ViT classifier
(``models/vit.py``) and a compact anchor-free single-stage detector —
per-cell objectness, class and box regression over a conv backbone, the
FCOS/YOLO family shape. Subclass, provide data, train.

    class MyDetection(SingleStageDetectionTrial):
        def training_data(self):
            yield {"image": ..., "boxes": ..., "labels": ..., "mask": ...}
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from determined_clone_tpu_torch.device import DeviceLike, resolve_device
from determined_clone_tpu_torch.models import vit
from determined_clone_tpu_torch.ops import layers
from determined_clone_tpu_torch.training import TorchTrial
from determined_clone_tpu_torch.training import optim

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

class ViTClassificationTrial(TorchTrial):
    """Image classification on a ViT backbone. Hyperparameters mirror
    ViTConfig fields (image_size, patch_size, d_model, ...); compute is
    bf16 unless ``full_precision``. Batches: {"image": [B,H,W,C],
    "label": [B]}."""

    def vit_config(self) -> vit.ViTConfig:
        hp = self.context.get_hparam
        return vit.ViTConfig(
            image_size=int(hp("image_size", 32)),
            patch_size=int(hp("patch_size", 8)),
            channels=int(hp("channels", 3)),
            n_classes=int(hp("n_classes", 10)),
            d_model=int(hp("d_model", 64)),
            n_layers=int(hp("n_layers", 2)),
            n_heads=int(hp("n_heads", 4)),
            d_ff=int(hp("d_ff", 128)),
            compute_dtype=torch.float32 if hp("full_precision", False)
            else torch.bfloat16,
            remat=bool(hp("remat", False)),
        )

    def initial_params(self, gen: torch.Generator) -> Params:
        self._cfg = self.vit_config()
        return vit.init(gen, self._cfg, device=self.context.device)

    def optimizer(self) -> optim.Optimizer:
        lr = float(self.context.get_hparam("lr", 1e-3))
        return optim.adamw(lr, weight_decay=float(
            self.context.get_hparam("weight_decay", 0.01)))

    def loss(self, params, batch, seed):
        logits = vit.apply(params, self._cfg, batch["image"])
        loss = layers.softmax_cross_entropy(logits, batch["label"]).mean()
        return loss, {"accuracy": layers.accuracy(logits, batch["label"])}

    def training_data(self) -> Iterable[Any]:
        raise NotImplementedError("subclass provides training_data()")


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    image_size: int = 64
    channels: int = 3
    n_classes: int = 4
    widths: Tuple[int, ...] = (16, 32, 64)  # conv stages, each /2
    compute_dtype: Any = torch.float32

    @property
    def grid(self) -> int:
        return self.image_size // (2 ** len(self.widths))


def detector_init(gen: torch.Generator, cfg: DetectorConfig,
                  device: DeviceLike = "cuda") -> Params:
    dev = resolve_device(device)
    backbone = []
    in_ch = cfg.channels
    for out_ch in cfg.widths:
        backbone.append(layers.conv_init(gen, in_ch, out_ch, 3, device=dev))
        in_ch = out_ch
    # per-cell head: 1 objectness + 4 box (cx, cy, w, h) + n_classes
    head = layers.conv_init(gen, in_ch, 5 + cfg.n_classes, 1, device=dev)
    return {"backbone": backbone, "head": head}


def detector_apply(params: Params, cfg: DetectorConfig,
                   images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[B,H,W,C] → per-cell predictions on the [grid, grid] map: obj
    logits [B,g,g], boxes [B,g,g,4] — sigmoid-squashed fractions of the
    whole image (cx, cy, w, h), regressed directly against the ground
    truth — and class logits [B,g,g,n_classes]. The kernels are cast to
    ``compute_dtype`` with the images (the JAX detector, whose convolution
    needs equal dtypes, runs in fp32 only)."""
    x = images.to(cfg.compute_dtype)
    for conv in params["backbone"]:
        x = torch.relu(layers.conv2d(conv, x, stride=2,
                                     compute_dtype=cfg.compute_dtype))
    out = layers.conv2d(params["head"], x, compute_dtype=cfg.compute_dtype)
    return {"objectness": out[..., 0],
            "boxes": torch.sigmoid(out[..., 1:5]),
            "class_logits": out[..., 5:]}


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                                 ) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``, elementwise."""
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def detection_loss(params: Params, cfg: DetectorConfig, images: torch.Tensor,
                   boxes: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Anchor-free cell assignment: each ground-truth box (cx, cy, w, h in
    image fractions; [B,M,4] with validity mask [B,M]) is matched to the
    cell holding its centre. Loss = BCE(objectness) + L1(box) + CE(class)
    on the matched cells."""
    g = cfg.grid
    preds = detector_apply(params, cfg, images)
    b, m = boxes.shape[0], boxes.shape[1]
    dev = boxes.device

    cell = torch.clamp((boxes[..., :2] * g).to(torch.int64), 0, g - 1)
    # objectness target grid: the max of the masks that land on a cell
    batch_idx = torch.arange(b, device=dev)[:, None].expand(b, m)
    flat = (batch_idx * g * g + cell[..., 1] * g + cell[..., 0]).reshape(-1)
    obj_target = torch.zeros(b * g * g, dtype=torch.float32, device=dev)
    obj_target = obj_target.scatter_reduce(
        0, flat, mask.reshape(-1).float(), reduce="amax")
    obj_target = obj_target.reshape(b, g, g)
    obj_loss = sigmoid_binary_cross_entropy(preds["objectness"],
                                            obj_target).mean()

    def gather_cells(t):
        """Predictions at the matched cells → [B, M, ...]."""
        return t.reshape(b, g * g, *t.shape[3:])[
            torch.arange(b, device=dev)[:, None],
            cell[..., 1] * g + cell[..., 0]]

    pred_box = gather_cells(preds["boxes"])
    pred_cls = gather_cells(preds["class_logits"])
    denom = mask.sum().clamp_min(1.0)
    box_loss = ((pred_box - boxes).abs().sum(-1) * mask).sum() / denom
    cls_loss = (layers.softmax_cross_entropy(pred_cls, labels)
                * mask).sum() / denom
    total = obj_loss + box_loss + cls_loss
    return total, {"obj_loss": obj_loss, "box_loss": box_loss,
                   "cls_loss": cls_loss}


class SingleStageDetectionTrial(TorchTrial):
    """Object detection with the compact anchor-free detector. Batches:
    {"image": [B,H,W,C], "boxes": [B,M,4], "labels": [B,M], "mask": [B,M]}.
    """

    def detector_config(self) -> DetectorConfig:
        hp = self.context.get_hparam
        widths = hp("widths", (16, 32, 64))
        return DetectorConfig(
            image_size=int(hp("image_size", 64)),
            channels=int(hp("channels", 3)),
            n_classes=int(hp("n_classes", 4)),
            widths=tuple(int(w) for w in widths),
        )

    def initial_params(self, gen: torch.Generator) -> Params:
        self._cfg = self.detector_config()
        return detector_init(gen, self._cfg, device=self.context.device)

    def optimizer(self) -> optim.Optimizer:
        return optim.adam(float(self.context.get_hparam("lr", 1e-3)))

    def loss(self, params, batch, seed):
        return detection_loss(params, self._cfg, batch["image"],
                              batch["boxes"], batch["labels"], batch["mask"])

    def training_data(self) -> Iterable[Any]:
        raise NotImplementedError("subclass provides training_data()")


def synthetic_detection_batches(cfg: DetectorConfig, *, batch_size: int,
                                n_batches: int, max_boxes: int = 3,
                                seed: int = 0
                                ) -> Iterable[Dict[str, np.ndarray]]:
    """Deterministic synthetic shapes-on-canvas data: coloured
    axis-aligned rectangles whose class is their colour — the JAX hub's
    generator, so both packages see the same batches."""
    rng = np.random.RandomState(seed)
    s = cfg.image_size
    for _ in range(n_batches):
        images = np.zeros((batch_size, s, s, cfg.channels), np.float32)
        boxes = np.zeros((batch_size, max_boxes, 4), np.float32)
        labels = np.zeros((batch_size, max_boxes), np.int32)
        mask = np.zeros((batch_size, max_boxes), np.float32)
        for b in range(batch_size):
            for m in range(rng.randint(1, max_boxes + 1)):
                w, h = rng.uniform(0.15, 0.4, 2)
                cx = rng.uniform(w / 2, 1 - w / 2)
                cy = rng.uniform(h / 2, 1 - h / 2)
                cls = rng.randint(cfg.n_classes)
                x0, x1 = int((cx - w / 2) * s), int((cx + w / 2) * s)
                y0, y1 = int((cy - h / 2) * s), int((cy + h / 2) * s)
                images[b, y0:y1, x0:x1, cls % cfg.channels] = 1.0
                boxes[b, m] = (cx, cy, w, h)
                labels[b, m] = cls
                mask[b, m] = 1.0
        yield {"image": images, "boxes": boxes, "labels": labels,
               "mask": mask}
