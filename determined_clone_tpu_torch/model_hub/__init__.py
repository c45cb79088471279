"""Model hub — ready-made trials for model families: the vision domain
(ViT classification and an anchor-free single-stage detector). The
HF-transformers trials of the JAX package's hub wait (``ROADMAP.md``)."""
from determined_clone_tpu_torch.model_hub.vision import (
    DetectorConfig,
    SingleStageDetectionTrial,
    ViTClassificationTrial,
    detection_loss,
    detector_apply,
    detector_init,
    synthetic_detection_batches,
)

__all__ = [
    "DetectorConfig",
    "SingleStageDetectionTrial",
    "ViTClassificationTrial",
    "detection_loss",
    "detector_apply",
    "detector_init",
    "synthetic_detection_batches",
]
