"""Model hub — ready-made trials for model families: the HF-transformers
causal-LM trial (``huggingface.py``, transformers imported when a model
is built) and the vision domain (ViT classification and an anchor-free
single-stage detector)."""
from determined_clone_tpu_torch.model_hub.huggingface import (
    HFCausalLMTrial,
    lm_batches,
)
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
    "HFCausalLMTrial",
    "SingleStageDetectionTrial",
    "ViTClassificationTrial",
    "detection_loss",
    "detector_apply",
    "detector_init",
    "lm_batches",
    "synthetic_detection_batches",
]
